// Device code shared by kernel C (rate_control.cu) and kernel F
// (bisect.cu): one ATRAC3 allocation evaluation at a lambda and the
// 11-step lambda bisection around it, for one channel-frame in one thread.
// Inputs are frame-minor ([32, n], [32, 8, n], [n]).  Every float op is
// elementwise, in the plain version's order (built with -fmad=false), and
// every sum is an integer sum, so both kernels are bit-equal to their
// plain versions (models/atrac3/bitalloc.py).
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kBfus = 32;
constexpr int kWl = 8;
constexpr int kBisectSteps = 11;
constexpr int kBoostEnd = 10;                // BOOST_NAQ_END

struct Inputs {
    const float* csfi;                       // [32, n]
    const unsigned char* gated;              // [32, n]
    const int* tcounts;                      // [32, n]
    const float* spread;                     // [n]
    const int* target;                       // [n]
    const float* err;                        // [32, 8, n]
    const int* clc;                          // [32, 8, n]
    const int* vlc;                          // [32, 8, n]
    const int* t_vlc;                        // [32, 8, n]
    const float* fix;                        // [32]
    const float* xdiv;                       // [32]
    long long n;
};

struct Tonal {                               // one frame's tonal blocks
    int count;                               // slots 0..count-1 may be active
    bool active[kBfus];
    int len[kBfus], grp[kBfus], win[kBfus], bfu[kBfus];
};

// One allocation at lambda `shift`: fills wl, returns the total bits.
__device__ int eval_alloc(const Inputs& in, const Tonal& tn, long long f,
                          float shift, int num_bfu, int wl[kBfus], bool* mode) {
    const long long n = in.n;
    const float spread = in.spread[f];
    const int boost_lim = num_bfu < kBoostEnd ? num_bfu : kBoostEnd;
    int clc_sum = 0, vlc_sum = 0, used = 0;
    for (int k = 0; k < kBfus; ++k) {
        const bool in_use = k < num_bfu;
        const float tmp = truncf(spread * (in.csfi[k * n + f] / in.xdiv[k])
                                 + (1.0f - spread) * in.fix[k] - shift);
        int w = tmp > 7.0f ? 7 : (tmp < 0.0f ? 0 : (tmp == 0.0f ? 1 : static_cast<int>(tmp)));
        if (in.gated[k * n + f] || !in_use) w = 0;
        const int tc = in.tcounts[k * n + f];
        for (int i = 0; i < 3; ++i)
            if (in_use && tc > i && w > 2) w -= 1;
        if (k < boost_lim) {
            for (int i = 0; i < 6; ++i) {
                const float e = w > 0 ? in.err[(k * kWl + w) * n + f] : 0.0f;
                if (!((((e > 0.0f) && (e < 0.7f)) || (e > 1.2f)) && w < 7)) break;
                w += 1;
            }
        }
        wl[k] = w;
        if (in_use && w > 0) {
            clc_sum += in.clc[(k * kWl + w) * n + f];
            vlc_sum += in.vlc[(k * kWl + w) * n + f];
            used += 1;
        }
    }
    *mode = clc_sum <= vlc_sum;
    int bits = 3 * num_bfu + 6 * used + (*mode ? clc_sum : vlc_sum);

    // tonal dry-run, closed form (tonal.make_cost_fn)
    int quant[kBfus];
    bool act[kBfus];
    int base = 0;
    for (int b = 0; b < tn.count; ++b) {
        act[b] = tn.active[b] && tn.bfu[b] < num_bfu;
        int q = 0;
        if (act[b]) {
            q = wl[tn.bfu[b]] + 4;
            q = q < 2 ? 2 : (q > 7 ? 7 : q);
            base += 12 + in.t_vlc[(b * kWl + q) * n + f];
        }
        quant[b] = q;
    }
    int nsub = 0, nwin = 0;
    for (int i = 0; i < tn.count; ++i) {
        if (!act[i]) continue;
        bool any_sb = false, any_sw = false;
        int cnt = 1;
        for (int j = 0; j < i; ++j) {
            if (!act[j] || tn.len[j] != tn.len[i] || quant[j] != quant[i]) continue;
            any_sb = true;
            cnt += tn.grp[j] == tn.grp[i];
            any_sw = any_sw || tn.win[j] == tn.win[i];
        }
        const bool new_sub = !any_sb || (cnt > 1 && (cnt - 1) % 7 == 0);
        nsub += new_sub;
        nwin += new_sub || !any_sw;
    }
    bits += 5 + (nsub > 0 ? 2 + 10 * nsub + 12 * nwin + base : 0);
    return bits;
}

// The frame's tonal blocks from the planes t_* [32, n].
__device__ Tonal load_tonal(const int* __restrict__ t_active,
                            const int* __restrict__ t_pos,
                            const int* __restrict__ t_len,
                            const int* __restrict__ t_bfu, long long f,
                            long long n) {
    Tonal tn;
    tn.count = 0;
    for (int b = 0; b < kBfus; ++b) {
        const long long i = b * n + f;
        tn.active[b] = t_active[i] > 0;
        tn.len[b] = t_len[i];
        tn.grp[b] = t_pos[i] >> 6;           // 64-line anchor group
        tn.win[b] = t_pos[i] >> 8;           // QMF window index
        tn.bfu[b] = t_bfu[i];
        if (tn.active[b]) tn.count = b + 1;
    }
    return tn;
}

// The lambda bisection over [-8, 20] at num_bfu (bs_encode/encode.cpp:
// 57-98): +-0.01 shrink, keep the last lambda at or under the budget, an
// exact hit collapses the interval.  Returns that lambda; wl is scratch.
__device__ float bisect_lambda(const Inputs& in, const Tonal& tn, long long f,
                               int num_bfu, int target, int wl[kBfus]) {
    float min_l = -8.0f, max_l = 20.0f, last_l = 20.0f;
    for (int s = 0; s < kBisectSteps; ++s) {
        if (!(max_l > min_l)) continue;
        const float cur = (max_l + min_l) * 0.5f;
        bool m;
        const int bits = eval_alloc(in, tn, f, cur, num_bfu, wl, &m);
        const bool under = bits < target, over = bits > target;
        if (!over) last_l = cur;
        if (under) max_l = cur - 0.01f;
        if (over) min_l = cur + 0.01f;
        if (!under && !over) max_l = min_l;
    }
    return last_l;
}

}  // namespace
