// Kernel C: the whole ATRAC3 rate-control loop, one thread per channel-frame.
//
// Replaces the Pallas kernel atracdenc_tpu/ops/pallas_rate.py::
// rate_control_block (_kernel :184-238, _eval_alloc :56-157,
// _run_bisection :160-181).  Per channel-frame:
//   * an 11-step lambda bisection over [-8, 20] (+-0.01 shrink, keep the
//     last lambda under budget);
//   * each evaluation: the trunc allocation from csfi / spread / the fixed
//     table, the tonal-BFU discount, the ConsiderEnergyErr boost (<= 6
//     bumps), the CLC-vs-VLC spectrum cost, and the closed-form tonal
//     dry-run (atracdenc_tpu/models/atrac3/tonal.py::make_cost_fn);
//   * the BFU-shrink loop (CheckBfus -> Repeat) while the last used BFU
//     got no bits (auto mode only; auto=0 is --bfuidxconst).
// Every float op is elementwise, in the plain version's order (built with
// -fmad=false), and every sum is an integer sum, so the result is bit-equal
// to the plain version (models/atrac3/bitalloc.py).
//
// Bound: latency of a long, branchy per-frame computation (~12 evaluations
// of ~32 BFUs x (3 loads + a few compares) plus a <=21x21 tonal pair loop
// per shrink round); the memo inputs (~3 KiB per frame) are read from L2 /
// L1 many times.  Design: one thread per channel-frame (tens of thousands
// on the main path fill the card), inputs in the frame-minor layout
// ([32, N], [32, 8, N]) so that a warp's 32 frames read 32 consecutive
// words at every access; the per-frame wordlens and tonal planes stay in
// the thread's registers / local memory.
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

__global__ void rate_control_kernel(Inputs in, const int* __restrict__ num_bfu_in,
                                    const int* __restrict__ t_active,
                                    const int* __restrict__ t_pos,
                                    const int* __restrict__ t_len,
                                    const int* __restrict__ t_bfu,
                                    int* __restrict__ wl_out,
                                    int* __restrict__ num_bfu_out,
                                    unsigned char* __restrict__ mode_out,
                                    int auto_shrink) {
    const long long f = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long n = in.n;
    if (f >= n) return;

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
    const int target = in.target[f];

    int nb = num_bfu_in[f];
    int wl[kBfus];
    bool mode = false;
    while (true) {
        float min_l = -8.0f, max_l = 20.0f, last_l = 20.0f;
        for (int s = 0; s < kBisectSteps; ++s) {
            if (!(max_l > min_l)) continue;
            const float cur = (max_l + min_l) * 0.5f;
            bool m;
            const int bits = eval_alloc(in, tn, f, cur, nb, wl, &m);
            const bool under = bits < target, over = bits > target;
            if (!over) last_l = cur;
            if (under) max_l = cur - 0.01f;
            if (over) min_l = cur + 0.01f;
            if (!under && !over) max_l = min_l;
        }
        eval_alloc(in, tn, f, last_l, nb, wl, &mode);
        if (auto_shrink && nb > 1 && wl[nb - 1] == 0) {
            nb -= 1;
            continue;
        }
        break;
    }
    for (int k = 0; k < kBfus; ++k) wl_out[k * n + f] = wl[k];
    num_bfu_out[f] = nb;
    mode_out[f] = mode ? 1 : 0;
}

}  // namespace

// Frame-minor layout throughout: per-BFU planes [32, n], memo planes
// [32, 8, n], per-frame scalars [n].  fix / xdiv are the [32] f32 tables
// FIXED_BIT_ALLOC and SFI_DIVISOR.
extern "C" int atrac3_rate_control(
        const float* csfi, const unsigned char* gated, const int* tcounts,
        const float* spread, const int* target, const int* num_bfu,
        const float* err, const int* clc, const int* vlc,
        const int* t_active, const int* t_pos, const int* t_len,
        const int* t_bfu, const int* t_vlc, const float* fix,
        const float* xdiv, int* wl_out, int* num_bfu_out,
        unsigned char* mode_out, int n, int auto_shrink, void* stream) {
    if (n <= 0) return 0;
    Inputs in{csfi, gated, tcounts, spread, target, err, clc, vlc, t_vlc,
              fix, xdiv, static_cast<long long>(n)};
    const int threads = 128;
    rate_control_kernel<<<(n + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        in, num_bfu, t_active, t_pos, t_len, t_bfu, wl_out, num_bfu_out,
        mode_out, auto_shrink);
    return static_cast<int>(cudaGetLastError());
}
