// Device code shared by kernel C (rate_control.cu) and kernel F
// (bisect.cu): one ATRAC3 allocation evaluation at a lambda and the
// 11-step lambda bisection around it, for one channel-frame in one warp.
// Lane k owns BFU k and tonal slot k.  The inputs are read once a frame,
// in the encoder's frame-major layout ([n, 32], [n, 32, 8], [n]): the
// clc / vlc / tonal VLC planes into the warp's shared memory, lane k's err
// row into its energy-boost table (the boost's result from each starting
// wordlen); every evaluation reuses both.  Every float op is elementwise,
// in the plain version's order (built with -fmad=false), and every sum is
// an integer warp reduction, exact in any order, so both kernels are
// bit-equal to their plain versions (models/atrac3/bitalloc.py).  The
// bisection and the BFU shrink branch on reduced, warp-uniform values only.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int kBfus = 32;
constexpr int kWl = 8;
constexpr int kBisectSteps = 11;
constexpr int kBoostEnd = 10;                // BOOST_NAQ_END
constexpr int kWarps = 4;                    // channel-frames per block
constexpr int kRow = kWl + 1;                // padded memo row: lanes reading
                                             // their own rows hit distinct banks
constexpr unsigned kAll = 0xffffffffu;

struct Inputs {
    const float* csfi;                       // [n, 32]
    const unsigned char* gated;              // [n, 32] bool
    const int* tcounts;                      // [n, 32]
    const float* spread;                     // [n]
    const int* target;                       // [n]
    const int* num_bfu;                      // [n]
    const float* err;                        // [n, 32, 8]
    const int* clc;                          // [n, 32, 8], or one [32, 8] table
    const int* vlc;                          // [n, 32, 8]
    const int* t_active;                     // [n, 32]
    const int* t_pos;                        // [n, 32]
    const int* t_len;                        // [n, 32]
    const int* t_bfu;                        // [n, 32]
    const int* t_vlc;                        // [n, 32, 8]
    const float* fix;                        // [32]
    const float* xdiv;                       // [32]
    long long n;
    int clc_stride;                          // elements between frames of clc: 256 or 0
};

struct Memo {                                // one frame's memo planes, [32][kRow]
    int clc[kBfus * kRow];
    int vlc[kBfus * kRow];
    int t_vlc[kBfus * kRow];
};

struct Lane {                                // lane k's share of one frame
    float alloc;                             // spread*(csfi/xdiv) + (1-spread)*fix
    bool gated;
    int tcount;
    unsigned boost;                          // 4 bits a wordlen w: w after the boost
    bool any_tonal;                          // a tonal slot of the frame is active
    bool t_active;
    int t_len, t_bfu;
    unsigned grp_peers;                      // lanes whose tonal block shares its
    unsigned win_peers;                      // 64-line group / its QMF window
};

// One frame's [32, 8] plane (16-byte aligned) into its padded rows.
__device__ __forceinline__ void stage_plane(const void* src, int* dst, int k) {
    const int4* s4 = static_cast<const int4*>(src);
#pragma unroll
    for (int j = 0; j < kBfus * kWl / 4 / 32; ++j) {
        const int i = k + 32 * j;            // 16-byte piece i: row i / 2
        const int4 v = s4[i];
        int* d = dst + (i / 2) * kRow + (i % 2) * 4;
        d[0] = v.x;
        d[1] = v.y;
        d[2] = v.z;
        d[3] = v.w;
    }
}

// Lane k's inputs of frame f; the memo planes into m.
__device__ __forceinline__ Lane load_frame(const Inputs& in, long long f, int k,
                                          Memo& m) {
    const long long i = f * kBfus + k;
    const float spread = in.spread[f];
    Lane ln;
    ln.alloc = spread * (in.csfi[i] / in.xdiv[k]) + (1.0f - spread) * in.fix[k];
    ln.gated = in.gated[i] != 0;
    ln.tcount = in.tcounts[i];
    // ConsiderEnergyErr: from wordlen w, bump while err[w] is in (0, 0.7)
    // or above 1.2 and w < 7 (at most 6 bumps: 1 -> 7); w = 0 stays
    const float4* e4 = reinterpret_cast<const float4*>(in.err + i * kWl);
    const float4 lo = e4[0], hi = e4[1];
    const float err[kWl] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    int to = kWl - 1;
    ln.boost = static_cast<unsigned>(to) << (4 * (kWl - 1));
#pragma unroll
    for (int w = kWl - 2; w >= 0; --w) {
        const float e = w > 0 ? err[w] : 0.0f;
        if (!(((e > 0.0f) && (e < 0.7f)) || (e > 1.2f))) to = w;
        ln.boost |= static_cast<unsigned>(to) << (4 * w);
    }
    ln.t_active = in.t_active[i] > 0;
    ln.any_tonal = __any_sync(kAll, ln.t_active);
    ln.t_len = in.t_len[i];
    ln.t_bfu = in.t_bfu[i];
    const int pos = in.t_pos[i];
    ln.grp_peers = __match_any_sync(kAll, pos >> 6);
    ln.win_peers = __match_any_sync(kAll, pos >> 8);
    const long long plane = f * kBfus * kWl;
    stage_plane(in.clc + f * in.clc_stride, m.clc, k);
    stage_plane(in.vlc + plane, m.vlc, k);
    stage_plane(in.t_vlc + plane, m.t_vlc, k);
    __syncwarp();
    return ln;
}

// One allocation at lambda `shift` with num_bfu BFUs: lane k's wordlen in
// *w and the coding mode (1 = CLC) in *mode; returns the total bits, the
// same in every lane.
__device__ __forceinline__ int eval_alloc(const Lane& ln, const Memo& m, int k,
                                          float shift, int num_bfu, int* w_out,
                                          bool* mode) {
    const bool in_use = k < num_bfu;
    const float tmp = truncf(ln.alloc - shift);
    int w = tmp > 7.0f ? 7 : (tmp < 0.0f ? 0 : (tmp == 0.0f ? 1 : static_cast<int>(tmp)));
    if (ln.gated || !in_use) w = 0;
    for (int i = 0; i < 3; ++i)
        if (in_use && ln.tcount > i && w > 2) w -= 1;
    if (k < num_bfu && k < kBoostEnd) w = (ln.boost >> (4 * w)) & 7u;
    const bool counted = in_use && w > 0;
    const int clc_sum = __reduce_add_sync(kAll, counted ? m.clc[k * kRow + w] : 0);
    const int vlc_sum = __reduce_add_sync(kAll, counted ? m.vlc[k * kRow + w] : 0);
    const int used = __popc(__ballot_sync(kAll, counted));
    *mode = clc_sum <= vlc_sum;
    *w_out = w;
    int bits = 3 * num_bfu + 6 * used + (*mode ? clc_sum : vlc_sum) + 5;
    if (!ln.any_tonal) return bits;

    // tonal dry-run, closed form (tonal.make_cost_fn), lane k = slot k
    const int wl_b = __shfl_sync(kAll, w, ln.t_bfu);
    const bool act = ln.t_active && ln.t_bfu < num_bfu;
    int q = 0;
    if (act) {
        q = wl_b + 4;
        q = q < 2 ? 2 : (q > 7 ? 7 : q);
    }
    const int base = __reduce_add_sync(kAll, act ? 12 + m.t_vlc[k * kRow + q] : 0);
    // the active slots j < k of the same length and quantiser; an inactive
    // slot's key (q field 0x100 + k) matches no other slot
    const unsigned long long key = act
        ? (static_cast<unsigned long long>(static_cast<unsigned>(ln.t_len)) << 32)
              | static_cast<unsigned>(q)
        : 0x100ull + k;
    const unsigned same = __match_any_sync(kAll, key) & ((1u << k) - 1u);
    const int cnt = 1 + __popc(same & ln.grp_peers);
    const bool new_sub = same == 0 || (cnt > 1 && (cnt - 1) % 7 == 0);
    const bool new_win = new_sub || (same & ln.win_peers) == 0;
    const int nsub = __popc(__ballot_sync(kAll, act && new_sub));
    const int nwin = __popc(__ballot_sync(kAll, act && new_win));
    return bits + (nsub > 0 ? 2 + 10 * nsub + 12 * nwin + base : 0);
}

// The lambda bisection over [-8, 20] at num_bfu (bs_encode/encode.cpp:
// 57-98): +-0.01 shrink, keep the last lambda at or under the budget, an
// exact hit collapses the interval.  The allocation at that lambda, lane
// k's wordlen in *w and the mode in *mode, is the one its evaluation gave
// (an evaluation at 20 when none came in at or under the budget).
__device__ __forceinline__ void bisect_alloc(const Lane& ln, const Memo& m, int k,
                                             int num_bfu, int target, int* w,
                                             bool* mode) {
    float min_l = -8.0f, max_l = 20.0f;
    bool found = false;
    for (int s = 0; s < kBisectSteps && max_l > min_l; ++s) {
        const float cur = (max_l + min_l) * 0.5f;
        int w_cur;
        bool mode_cur;
        const int bits = eval_alloc(ln, m, k, cur, num_bfu, &w_cur, &mode_cur);
        const bool under = bits < target, over = bits > target;
        if (!over) {
            found = true;
            *w = w_cur;
            *mode = mode_cur;
        }
        if (under) max_l = cur - 0.01f;
        if (over) min_l = cur + 0.01f;
        if (!under && !over) max_l = min_l;
    }
    if (!found) eval_alloc(ln, m, k, 20.0f, num_bfu, w, mode);
}

// The warp's channel-frame (warp w of block b: frame b * kWarps + w), or
// -1 past the end.  Launch with kWarps * 32 threads a block.
__device__ __forceinline__ long long warp_frame(long long n) {
    const long long f = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
    return f < n ? f : -1;
}

inline unsigned frame_blocks(long long n) {
    return static_cast<unsigned>((n + kWarps - 1) / kWarps);
}

}  // namespace
