// Kernel E: the whole ATRAC1 rate control, one thread per channel-frame.
//
// Replaces the Pallas kernel atracdenc_tpu/ops/pallas_alloc.py::
// at1_allocate_block (_at1_kernel :215-359, _at1_eval :188-204,
// _run_bisection :162-185).  Per channel-frame:
//   * an 11-step lambda bisection over [-3, 15] (+-0.01 shrink, keep the
//     last lambda at or under budget, collapse the interval on an exact hit);
//   * in auto mode (bfu_idx_const == 0, start index 7), up to 7 BFU-shrink
//     rounds, each a full re-bisection at amount[idx - 1], while the last
//     BFU that got bits lies below the current amount;
//   * the leftover-bit booster walk over the boost entries in their sorted
//     order.  The XLA loop `while any(changed & surplus >= min_key)` is
//     global over the batch; the per-row loop `while (changed && surplus >=
//     min_key)` gives the same result, because a pass that changes nothing
//     leaves its row as it was: a fixed point.
// The allocation is trunc(((0.4f*(sfi/3.2f) + 0.6f*fix) - shift) + bias),
// the XLA path's order, and the library is built with -fmad=false, so the
// result is bit-equal to the plain version (models/atrac1/bitalloc.py).
//
// Bound: the latency of a long, branchy per-row loop (up to 8 rounds x 12
// evaluations x 52 BFUs, then the booster); a row's inputs (~420 bytes)
// are read about once.  Design: one thread per channel-frame; inputs
// frame-minor ([52, n]) so a warp's 32 rows read 32 consecutive words;
// each row's blend, wordlens and gate mask live in registers / local
// memory; the tables come in as device tensors and are copied once per
// block into shared memory, where every thread reads the same word.  The
// bench shape (8,192 rows) is 64 blocks of 128 threads, under one wave of
// the H100's 132 SMs: a warp-per-row design is later work.
#include <cuda_runtime.h>

namespace {

constexpr int kBfus = 52;
constexpr int kAmounts = 8;
constexpr int kMaxBoost = 64;
constexpr int kBisectSteps = 11;
constexpr int kShrinkRounds = 8;
constexpr int kThreads = 128;

struct Tables {
    float ath[kBfus], fix_long[kBfus], fix_short[kBfus];
    int band[kBfus], specs[kBfus], amount[kAmounts];
    int boost_bits[kMaxBoost], boost_pos[kMaxBoost];
    int n_boost;
};

// AvailableBits: 212 bytes minus the BFU amount index (3), the block modes
// and trailing zeros (32), the reserved bits (2 + 3) and 4 + 6 bits of
// wordlen and scale factor per BFU (atracdenc_tpu/models/atrac1/tables.py)
__device__ __forceinline__ int avail_bits(int bfu_num) {
    return 212 * 8 - 3 - 32 - 2 - 3 - bfu_num * (4 + 6);
}

// Mid-band bias of one round, from the low -> mid scale-factor tilt
// (atrac1_bitalloc.cpp:147-161); band 2 takes half of it.
__device__ float mid_bias(const Tables& t, const int* __restrict__ sfi,
                          long long n, long long f, int bfu_num) {
    int n_low = 0, n_mid = 0, sum_low = 0, sum_mid = 0;
    for (int k = 0; k < bfu_num; ++k) {
        const int s = sfi[k * n + f];
        if (t.band[k] == 0) { ++n_low; sum_low += s; }
        else if (t.band[k] == 1) { ++n_mid; sum_mid += s; }
    }
    float tilt = 0.0f;
    if (n_low > 0 && n_mid > 0)
        tilt = static_cast<float>(sum_low) / static_cast<float>(n_low)
             - static_cast<float>(sum_mid) / static_cast<float>(n_mid);
    return fminf(1.5f, 0.3f * fmaxf(0.0f, tilt - 7.0f));
}

// One allocation at lambda `shift`: fills wl, returns the mantissa bits.
// `dead` marks the gated BFUs and those at or past bfu_num.
__device__ int eval_alloc(const Tables& t, const float* base,
                          unsigned long long dead, float shift, float mbias,
                          int* wl) {
    int bits = 0;
    for (int k = 0; k < kBfus; ++k) {
        int w = 0;
        if (!((dead >> k) & 1ull)) {
            const float bias = t.band[k] == 0 ? 0.0f
                             : (t.band[k] == 1 ? mbias : mbias * 0.5f);
            const float tmp = truncf((base[k] - shift) + bias);
            w = tmp > 16.0f ? 16 : (tmp < 2.0f ? 0 : static_cast<int>(tmp));
        }
        wl[k] = w;
        bits += t.specs[k] * w;
    }
    return bits;
}

// One round: the 11-step lambda bisection at bfu_num, then the wordlens at
// the chosen lambda (bs_encode/encode.cpp:57-98).
__device__ void bisect(const Tables& t, const float* base,
                       unsigned long long gated, const int* __restrict__ sfi,
                       long long n, long long f, int bfu_num, int* wl) {
    const float mb = mid_bias(t, sfi, n, f, bfu_num);
    const unsigned long long dead = gated | (~0ull << bfu_num);
    const int target = avail_bits(bfu_num);
    float min_l = -3.0f, max_l = 15.0f, last_l = 15.0f;
    for (int s = 0; s < kBisectSteps; ++s) {
        if (!(max_l > min_l)) continue;
        const float cur = (max_l + min_l) * 0.5f;
        const int bits = eval_alloc(t, base, dead, cur, mb, wl);
        const bool under = bits < target, over = bits > target;
        if (!over) last_l = cur;
        if (under) max_l = cur - 0.01f;
        if (over) min_l = cur + 0.01f;
        if (!under && !over) max_l = min_l;
    }
    eval_alloc(t, base, dead, last_l, mb, wl);
}

__global__ void at1_allocate_kernel(
        const int* __restrict__ sfi, const float* __restrict__ energy,
        const unsigned char* __restrict__ short_flags,
        const float* __restrict__ loud, const float* __restrict__ ath,
        const float* __restrict__ fix_long, const float* __restrict__ fix_short,
        const int* __restrict__ band, const int* __restrict__ specs,
        const int* __restrict__ amount, const int* __restrict__ boost_bits,
        const int* __restrict__ boost_pos, int n_boost,
        int* __restrict__ wl_out, int* __restrict__ idx_out, long long n,
        int bfu_idx_const) {
    __shared__ Tables t;
    for (int i = threadIdx.x; i < kBfus; i += blockDim.x) {
        t.ath[i] = ath[i];
        t.fix_long[i] = fix_long[i];
        t.fix_short[i] = fix_short[i];
        t.band[i] = band[i];
        t.specs[i] = specs[i];
    }
    for (int i = threadIdx.x; i < kAmounts; i += blockDim.x) t.amount[i] = amount[i];
    for (int i = threadIdx.x; i < n_boost; i += blockDim.x) {
        t.boost_bits[i] = boost_bits[i];
        t.boost_pos[i] = boost_pos[i];
    }
    if (threadIdx.x == 0) t.n_boost = n_boost;
    __syncthreads();

    const long long f = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (f >= n) return;

    // the lambda- and round-free parts: the spread blend of scale factor and
    // fixed table, and the ATH gate energy < ath * loudness (long windows)
    bool is_short[3];
    for (int b = 0; b < 3; ++b) is_short[b] = short_flags[b * n + f] != 0;
    const float ld = loud[f];
    float base[kBfus];
    unsigned long long gated = 0;
    for (int k = 0; k < kBfus; ++k) {
        const bool s = is_short[t.band[k]];
        const float fix = s ? t.fix_short[k] : t.fix_long[k];
        base[k] = 0.4f * (static_cast<float>(sfi[k * n + f]) / 3.2f) + 0.6f * fix;
        if (!s && energy[k * n + f] < t.ath[k] * ld) gated |= 1ull << k;
    }

    int idx = bfu_idx_const == 0 ? 7 : bfu_idx_const - 1;
    int wl[kBfus];
    bisect(t, base, gated, sfi, n, f, t.amount[idx], wl);
    if (bfu_idx_const == 0) {
        for (int r = 0; r < kShrinkRounds - 1; ++r) {
            const int bfu_num = t.amount[idx];
            int last_nz = -1;
            for (int k = 0; k < bfu_num; ++k)
                if (wl[k] > 0) last_nz = k;
            int used_idx = 0;                    // lower_bound in amount[]
            for (int j = 0; j < kAmounts; ++j) used_idx += t.amount[j] < last_nz + 1;
            if (used_idx >= idx) break;          // no repeat: a fixed point
            idx -= 1;
            bisect(t, base, gated, sfi, n, f, t.amount[idx], wl);
        }
    }

    // leftover-bit booster (atrac1_bitalloc.cpp:80-114)
    const int bfu_num = t.amount[idx];
    int used = 0;
    for (int k = 0; k < bfu_num; ++k) used += t.specs[k] * wl[k];
    int surplus = avail_bits(bfu_num) - used;
    const int min_key = t.boost_bits[0];
    const int max_key = t.boost_bits[t.n_boost - 1];
    const int key = surplus < max_key ? surplus : max_key;
    const bool enabled = surplus >= min_key;
    bool changed = true;
    for (bool first = true; first || (changed && surplus >= min_key); first = false) {
        changed = false;
        for (int e = 0; e < t.n_boost; ++e) {
            const int bits = t.boost_bits[e], pos = t.boost_pos[e];
            const int w = wl[pos];
            const int nbps = w > 0 ? 1 : 2;
            if (enabled && surplus >= min_key && bits <= key && pos < bfu_num
                    && w != 16 && !(w == 0 && bits * 2 > surplus)
                    && bits * nbps <= surplus) {
                wl[pos] = w + nbps;
                surplus -= nbps * bits;
                changed = true;
            }
        }
    }

    for (int k = 0; k < kBfus; ++k) wl_out[k * n + f] = wl[k];
    idx_out[f] = idx;
}

}  // namespace

// Frame-minor layout: sfi / energy / wl_out [52, n], short_flags [3, n],
// loud / idx_out [n].  The tables are [52] (ath, fix_long, fix_short, band,
// specs), [8] (amount) and [n_boost] (boost_bits, boost_pos, sorted by
// bits then position).  bfu_idx_const: 0 = auto, 1..8 = fixed index + 1.
extern "C" int atrac1_allocate(
        const int* sfi, const float* energy, const unsigned char* short_flags,
        const float* loud, const float* ath, const float* fix_long,
        const float* fix_short, const int* band, const int* specs,
        const int* amount, const int* boost_bits, const int* boost_pos,
        int n_boost, int* wl_out, int* idx_out, int n, int bfu_idx_const,
        void* stream) {
    if (n <= 0) return 0;
    if (n_boost <= 0 || n_boost > kMaxBoost || bfu_idx_const < 0 || bfu_idx_const > 8)
        return static_cast<int>(cudaErrorInvalidValue);
    at1_allocate_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        sfi, energy, short_flags, loud, ath, fix_long, fix_short, band, specs,
        amount, boost_bits, boost_pos, n_boost, wl_out, idx_out,
        static_cast<long long>(n), bfu_idx_const);
    return static_cast<int>(cudaGetLastError());
}
