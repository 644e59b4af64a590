// Kernel E: the whole ATRAC1 rate control, one warp per channel-frame.
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
// the XLA path's order, and the library is built with -fmad=false; every
// sum (the mantissa bits, the counts and scale-factor sums of the mid-band
// tilt) is an integer sum, so its order does not matter and the result is
// bit-equal to the plain version (models/atrac1/bitalloc.py).
//
// Bound: the dependent chain of a row, about 32 evaluations (2.7
// bisections of 12 on the bench corpus) and the booster walk, each
// evaluation now one warp reduction deep, not 52 iterations deep; a row's
// inputs (~420 bytes) are read once.  On an H100 one row alone takes
// ~6 us, launch included, and the bench shape's 8,192 rows ~19 us: the
// chain, then issuing ~8,192 x 32 evaluations (python -m
// atracdenc_tpu_torch.profile_kernels; neither the block size nor a cap of
// 32 registers a thread moved it).
// Design: a warp per channel-frame, lane l on BFUs l and l + 32, so an
// evaluation is a few instructions a lane (the trunc and both clamps are
// one truncating conversion and integer compares; a dead BFU weighs 0 in
// the sum) and one __reduce_add_sync; the bisection state is the same in
// every lane.  "The last BFU that got bits" is two ballots and a count of
// leading zeros; amount[8] sits in lanes 0-7 and is read by shuffle.  The
// booster holds boost entry e in lane e (its wordlen, bits and the
// pass-free part of its test, packed in one word), and the walk,
// sequential in surplus, takes entry e by one shuffle that does not wait
// on the walk.  Rows are read in the caller's row-major layout ([n, 52],
// short_flags [n, 3] bytes or one broadcast row, loudness contiguous or
// broadcast over channels) and wl is written [n, 52]: no register array is
// indexed at run time, so no local memory.
#include <cuda_runtime.h>

namespace {

constexpr int kBfus = 52;
constexpr int kAmounts = 8;
constexpr int kMaxBoost = 32;          // one boost entry a lane
constexpr int kBisectSteps = 11;
constexpr int kShrinkRounds = 8;
constexpr int kWarps = 4;              // channel-frames a block
constexpr unsigned kAll = 0xffffffffu;

// AvailableBits: 212 bytes minus the BFU amount index (3), the block modes
// and trailing zeros (32), the reserved bits (2 + 3) and 4 + 6 bits of
// wordlen and scale factor per BFU (atracdenc_tpu/models/atrac1/tables.py)
__device__ __forceinline__ int avail_bits(int bfu_num) {
    return 212 * 8 - 3 - 32 - 2 - 3 - bfu_num * (4 + 6);
}

// One BFU of the lane: the lambda-free parts of its allocation.
struct Bfu {
    int k, sfi, band, specs;
    float base;              // 0.4f * (sfi / 3.2f) + 0.6f * fix
    bool gated;              // past the table, or energy < ath * loudness
};

__device__ __forceinline__ Bfu load_bfu(
        int k, long long row, const int* __restrict__ sfi,
        const float* __restrict__ energy, const unsigned char* __restrict__ flags,
        long long flags_stride, float ld, const float* __restrict__ ath,
        const float* __restrict__ fix_long, const float* __restrict__ fix_short,
        const int* __restrict__ band, const int* __restrict__ specs) {
    Bfu b{k, 0, 0, 0, 0.0f, true};
    if (k >= kBfus) return b;
    b.band = band[k];
    b.specs = specs[k];
    b.sfi = sfi[row * kBfus + k];
    const bool s = flags[row * flags_stride + b.band] != 0;
    const float fix = s ? fix_short[k] : fix_long[k];
    b.base = 0.4f * (static_cast<float>(b.sfi) / 3.2f) + 0.6f * fix;
    b.gated = !s && energy[row * kBfus + k] < ath[k] * ld;
    return b;
}

// Gated, or at or past bfu_num: the BFU gets no bits this round.
__device__ __forceinline__ bool dead(const Bfu& b, int bfu_num) {
    return b.gated || b.k >= bfu_num;
}

// The BFU's wordlen at lambda `shift` when alive: trunc(x) > 16 -> 16,
// trunc(x) < 2 -> 0, else trunc(x).  One truncating conversion gives
// trunc(x) as an int (it saturates past the int range, where the clamp
// gives the same answer), so the tests are integer compares.
__device__ __forceinline__ int wordlen(const Bfu& b, float shift, float bias) {
    const int w = __float2int_rz((b.base - shift) + bias);
    return w < 2 ? 0 : min(w, 16);
}

__device__ __forceinline__ float band_bias(const Bfu& b, float mbias) {
    return b.band == 0 ? 0.0f : (b.band == 1 ? mbias : mbias * 0.5f);
}

// Mid-band bias of one round, from the low -> mid scale-factor tilt
// (atrac1_bitalloc.cpp:147-161); band 2 takes half of it.
__device__ __forceinline__ float mid_bias(const Bfu& b0, const Bfu& b1,
                                          int bfu_num) {
    const bool lo0 = b0.k < bfu_num && b0.band == 0;
    const bool lo1 = b1.k < bfu_num && b1.band == 0;
    const bool mid0 = b0.k < bfu_num && b0.band == 1;
    const bool mid1 = b1.k < bfu_num && b1.band == 1;
    const int n_low = __reduce_add_sync(kAll, lo0 + lo1);
    const int n_mid = __reduce_add_sync(kAll, mid0 + mid1);
    const int sum_low = __reduce_add_sync(kAll, (lo0 ? b0.sfi : 0) + (lo1 ? b1.sfi : 0));
    const int sum_mid = __reduce_add_sync(kAll, (mid0 ? b0.sfi : 0) + (mid1 ? b1.sfi : 0));
    float tilt = 0.0f;
    if (n_low > 0 && n_mid > 0)
        tilt = static_cast<float>(sum_low) / static_cast<float>(n_low)
             - static_cast<float>(sum_mid) / static_cast<float>(n_mid);
    return fminf(1.5f, 0.3f * fmaxf(0.0f, tilt - 7.0f));
}

// One round: the 11-step lambda bisection at bfu_num, then the wordlens at
// the chosen lambda (bs_encode/encode.cpp:57-98).  Returns the mantissa
// bits of the row at that lambda; w0 / w1 get the lane's wordlens.
__device__ __forceinline__ int bisect(const Bfu& b0, const Bfu& b1,
                                      int bfu_num, int* w0, int* w1) {
    const float mb = mid_bias(b0, b1, bfu_num);
    const float bias0 = band_bias(b0, mb), bias1 = band_bias(b1, mb);
    const int target = avail_bits(bfu_num);
    // a dead BFU's bits count as 0: its lines are left out of the sum
    const int specs0 = dead(b0, bfu_num) ? 0 : b0.specs;
    const int specs1 = dead(b1, bfu_num) ? 0 : b1.specs;
    float min_l = -3.0f, max_l = 15.0f, last_l = 15.0f;
    // an interval that closed stays closed: the later steps change nothing
    for (int s = 0; s < kBisectSteps && max_l > min_l; ++s) {
        const float cur = (max_l + min_l) * 0.5f;
        const int bits = __reduce_add_sync(
            kAll, specs0 * wordlen(b0, cur, bias0)
                + specs1 * wordlen(b1, cur, bias1));
        const bool under = bits < target, over = bits > target;
        if (!over) last_l = cur;
        if (under) max_l = cur - 0.01f;
        if (over) min_l = cur + 0.01f;
        if (!under && !over) max_l = min_l;
    }
    *w0 = dead(b0, bfu_num) ? 0 : wordlen(b0, last_l, bias0);
    *w1 = dead(b1, bfu_num) ? 0 : wordlen(b1, last_l, bias1);
    return __reduce_add_sync(kAll, specs0 * *w0 + specs1 * *w1);
}

__global__ void __launch_bounds__(kWarps * 32) at1_allocate_kernel(
        const int* __restrict__ sfi, const float* __restrict__ energy,
        const unsigned char* __restrict__ flags, const float* __restrict__ loud,
        const float* __restrict__ ath, const float* __restrict__ fix_long,
        const float* __restrict__ fix_short, const int* __restrict__ band,
        const int* __restrict__ specs, const int* __restrict__ amount,
        const int* __restrict__ boost_bits, const int* __restrict__ boost_pos,
        int n_boost, int* __restrict__ wl_out, int* __restrict__ idx_out,
        int n, int bfu_idx_const, int flags_stride, int loud_channels,
        int loud_frames) {
    const int r = blockIdx.x * kWarps + threadIdx.x / 32;     // the row
    if (r >= n) return;                      // the whole warp
    const long long row = r;
    const int lane = threadIdx.x % 32;

    // loudness is [..., C, F] over channels C that may share one value
    const float ld = loud[r / (loud_channels * loud_frames) * loud_frames
                          + r % loud_frames];
    const Bfu b0 = load_bfu(lane, row, sfi, energy, flags, flags_stride, ld,
                            ath, fix_long, fix_short, band, specs);
    const Bfu b1 = load_bfu(lane + 32, row, sfi, energy, flags, flags_stride,
                            ld, ath, fix_long, fix_short, band, specs);
    const int amt = lane < kAmounts ? amount[lane] : 0x7fffffff;

    int idx = bfu_idx_const == 0 ? 7 : bfu_idx_const - 1;
    int w0, w1;
    int bits = bisect(b0, b1, __shfl_sync(kAll, amt, idx), &w0, &w1);
    if (bfu_idx_const == 0) {
        for (int round = 1; round < kShrinkRounds; ++round) {
            // the last BFU that got bits (-1: none), then lower_bound in amount[]
            const unsigned lo = __ballot_sync(kAll, w0 > 0);
            const unsigned hi = __ballot_sync(kAll, w1 > 0);
            const int last_nz = hi ? 63 - __clz(hi) : (lo ? 31 - __clz(lo) : -1);
            const int used_idx = __popc(__ballot_sync(kAll, amt < last_nz + 1));
            if (used_idx >= idx) break;          // no repeat: a fixed point
            idx -= 1;
            bits = bisect(b0, b1, __shfl_sync(kAll, amt, idx), &w0, &w1);
        }
    }

    // leftover-bit booster (atrac1_bitalloc.cpp:80-114)
    const int bfu_num = __shfl_sync(kAll, amt, idx);
    int surplus = avail_bits(bfu_num) - bits;
    const int min_key = boost_bits[0];
    if (surplus >= min_key) {                // else no entry can change
        const int key = min(surplus, boost_bits[n_boost - 1]);
        // lane e holds boost entry e: its BFU's wordlen and its bits
        const int e_bits = lane < n_boost ? boost_bits[lane] : 0;
        const int e_pos = lane < n_boost ? boost_pos[lane] : 0;
        const int from0 = __shfl_sync(kAll, w0, e_pos % 32);
        const int from1 = __shfl_sync(kAll, w1, e_pos % 32);
        int e_w = e_pos < 32 ? from0 : from1;
        // the part of the test that no step of the walk changes
        const int e_fixed = (lane < n_boost && e_bits <= key && e_pos < bfu_num)
                          ? 1 << 30 : 0;
        bool changed;
        do {
            changed = false;
            // an entry's wordlen changes only at its own step, so one
            // packed word a pass serves every step of it
            const int packed = e_fixed | e_w << 8 | e_bits;
            for (int e = 0; e < n_boost; ++e) {
                const int p = __shfl_sync(kAll, packed, e);
                const int eb = p & 0xff, w = (p >> 8) & 0xff;
                const int nbps = w > 0 ? 1 : 2;
                if ((p >> 30) && surplus >= min_key && w != 16
                        && !(w == 0 && eb * 2 > surplus) && eb * nbps <= surplus) {
                    surplus -= nbps * eb;
                    changed = true;
                    if (lane == e) e_w = w + nbps;
                }
            }
        } while (changed && surplus >= min_key);
        // back to the BFUs' lanes: the entry (if any) that holds each BFU
        int src0 = -1, src1 = -1;
        for (int e = 0; e < n_boost; ++e) {
            const int p = __shfl_sync(kAll, e_pos, e);
            if (p == b0.k) src0 = e;
            if (p == b1.k) src1 = e;
        }
        const int to0 = __shfl_sync(kAll, e_w, src0 < 0 ? lane : src0);
        const int to1 = __shfl_sync(kAll, e_w, src1 < 0 ? lane : src1);
        if (src0 >= 0) w0 = to0;
        if (src1 >= 0) w1 = to1;
    }

    wl_out[row * kBfus + b0.k] = w0;
    if (b1.k < kBfus) wl_out[row * kBfus + b1.k] = w1;
    if (lane == 0) idx_out[row] = idx;
}

}  // namespace

// Row-major inputs as the encoder makes them: sfi / energy [n, 52],
// short_flags rows of 3 bytes flags_stride apart (3, or 0 for one row
// shared by all), loud [..., loud_channels, loud_frames] with the channel
// axis broadcast (read at row / (C * F) * F + row % F; C = 1 and F = n for
// a contiguous [n]).  The tables are [52] (ath, fix_long, fix_short, band,
// specs), [8] (amount) and [n_boost] (boost_bits, boost_pos, sorted by bits
// then position).  bfu_idx_const: 0 = auto, 1..8 = fixed index + 1.
// Outputs wl_out [n, 52], idx_out [n].
extern "C" int atrac1_allocate(
        const int* sfi, const float* energy, const unsigned char* short_flags,
        const float* loud, const float* ath, const float* fix_long,
        const float* fix_short, const int* band, const int* specs,
        const int* amount, const int* boost_bits, const int* boost_pos,
        int n_boost, int* wl_out, int* idx_out, int n, int bfu_idx_const,
        int flags_stride, int loud_channels, int loud_frames, void* stream) {
    if (n <= 0) return 0;
    if (n_boost <= 0 || n_boost > kMaxBoost || bfu_idx_const < 0
            || bfu_idx_const > 8 || loud_channels <= 0 || loud_frames <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    at1_allocate_kernel<<<(n + kWarps - 1) / kWarps, kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        sfi, energy, short_flags, loud, ath, fix_long, fix_short, band, specs,
        amount, boost_bits, boost_pos, n_boost, wl_out, idx_out, n,
        bfu_idx_const, flags_stride, loud_channels, loud_frames);
    return static_cast<int>(cudaGetLastError());
}
