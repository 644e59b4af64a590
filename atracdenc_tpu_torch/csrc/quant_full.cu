// Kernel D: the complete ATRAC3 quantisation-cost memo in one kernel.
//
// Replaces the Pallas kernel atracdenc_tpu/ops/pallas_quant.py::
// quant_cost_full (_full_kernel :237-285, _ea_group :106-234).  For every
// channel-frame (32 BFU blocks of 128 floats) it produces err [32, 8] and
// vlc [32, 8]:
//   * the plain lanes of every block: kernel A's device code
//     (quant_block.cuh), so they equal A's bit for bit;
//   * the energy-adjusted (EA) overlay on BFUs 19..31, wordlens 1..7 (91
//     lanes): candidates |t - (trunc(t) + 0.5)| < 0.25 in ascending
//     |delta| order (ties by index), each accepted while it moves the
//     quantised energy toward the original (ops/quant.py::quant_blocks);
//     wordlens >= 2 add the VLC bit delta of every accepted flip;
//   * the wl==1 pair codebook over the EA-adjusted wl==1 mantissas, which
//     replaces vlc[:, 1].
// Every float op is the plain version's (ops/quant_cost.py::memo) in the
// same order (built with -fmad=false); e1 of an EA lane is summed in
// ops/quant.py::lane_sum's order, the one order both sides share, so the
// accept decisions, and with them vlc, are equal.  Only the plain lanes'
// e1 (summed as A sums it) is taken in another order than torch.sum.
//
// Bound: instruction issue, not bytes and not latency.  Of a channel-frame
// 4 KiB count and 2 KiB are written, 0.06 ms for the main path's 32,768
// frames on an H100, and the arithmetic is 0.1 ms at the f32 peak; the
// kernel takes about 1.2 ms there (1.9 ms on frames whose every value is an
// eligible candidate at wordlen 7), and that time does not
// move with the CTAs an SM holds (2 to 16 warps a CTA, 4 to 12 CTAs an SM):
// it is the count of instructions, the integer pipe's half rate included.
// A rank of every candidate against every other (O(L^2)) and a whole warp
// stepping through one lane's recurrence would cost five times as many, so
// the design avoids both.  A CTA of 8 warps takes kFrames frames at a time,
// with a grid-wide stride:
//   1. Warps share out the frames' 13 EA blocks and the 9 plain passes of
//      kernel A's device code.  An EA block is loaded and its e1 summed
//      once for its 7 wordlens.  A candidate that is not eligible never
//      changes the recurrence (its accept test needs the flag), so only the
//      eligible ones, about an eighth of a block on the encoder's data, are
//      kept: compacted by ballot into the warp's scratch and ranked there
//      by their unique 64-bit keys (|delta| bits high, index below: the
//      order of torch.sort(stable=True)), one FP64 compare a pair.  The
//      rank costs n^2 / 32 compares a lane for n kept candidates, L^2 / 32
//      only if all of a block is eligible.  Each candidate's mantissa and
//      index go to the lane's column of a step-major table in shared
//      memory.
//   2. One thread per EA lane runs the accept recurrence, in kernel B's
//      float order, 91 threads a frame side by side over their columns.
//   3. Warps take the EA blocks again for the wl==1 pair codebook over the
//      adjusted mantissas.
// Two frames between barriers keep 6 of the 8 warps in step 2 and even out
// step 1; more do not fit the 48 KiB of static shared memory.
// An eligible candidate has t > 0, so its mantissa m is >= 0: a candidate
// needs |t - (trunc(t) + 0.5)| < 0.25, and that distance is frac + 0.5 for
// t < 0.  Its flip is m + 1 (up) or max(m - 1, 0) (down).
// No library sort, no global scratch.
#include "quant_block.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kFrames = 2;                    // frames a CTA holds between barriers
constexpr int kEaFirst = 19;                 // LOSY_NAQ_START + 1
constexpr int kEaBfus = 32 - kEaFirst;
constexpr int kEaLanes = kEaBfus * 7;
// lanes by block length: 7 BFUs of 32, 4 of 64, 2 of 128, 7 wordlens each
constexpr int kLanes32 = 49, kLanes64 = 28, kLanes128 = 14;
constexpr int kEntries = 32 * kLanes32 + 64 * kLanes64 + 128 * kLanes128;
constexpr float kMagic = 12582912.0f;        // 1.5 * 2^23: (t + kMagic) - kMagic
                                             // rounds |t| < 2^22 half-to-even
constexpr int kMagicBits = 0x4B400000;

struct alignas(16) EaLane {                  // what the recurrence starts from
    float e1, e2;
    int n;                                   // eligible candidates
    int up;
};

struct FrameShared {                         // one frame in flight
    float err[32 * 8];
    int vlc[32 * 8];
    unsigned short ent[kEntries];            // sorted: index << 8 | mantissa
    EaLane lanes[kEaLanes];
    unsigned accept[kEaBfus][4];             // wl == 1: bit p, flip accepted
};

struct FullShared {
    QuantTables tab;
    unsigned long long keys[kWarps][128];    // a warp's compacted candidates
    FrameShared fr[kFrames];
};

// The column of EA lane li in FullShared::ent: step k is at
// ent[base + k * stride], so the threads of a warp read neighbouring
// halfwords.
__device__ __forceinline__ void ent_column(int li, int& base, int& stride) {
    if (li < kLanes32) { base = li; stride = kLanes32; }
    else if (li < kLanes32 + kLanes64) {
        base = 32 * kLanes32 + li - kLanes32; stride = kLanes64;
    } else {
        base = 32 * kLanes32 + 64 * kLanes64 + li - kLanes32 - kLanes64;
        stride = kLanes128;
    }
}

__device__ __forceinline__ int flip(int m, bool up, bool tpos) {
    if (up) return m > 0 ? m + 1 : (m < 0 ? m - 1 : (tpos ? 1 : -1));
    return m > 0 ? m - 1 : (m < 0 ? m + 1 : m);
}

// One warp, one EA block of L = 32 J values, its 7 wordlens in turn: lane i
// holds elements i, i + 32, ...  Fills the lanes' EaLane records and their
// columns of sorted eligible candidates.
template <int J>
__device__ __forceinline__ void ea_prepare(const float* __restrict__ xb,
                                           const unsigned char* __restrict__ mb,
                                           int bfu, int lane,
                                           const QuantTables& tab, FrameShared& s,
                                           unsigned long long* keys) {
    float x[J];
    float e1 = 0.0f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
        const int p = j * 32 + lane;
        x[j] = mb[p] != 0 ? xb[p] : 0.0f;
        const float x2 = x[j] * x[j];
        e1 = j == 0 ? x2 : e1 + x2;          // lane_sum: lane's terms in order
    }
    e1 = warp_sum(e1);                       // then the folds 16, 8, 4, 2, 1

    int base, stride;                        // wordlen 1's column; w's is w - 1 on
    ent_column((bfu - kEaFirst) * 7, base, stride);
#pragma unroll 1
    for (int w = 1; w < 8; ++w) {
        const float mul = tab.mul[w];
        float t[J], r[J];
        float m2 = 0.0f;                     // integers < 2^24: exact in f32
#pragma unroll
        for (int j = 0; j < J; ++j) {
            t[j] = x[j] * mul;
            r[j] = __fadd_rn(__fadd_rn(t[j], kMagic), -kMagic);   // rint(t)
            m2 = __fmaf_rn(r[j], r[j], m2);
        }
        const float e2 = warp_sum(m2) * tab.inv2[w];
        const bool up = e2 < e1, dn = e2 > e1;   // fixed before the pass

        int n = 0;
#pragma unroll
        for (int j = 0; j < J; ++j) {
            const float ad = fabsf(t[j] - (truncf(t[j]) + 0.5f));
            const float am = fabsf(r[j]), at = fabsf(t[j]);
            const bool elig = ad < 0.25f
                && (up ? (am < at && am < mul - 1.0f) : (dn && am > at));
            const unsigned bal = __ballot_sync(0xffffffffu, elig);
            if (elig) {
                const int q = __float_as_int(__fadd_rn(t[j], kMagic)) - kMagicBits;
                const unsigned low = (static_cast<unsigned>(j * 32 + lane) << 8)
                                     | static_cast<unsigned>(q < 255 ? q : 255);
                keys[n + __popc(bal & ((1u << lane) - 1u))] =
                    (static_cast<unsigned long long>(__float_as_uint(ad)) << 32) | low;
            }
            n += __popc(bal);
        }
        __syncwarp();

        for (int i = lane; i < n; i += 32) {
            // the keys are below 2^62, where the order of the integers is
            // the order of the doubles with the same bits (none is a NaN):
            // one compare on the FP64 pipe for two on the integer pipe
            const unsigned long long key = keys[i];
            const double dkey = __longlong_as_double(static_cast<long long>(key));
            int rank = 0;
            for (int k = 0; k < n; ++k)
                rank += __longlong_as_double(static_cast<long long>(keys[k])) < dkey;
            s.ent[base + w - 1 + rank * stride] = static_cast<unsigned short>(key);
        }
        if (lane == 0) s.lanes[(bfu - kEaFirst) * 7 + w - 1] = {e1, e2, n, up ? 1 : 0};
        __syncwarp();                        // before the scratch is reused
    }
}

// One thread, one EA lane: the accept recurrence over its sorted eligible
// candidates, in kernel B's float order.
__device__ __forceinline__ void ea_recurrence(int li, const QuantTables& tab,
                                              FrameShared& s) {
    const int bfu = kEaFirst + li / 7;
    const int w = 1 + li % 7;
    const EaLane ln = s.lanes[li];
    const float inv2 = tab.inv2[w];
    const unsigned* row = tab.cost[w];
    int base, stride;
    ent_column(li, base, stride);
    float cur = ln.e2;
    int dbits = 0;
    // only the three adds and the compare of a step wait for the step
    // before; the loads and the terms a, b and d do not
#pragma unroll 4
    for (int k = 0; k < ln.n; ++k) {
        const unsigned e = s.ent[base + k * stride];
        const int m = static_cast<int>(e & 255u);
        const int mn = ln.up ? m + 1 : (m > 0 ? m - 1 : 0);
        const float a = static_cast<float>(m * m) * inv2;
        const float b = static_cast<float>(mn * mn) * inv2;
        const int d = static_cast<int>(row[mn & 63] >> kBitsShift)
                      - static_cast<int>(row[m & 63] >> kBitsShift);
        const float ex = (cur - a) + b;
        const bool take = fabsf(ex - ln.e1) < fabsf(cur - ln.e1);
        cur = take ? ex : cur;
        dbits += take ? d : 0;
        if (take && w == 1)
            s.accept[bfu - kEaFirst][e >> 13] |= 1u << ((e >> 8) & 31u);
    }
    s.err[bfu * 8 + w] = sanitize(ln.e1 / cur);
    if (w >= 2) s.vlc[bfu * 8 + w] += dbits;
}

// One warp, one EA block: the wl == 1 pair codebook over the adjusted
// mantissas (pairs at even positions < L; positions >= L are masked off).
__device__ __forceinline__ void ea_pairs(const float* __restrict__ xb,
                                         const unsigned char* __restrict__ mb,
                                         int bfu, int L, int lane,
                                         const QuantTables& tab, FrameShared& s) {
    const bool up = s.lanes[(bfu - kEaFirst) * 7].up != 0;
    const unsigned* acc = s.accept[bfu - kEaFirst];
    const float mul = tab.mul[1];
    int bits = 0;
    for (int i = lane; i < L / 2; i += 32) {
        const int p = 2 * i;
        if (!mb[p]) continue;
        int q[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
            const float t = mb[p + d] ? xb[p + d] * mul : 0.0f;
            q[d] = __float2int_rn(t);
            if ((acc[(p + d) >> 5] >> ((p + d) & 31)) & 1u) q[d] = flip(q[d], up, t > 0.0f);
        }
        bits += pair_bits(tab, q[0], q[1]);
    }
    bits = warp_sum(bits);
    if (lane == 0) s.vlc[bfu * 8 + 1] = bits;
}

__global__ void __launch_bounds__(kWarps * 32)
quant_cost_full_kernel(const float* __restrict__ x,
                       const unsigned char* __restrict__ mask,
                       float* __restrict__ err, int* __restrict__ vlc,
                       long long n_frames) {
    __shared__ FullShared s;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    load_tables(s.tab);
    __syncthreads();
    constexpr int per_frame = kEaBfus + kDensePasses;

    for (long long f0 = static_cast<long long>(blockIdx.x) * kFrames; f0 < n_frames;
         f0 += static_cast<long long>(gridDim.x) * kFrames) {
        const int nf = n_frames - f0 < kFrames ? static_cast<int>(n_frames - f0) : kFrames;
        for (int i = threadIdx.x; i < nf * kEaBfus * 4; i += kWarps * 32)
            (&s.fr[i / (kEaBfus * 4)].accept[0][0])[i % (kEaBfus * 4)] = 0;

        // 1. the longest EA blocks first, then the plain passes; vlc[:, 1]
        // of a plain pass is the pair codebook of the plain mantissas
        for (int it = warp; it < nf * per_frame; it += kWarps) {
            const int item = it / nf;
            FrameShared& fr = s.fr[it % nf];
            const float* xf = x + (f0 + it % nf) * 4096;
            if (item >= kEaBfus) {
                frame_pass<true>(xf, mask, item - kEaBfus, lane, s.tab,
                                 fr.err, fr.vlc);
                continue;
            }
            const int bfu = 31 - item;
            const float* xb = xf + bfu * 128;
            const unsigned char* mb = mask + bfu * 128;
            // block_len(bfu) / 32 elements a lane (a switch on it measured 6% slower)
            if (bfu >= 30) ea_prepare<4>(xb, mb, bfu, lane, s.tab, fr, s.keys[warp]);
            else if (bfu >= 26) ea_prepare<2>(xb, mb, bfu, lane, s.tab, fr, s.keys[warp]);
            else ea_prepare<1>(xb, mb, bfu, lane, s.tab, fr, s.keys[warp]);
        }
        __syncthreads();

        // 2. the EA lanes overwrite err[19:32, 1:8], add their flips' bits
        // to vlc[19:32, 2:8] and mark the accepted wl == 1 flips
        for (int i = threadIdx.x; i < nf * kEaLanes; i += kWarps * 32)
            ea_recurrence(i % kEaLanes, s.tab, s.fr[i / kEaLanes]);
        __syncthreads();

        // 3. vlc[19:32, 1]
        for (int it = warp; it < nf * kEaBfus; it += kWarps) {
            const int bfu = 31 - it / nf;
            ea_pairs(x + (f0 + it % nf) * 4096 + bfu * 128, mask + bfu * 128, bfu,
                     block_len(bfu), lane, s.tab, s.fr[it % nf]);
        }
        __syncthreads();

        for (int i = threadIdx.x; i < nf * 256; i += kWarps * 32) {
            err[f0 * 256 + i] = s.fr[i >> 8].err[i & 255];
            vlc[f0 * 256 + i] = s.fr[i >> 8].vlc[i & 255];
        }
        __syncthreads();                     // before the next frames' writes
    }
}

}  // namespace

// x [n_frames, 32, 128] f32, mask [32, 128] u8, err / vlc [n_frames, 32, 8].
// Returns cudaGetLastError() of the launch.
extern "C" int atrac3_quant_cost_full(const float* x, const unsigned char* mask,
                                      float* err, int* vlc, long long n_frames,
                                      void* stream) {
    if (n_frames <= 0) return 0;
    // CTAs the current card holds at once, asked at every launch
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quant_cost_full_kernel, kWarps * 32, 0);
    const long long resident = sms * per_sm > 0 ? sms * per_sm : 1;
    const long long want = (n_frames + kFrames - 1) / kFrames;
    const unsigned ctas = static_cast<unsigned>(want < resident ? want : resident);
    quant_cost_full_kernel<<<ctas, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
        x, mask, err, vlc, n_frames);
    return static_cast<int>(cudaGetLastError());
}
