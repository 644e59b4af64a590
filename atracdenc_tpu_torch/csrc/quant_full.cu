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
// Bound: device-memory bandwidth.  A channel-frame is 16 KiB read once and
// 2 KiB written; the EA lanes re-read their block from L1 / L2.  What
// limits this first design is latency: each EA lane is a sequential
// accept recurrence of up to 128 steps.  Design: one CTA of 8 warps per
// channel-frame.  Phase 1: each warp costs 4 blocks as kernel A does.
// Phase 2: each warp takes EA lanes in turn (one lane = one BFU at one
// wordlen); lane i of the warp holds elements i, i+32, ...; the candidate
// order is a rank (count of smaller unique 64-bit keys: |delta| bits high,
// index low, i.e. torch.sort(stable=True)); then every thread of the warp
// runs the same recurrence over the ranked candidates from shared memory.
// No library sort, no global scratch.
#include "quant_block.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kEaFirst = 19;                 // LOSY_NAQ_START + 1
constexpr int kEaLanes = (32 - kEaFirst) * 7;

struct EaScratch {                           // one warp's EA lane
    unsigned long long key[128];             // candidates' sort keys
    int q[128];                              // plain-rounded mantissas
    unsigned char flags[128];                // bit 0: eligible, bit 1: t > 0
    unsigned char order[128];                // position of rank k
    unsigned char accept[128];               // wl == 1: flip accepted
};

__device__ __forceinline__ int flip(int m, bool up, bool tpos) {
    if (up) return m > 0 ? m + 1 : (m < 0 ? m - 1 : (tpos ? 1 : -1));
    return m > 0 ? m - 1 : (m < 0 ? m + 1 : m);
}

struct EaCost {
    float err;       // e1/e2 after the pass (sanitised)
    int vlc;         // w >= 2: VLC delta of the accepted flips;
                     // w == 1: pair-codebook bits of the adjusted mantissas
};

// One EA lane, the block xb / mb (length L = 32 * J) at wordlen w; the
// result is the same in every thread of the warp.
__device__ EaCost ea_lane(const float* __restrict__ xb,
                          const unsigned char* __restrict__ mb, int L, int w,
                          int lane, EaScratch& s) {
    const int J = L / 32;
    const float mul = c_maxq[w];
    const float inv2 = 1.0f / (mul * mul);

    float e1 = 0.0f;
    int m2 = 0, n_cand = 0;
    for (int j = 0; j < J; ++j) {
        const int p = j * 32 + lane;
        const float x = xb[p];
        const bool ok = mb[p] != 0;
        const float t = x * mul;
        const int q = ok ? __float2int_rn(t) : 0;
        const float x2 = ok ? x * x : 0.0f;
        e1 = j == 0 ? x2 : e1 + x2;          // lane_sum: lane's terms in order
        m2 += q * q;
        const float ad = fabsf(t - (truncf(t) + 0.5f));
        const bool cand = ok && ad < 0.25f;
        n_cand += cand;
        s.q[p] = q;
        s.flags[p] = (t > 0.0f) ? 2 : 0;
        s.key[p] = cand ? (static_cast<unsigned long long>(__float_as_uint(ad)) << 32) | p
                        : ~0ull;
        s.accept[p] = 0;
    }
    e1 = warp_sum(e1);                       // then the folds 16, 8, 4, 2, 1
    n_cand = warp_sum(n_cand);
    const float e2 = static_cast<float>(warp_sum(m2)) * inv2;
    const bool up = e2 < e1, dn = e2 > e1;   // fixed before the pass
    __syncwarp();

    for (int j = 0; j < J; ++j) {
        const int p = j * 32 + lane;
        const unsigned long long key = s.key[p];
        if (key == ~0ull) continue;
        const float at = fabsf(xb[p] * mul);
        const float am = static_cast<float>(abs(s.q[p]));
        const bool elig = up ? (am < at && am < mul - 1.0f) : (dn && am > at);
        s.flags[p] |= elig ? 1 : 0;
        int rank = 0;
        for (int i = 0; i < L; ++i) rank += s.key[i] < key;
        s.order[rank] = static_cast<unsigned char>(p);
    }
    __syncwarp();

    // the accept recurrence, in kernel B's float order; every thread of the
    // warp runs it on the same shared data, so the result is warp-uniform
    const int sel = w - 1 > 6 ? 6 : w - 1;
    float cur = e2;
    int dbits = 0;
    for (int k = 0; k < n_cand; ++k) {
        const int p = s.order[k];
        const unsigned char fl = s.flags[p];
        const int m = s.q[p];
        const int mn = flip(m, up, (fl & 2) != 0);
        const float a = static_cast<float>(m * m) * inv2;
        const float b = static_cast<float>(mn * mn) * inv2;
        const float ex = (cur - a) + b;
        if ((fl & 1) && fabsf(ex - e1) < fabsf(cur - e1)) {
            cur = ex;
            if (w >= 2) dbits += vlc_bits(mn, sel) - vlc_bits(m, sel);
            else if (lane == 0) s.accept[p] = 1;
        }
    }
    if (w >= 2) return {sanitize(e1 / cur), dbits};
    __syncwarp();
    // wl == 1: pair codebook over the adjusted mantissas (pairs at even
    // positions < L; the block's positions >= L are masked off)
    int bits = 0;
    for (int i = lane; i < L / 2; i += 32) {
        const int p = 2 * i;
        if (!mb[p]) continue;
        const int a = s.accept[p] ? flip(s.q[p], up, (s.flags[p] & 2) != 0) : s.q[p];
        const int b = s.accept[p + 1] ? flip(s.q[p + 1], up, (s.flags[p + 1] & 2) != 0)
                                      : s.q[p + 1];
        bits += pair_bits(a, b);
    }
    return {sanitize(e1 / cur), warp_sum(bits)};
}

__global__ void __launch_bounds__(kWarps * 32)
quant_cost_full_kernel(const float* __restrict__ x,
                       const unsigned char* __restrict__ mask,
                       float* __restrict__ err, int* __restrict__ vlc) {
    __shared__ float s_err[32 * 8];
    __shared__ int s_vlc[32 * 8];
    __shared__ EaScratch s_ea[kWarps];

    const long long f = blockIdx.x;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float* xf = x + f * 32 * 128;

    // phase 1: the plain lanes of every block; vlc[:, 1] takes the pair
    // codebook of the plain wl==1 mantissas
    for (int bfu = warp; bfu < 32; bfu += kWarps) {
        const float4 v = reinterpret_cast<const float4*>(xf + bfu * 128)[lane];
        const uchar4 m = reinterpret_cast<const uchar4*>(mask + bfu * 128)[lane];
        const PlainCost c = plain_block_cost<true>(v, m, lane);
        if (lane < 8) {
            s_err[bfu * 8 + lane] = c.err;
            s_vlc[bfu * 8 + lane] = lane == 1 ? c.pair : c.vlc;
        }
    }
    __syncthreads();

    // phase 2: the EA lanes overwrite err[19:32, 1:8] and vlc[19:32, 1],
    // and add their flips' bits to vlc[19:32, 2:8]
    for (int li = warp; li < kEaLanes; li += kWarps) {
        const int bfu = kEaFirst + li / 7;
        const int w = 1 + li % 7;
        const int L = bfu < 26 ? 32 : (bfu < 30 ? 64 : 128);
        const EaCost c = ea_lane(xf + bfu * 128, mask + bfu * 128, L, w, lane,
                                 s_ea[warp]);
        if (lane == 0) {
            s_err[bfu * 8 + w] = c.err;
            s_vlc[bfu * 8 + w] = w >= 2 ? s_vlc[bfu * 8 + w] + c.vlc : c.vlc;
        }
        __syncwarp();                        // before the scratch is reused
    }
    __syncthreads();

    err[f * 256 + threadIdx.x] = s_err[threadIdx.x];
    vlc[f * 256 + threadIdx.x] = s_vlc[threadIdx.x];
}

}  // namespace

// x [n_frames, 32, 128] f32, mask [32, 128] u8, err / vlc [n_frames, 32, 8].
// Returns cudaGetLastError() of the launch.
extern "C" int atrac3_quant_cost_full(const float* x, const unsigned char* mask,
                                      float* err, int* vlc, long long n_frames,
                                      void* stream) {
    if (n_frames <= 0) return 0;
    quant_cost_full_kernel<<<static_cast<unsigned>(n_frames), kWarps * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(x, mask, err, vlc);
    return static_cast<int>(cudaGetLastError());
}
