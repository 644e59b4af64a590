// Device code shared by kernel A (quant_cost.cu) and kernel D
// (quant_full.cu): the codebook tables and the plain-rounding costs of BFU
// blocks, several blocks to a warp.  D takes its plain lanes from here, so
// they equal A's bit for bit.
//
// What this code is built around: instruction issue, not memory, bounds both
// kernels on an H100.  Three things cut the instructions of a block:
//   * A frame's 32 blocks hold 1024 values that count (8 blocks of 8, 8 of
//     16, 10 of 32, 4 of 64, 2 of 128); the other 3072 are masked off.  A
//     warp pass takes 128 values that count, from up to 16 blocks, so a
//     frame is 9 passes (c_pass), not 32.  Each block owns an aligned run
//     of S = len/4 lanes, and every reduction stays inside that run.
//   * One table in shared memory, indexed by |mantissa|, gives the square
//     and the VLC bit length as one word (square in the low 18 bits, bits
//     above), so a value costs multiply, add, mask, load, add for each
//     wordlen.  The rounding is the add of 2^23 (half-to-even, as
//     cvt.rni); a masked value is sent to the table's zero entry.
//   * The 8 packed sums of a block (wordlens 1..7 and the count of values
//     that count) are reduced together by a transposing butterfly: 9
//     shuffles for 32 lanes where 8 separate sums take 40.
// e1, the f32 sum of x^2, has a fixed order: a lane adds its 4 consecutive
// values in turn, then the xor butterfly from S/2 down to 1.  That equals
// the 32-lane butterfly of one block a warp, whose lanes beyond a short
// block add zeros, so both layouts give the same bits.
//
// The mask contract: a value counts only inside its block's length
// (SPECS_PER_BLOCK), where the mask may switch further values off.  Mask
// bytes at or beyond the length are not read.
//
// Inputs are the encoder's scaled values: |x| <= 1, or NaN (mantissa 0, as
// cvt.rni gives).  Beyond that a mantissa may leave the table's range; the
// index is masked, so nothing is read out of bounds.
#pragma once
#include <cuda_runtime.h>
#include <cfloat>

namespace {

__constant__ float c_maxq[8] = {0.0f, 1.5f, 2.5f, 3.5f, 4.5f, 7.5f, 15.5f, 31.5f};

// Bit length of symbol idx (0..63) in spectrum codebook sel (wordlen-1,
// clamped to 0..6): atracdenc_tpu/models/atrac3/tables.py VLC_BITS as the
// step function of bitalloc._vlc_bits_arith (held past the table's end).
// A mantissa q has idx 2|q|-1 (q > 0) or 2|q| (q < 0), and the two lengths
// are equal, so the shared-memory table is indexed by |q|.
// tests/test_torch_quant_cost.py checks the literals and that symmetry
// against the tables.
__constant__ int c_vlc_step[7][64] = {
    {1, 3, 3, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5},
    {1, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3},
    {1, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4},
    {1, 3, 3, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5},
    {2, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4},
    {3, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4},
    {3, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 4, 4, 4},
};

// Bit length of the wl==1 pair symbol with key 3(a+1) + (b+1), a and b in
// -1..1: VLC_BITS[0, VLC_PAIR_RTAB[key]].
__constant__ int c_pair_bits[9] = {5, 4, 5, 3, 1, 3, 5, 4, 5};

// The 9 passes of a frame: {log2 of the lanes a block takes, first BFU,
// BFUs in the pass}.  A block of len values takes len/4 lanes.
// tests/test_torch_quant_cost.py holds this against SPECS_PER_BLOCK.
__constant__ unsigned char c_pass[9][3] = {{1, 0, 8}, {2, 8, 8}, {3, 16, 4}, {3, 20, 4}, {3, 24, 2}, {4, 26, 2}, {4, 28, 2}, {5, 30, 1}, {5, 31, 1}};

constexpr int kDensePasses = 9;
constexpr int kBitsShift = 18;               // a block's sum of q^2 <= 128 * 32^2 < 2^18
constexpr unsigned kM2Mask = (1u << kBitsShift) - 1;
constexpr unsigned kZeroEntry = 63;          // table entry of a masked value
constexpr float kRound = 8388608.0f;         // 2^23: t + 2^23 rounds t >= 0 half-to-even

struct QuantTables {
    // cost[w][|q|] = q*q | bits << 18 in wordlen w's codebook; row 0 holds
    // the squares alone; entry 63 of every row is 0
    unsigned cost[8][64];
    float mul[8];                            // MAX_QUANT
    float inv2[8];                           // 1 / mul^2 (0 at wordlen 0)
    int pair[9];
};

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// NaN -> 0, +inf -> FLT_MAX (the memo's select-safe map)
__device__ __forceinline__ float sanitize(float e) {
    return isnan(e) ? 0.0f : (isinf(e) ? FLT_MAX : e);
}

// Fill the tables; every thread of the CTA calls it, and the caller
// synchronises before the first use.
__device__ __forceinline__ void load_tables(QuantTables& t) {
    for (int i = threadIdx.x; i < 8 * 64; i += blockDim.x) {
        const int w = i >> 6, a = i & 63;
        unsigned e = 0;
        if (a != static_cast<int>(kZeroEntry)) {
            e = static_cast<unsigned>(a * a);
            if (w > 0) {
                const int idx = a > 0 ? 2 * a - 1 : 0;
                e |= static_cast<unsigned>(c_vlc_step[w - 1][idx > 63 ? 63 : idx]) << kBitsShift;
            }
        }
        t.cost[w][a] = e;
    }
    if (threadIdx.x < 8) {
        const float mul = c_maxq[threadIdx.x];
        t.mul[threadIdx.x] = mul;
        t.inv2[threadIdx.x] = mul > 0.0f ? 1.0f / (mul * mul) : 0.0f;
    }
    if (threadIdx.x < 9) t.pair[threadIdx.x] = c_pair_bits[threadIdx.x];
}

// Values of BFU block bfu that count (SPECS_PER_BLOCK).
__device__ __forceinline__ int block_len(int bfu) {
    return bfu < 8 ? 8 : (bfu < 16 ? 16 : (bfu < 26 ? 32 : (bfu < 30 ? 64 : 128)));
}

// Pair-codebook bits of the wl==1 mantissas (a, b) at an even position.
__device__ __forceinline__ int pair_bits(const QuantTables& t, int a, int b) {
    const int key = 3 * (a + 1) + (b + 1);
    return t.pair[key < 0 ? 0 : (key > 8 ? 8 : key)];
}

// One step of the transposing butterfly: of 2 N slots a lane keeps the odd
// ones (upper) or the even ones and adds what its partner at lane distance
// off hands over.
template <int N>
__device__ __forceinline__ void fold_slots(const unsigned* in, unsigned* out,
                                           bool upper, int off) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const unsigned keep = upper ? in[2 * i + 1] : in[2 * i];
        const unsigned send = upper ? in[2 * i] : in[2 * i + 1];
        out[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
}

// One warp pass over n_bfu blocks from first_bfu on, S lanes a block: lane
// sl of a block holds its values 4 sl .. 4 sl + 3.  Writes err[bfu * 8 + w]
// (e1/e2, sanitised; 0 at w 0) and vlc[bfu * 8 + w] for w in 0..7: the
// single-symbol VLC bits, or with kPairs at w 1 the pair-codebook bits.
// err_out / vlc_out are the frame's [32, 8] planes, global or shared.
template <int S, bool kPairs>
__device__ __forceinline__ void plain_pass(const float* __restrict__ xf,
                                           const unsigned char* __restrict__ mask,
                                           int first_bfu, int n_bfu, int lane,
                                           const QuantTables& t,
                                           float* err_out, int* vlc_out) {
    const int sl = lane % S;
    const int bfu = first_bfu + lane / S;
    const bool active = lane / S < n_bfu;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    unsigned mw = 0;
    if (active) {
        v = reinterpret_cast<const float4*>(xf + bfu * 128)[sl];
        mw = reinterpret_cast<const unsigned*>(mask + bfu * 128)[sl];
    }
    const float xs[4] = {v.x, v.y, v.z, v.w};
    bool ok[4];
    float aq[4];
    unsigned off[4];
    unsigned n_ok = 0;
    float e1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        ok[i] = ((mw >> (8 * i)) & 0xffu) != 0;
        e1 += ok[i] ? xs[i] * xs[i] : 0.0f;
        aq[i] = (ok[i] && xs[i] == xs[i]) ? fabsf(xs[i]) : 0.0f;
        off[i] = ok[i] ? 0u : kZeroEntry;
        n_ok += ok[i];
    }
#pragma unroll
    for (int o = S / 2; o > 0; o >>= 1) e1 += __shfl_xor_sync(0xffffffffu, e1, o);

    // slot 0 counts the values that count (wordlen 0: every mantissa is 0);
    // slot w the packed sums of wordlen w
    unsigned acc[8];
    unsigned a1[4] = {0, 0, 0, 0};
    acc[0] = n_ok << kBitsShift;
#pragma unroll
    for (int w = 1; w < 8; ++w) {
        const float mul = c_maxq[w];
        const unsigned* row = t.cost[(kPairs && w == 1) ? 0 : w];
        unsigned s = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // a separate multiply and add, whatever the build's -fmad says
            const unsigned a = __float_as_uint(__fadd_rn(__fmul_rn(aq[i], mul), kRound)) & 63u;
            if (kPairs && w == 1) a1[i] = a;
            s += row[a | off[i]];
        }
        acc[w] = s;
    }
    if (kPairs) {
        int q[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            q[i] = xs[i] < 0.0f ? -static_cast<int>(a1[i]) : static_cast<int>(a1[i]);
        const int pb = (ok[0] ? pair_bits(t, q[0], q[1]) : 0)
                       + (ok[2] ? pair_bits(t, q[2], q[3]) : 0);
        acc[1] += static_cast<unsigned>(pb) << kBitsShift;
    }

    // The transposing butterfly: at offset 2^s a lane keeps the slots whose
    // bit s equals its own and hands over the others, so after kT steps it
    // holds the slots (i << kT) + (sl & (2^kT - 1)); plain butterflies sum
    // what is left of the block's lanes.
    constexpr int kT = S >= 8 ? 3 : (S == 4 ? 2 : 1);
    unsigned r4[4], r2[2] = {0, 0}, r1 = 0;
    fold_slots<4>(acc, r4, (sl & 1) != 0, 1);
    if (kT >= 2) fold_slots<2>(r4, r2, (sl & 2) != 0, 2);
    if (kT >= 3) {
        fold_slots<1>(r2, &r1, (sl & 4) != 0, 4);
#pragma unroll
        for (int o = 8; o < S; o <<= 1) r1 += __shfl_xor_sync(0xffffffffu, r1, o);
    }

    if (!active || sl >= 8) return;          // S > 8: lanes 8.. hold copies
    constexpr int kSlots = 8 >> kT;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
        unsigned packed;
        if constexpr (kT == 3) packed = r1;
        else if constexpr (kT == 2) packed = r2[i];
        else packed = r4[i];
        const int w = (i << kT) + (sl & ((1 << kT) - 1));
        const int m2 = static_cast<int>(packed & kM2Mask);
        const int bits = static_cast<int>(packed >> kBitsShift);
        float e = 0.0f;                      // wl == 0: never boosted
        if (w > 0) e = sanitize(e1 / (static_cast<float>(m2) * t.inv2[w]));
        err_out[bfu * 8 + w] = e;
        vlc_out[bfu * 8 + w] = w == 0 ? bits * c_vlc_step[0][0] : bits;
    }
}

// Pass `pass` (0..8) of a frame's 9 dense passes.
template <bool kPairs>
__device__ __forceinline__ void frame_pass(const float* __restrict__ xf,
                                           const unsigned char* __restrict__ mask,
                                           int pass, int lane,
                                           const QuantTables& t,
                                           float* err_out, int* vlc_out) {
    const int first = c_pass[pass][1];
    const int n = c_pass[pass][2];
    switch (c_pass[pass][0]) {
    case 1: plain_pass<2, kPairs>(xf, mask, first, n, lane, t, err_out, vlc_out); break;
    case 2: plain_pass<4, kPairs>(xf, mask, first, n, lane, t, err_out, vlc_out); break;
    case 3: plain_pass<8, kPairs>(xf, mask, first, n, lane, t, err_out, vlc_out); break;
    case 4: plain_pass<16, kPairs>(xf, mask, first, n, lane, t, err_out, vlc_out); break;
    default: plain_pass<32, kPairs>(xf, mask, first, n, lane, t, err_out, vlc_out); break;
    }
}

}  // namespace
