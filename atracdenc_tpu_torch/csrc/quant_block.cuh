// Device code shared by kernel A (quant_cost.cu) and kernel D
// (quant_full.cu): the codebook tables and the plain-rounding costs of one
// 128-float BFU block, evaluated by one warp.  D takes its plain lanes from
// here, so they equal A's bit for bit.
#pragma once
#include <cuda_runtime.h>
#include <cfloat>

namespace {

__constant__ float c_maxq[8] = {0.0f, 1.5f, 2.5f, 3.5f, 4.5f, 7.5f, 15.5f, 31.5f};

// Bit length of symbol idx (0..63) in spectrum codebook sel (wordlen-1,
// clamped to 0..6): atracdenc_tpu/models/atrac3/tables.py VLC_BITS as the
// step function of bitalloc._vlc_bits_arith (held past the table's end).
// tests/test_torch_quant_cost.py checks both literals against the tables.
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

// Single-symbol VLC bits of mantissa q in codebook sel (0..6).
__device__ __forceinline__ int vlc_bits(int q, int sel) {
    const int idx = q < 0 ? -2 * q : (q > 0 ? 2 * q - 1 : 0);
    return c_vlc_step[sel][idx > 63 ? 63 : idx];
}

// Pair-codebook bits of the wl==1 mantissas (a, b) at an even position.
__device__ __forceinline__ int pair_bits(int a, int b) {
    const int key = 3 * (a + 1) + (b + 1);
    return c_pair_bits[key < 0 ? 0 : (key > 8 ? 8 : key)];
}

struct PlainCost {
    float err;       // lane w < 8: e1/e2 of wordlen w (sanitised; 0 at w 0)
    int vlc;         // lane w < 8: single-symbol VLC bits of wordlen w
    int pair;        // every lane, with kPairs: wl==1 pair-codebook bits
};

// One warp, one block: lane l holds the values 4l..4l+3 (v) and their mask
// bits (m).  Every wordlen is evaluated from registers; the sums of m^2 and
// of VLC bits are integer warp sums (exact in any order).
template <bool kPairs>
__device__ __forceinline__ PlainCost plain_block_cost(float4 v, uchar4 m, int lane) {
    const float xs[4] = {v.x, v.y, v.z, v.w};
    const bool ok[4] = {m.x != 0, m.y != 0, m.z != 0, m.w != 0};

    float e1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) e1 += ok[i] ? xs[i] * xs[i] : 0.0f;
    e1 = warp_sum(e1);

    PlainCost out{0.0f, 0, 0};
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        const float mul = c_maxq[w];
        const int sel = w == 0 ? 0 : (w - 1 > 6 ? 6 : w - 1);
        int q[4], m2 = 0, bits = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // half-to-even, as jnp.round (never roundf: half away from 0)
            q[i] = ok[i] ? __float2int_rn(xs[i] * mul) : 0;
            m2 += q[i] * q[i];
            bits += ok[i] ? vlc_bits(q[i], sel) : 0;
        }
        if (kPairs && w == 1)
            out.pair = warp_sum((ok[0] ? pair_bits(q[0], q[1]) : 0)
                                + (ok[2] ? pair_bits(q[2], q[3]) : 0));
        m2 = warp_sum(m2);
        bits = warp_sum(bits);
        if (lane == w) {
            float e = 0.0f;                  // wl == 0: never boosted
            if (mul > 0.0f)
                e = sanitize(e1 / (static_cast<float>(m2) * (1.0f / (mul * mul))));
            out.err = e;
            out.vlc = bits;
        }
    }
    return out;
}

}  // namespace
