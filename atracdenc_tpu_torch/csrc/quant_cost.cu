// Kernel A: per-(BFU, wordlen) plain quantisation costs of ATRAC3 blocks.
//
// Replaces the Pallas kernel atracdenc_tpu/ops/pallas_quant.py::
// quant_cost_plain (_kernel, :57-91).  For every 128-float BFU block and
// every wordlen w in 0..7 it rounds x*MAX_QUANT[w] half-to-even, forms
// err = e1/e2 (original over quantised energy; NaN -> 0, inf -> FLT_MAX)
// and the block's single-symbol VLC bit cost.
//
// Bound: device-memory bandwidth.  Each block is 512 bytes read once and
// 64 bytes written; the arithmetic is ~8 x 4 rounds per value.  Design:
// one warp per block, 4 consecutive values per lane (one 16-byte load, so
// a warp reads its block in one coalesced 512-byte transaction); all 8
// wordlens are evaluated from registers, so the [N, 32, 8, 128] lane
// broadcast of the XLA form never exists.  Sums of m^2 and of VLC bits are
// integer warp-shuffle sums (exact in any order).  Only e1, the f32 sum of
// x^2, is summed in another order than the plain version: that is the one
// tolerated difference.
#include <cuda_runtime.h>
#include <cfloat>

namespace {

__constant__ float c_maxq[8] = {0.0f, 1.5f, 2.5f, 3.5f, 4.5f, 7.5f, 15.5f, 31.5f};

// Bit length of symbol idx (0..63) in spectrum codebook sel (wordlen-1,
// clamped to 0..6): atracdenc_tpu/models/atrac3/tables.py VLC_BITS as the
// step function of bitalloc._vlc_bits_arith (held past the table's end).
// tests/test_torch_quant_cost.py checks this literal against the tables.
__constant__ int c_vlc_step[7][64] = {
    {1, 3, 3, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5},
    {1, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3},
    {1, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4},
    {1, 3, 3, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5},
    {2, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4},
    {3, 4, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4},
    {3, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 8, 4, 4, 4},
};

__device__ __forceinline__ float warp_sum(float v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ int warp_sum(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__global__ void quant_cost_plain_kernel(const float* __restrict__ x,
                                        const unsigned char* __restrict__ mask,
                                        float* __restrict__ err,
                                        int* __restrict__ vlc,
                                        long long n_blocks) {
    const long long blk = (static_cast<long long>(blockIdx.x) * blockDim.x
                           + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (blk >= n_blocks) return;            // warp-uniform exit
    const int bfu = static_cast<int>(blk % 32);

    const float4 v = reinterpret_cast<const float4*>(x + blk * 128)[lane];
    const uchar4 m = reinterpret_cast<const uchar4*>(mask + bfu * 128)[lane];
    const float xs[4] = {v.x, v.y, v.z, v.w};
    const bool ok[4] = {m.x != 0, m.y != 0, m.z != 0, m.w != 0};

    float e1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) e1 += ok[i] ? xs[i] * xs[i] : 0.0f;
    e1 = warp_sum(e1);

    float err_w = 0.0f;
    int vlc_w = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) {
        const float mul = c_maxq[w];
        const int sel = w == 0 ? 0 : (w - 1 > 6 ? 6 : w - 1);
        int m2 = 0, bits = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            // half-to-even, as jnp.round (never roundf: half away from 0)
            const int q = ok[i] ? __float2int_rn(xs[i] * mul) : 0;
            m2 += q * q;
            const int idx = q < 0 ? -2 * q : (q > 0 ? 2 * q - 1 : 0);
            bits += ok[i] ? c_vlc_step[sel][idx > 63 ? 63 : idx] : 0;
        }
        m2 = warp_sum(m2);
        bits = warp_sum(bits);
        if (lane == w) {
            float e = 0.0f;                  // wl == 0: never boosted
            if (mul > 0.0f) {
                const float e2 = static_cast<float>(m2) * (1.0f / (mul * mul));
                e = e1 / e2;
                if (isnan(e)) e = 0.0f;
                else if (isinf(e)) e = FLT_MAX;
            }
            err_w = e;
            vlc_w = bits;
        }
    }
    if (lane < 8) {
        err[blk * 8 + lane] = err_w;
        vlc[blk * 8 + lane] = vlc_w;
    }
}

}  // namespace

// x [n_blocks, 128] f32 (n_blocks = N * 32), mask [32, 128] u8,
// err/vlc [n_blocks, 8].  Returns cudaGetLastError() of the launch.
extern "C" int atrac3_quant_cost_plain(const float* x, const unsigned char* mask,
                                       float* err, int* vlc, long long n_blocks,
                                       void* stream) {
    if (n_blocks <= 0) return 0;
    const int threads = 256;                 // 8 blocks of 128 per CTA
    const long long ctas = (n_blocks * 32 + threads - 1) / threads;
    quant_cost_plain_kernel<<<static_cast<unsigned>(ctas), threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        x, mask, err, vlc, n_blocks);
    return static_cast<int>(cudaGetLastError());
}
