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
#include "quant_block.cuh"

namespace {

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
    const PlainCost c = plain_block_cost<false>(v, m, lane);
    if (lane < 8) {
        err[blk * 8 + lane] = c.err;
        vlc[blk * 8 + lane] = c.vlc;
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
