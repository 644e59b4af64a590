// Kernel A: per-(BFU, wordlen) plain quantisation costs of ATRAC3 blocks.
//
// Replaces the Pallas kernel atracdenc_tpu/ops/pallas_quant.py::
// quant_cost_plain (_kernel, :57-91).  For every 128-float BFU block and
// every wordlen w in 0..7 it rounds x*MAX_QUANT[w] half-to-even, forms
// err = e1/e2 (original over quantised energy; NaN -> 0, inf -> FLT_MAX)
// and the block's single-symbol VLC bit cost.
//
// Bound: by bytes on paper (of a frame's 16 KiB only the 4 KiB inside the
// block lengths count; 2 KiB are written), but a block's work is so small
// that instruction issue is what a kernel has to watch: one warp a block, a
// shuffle reduction for each wordlen's sums and VLC lengths from
// lane-divergent constant-memory reads cost about 900 warp-instructions a
// block, 25 times the bytes' time on an H100.
// Design (quant_block.cuh): a warp pass takes 128 values that count from
// several blocks, so a frame is 9 passes of about 400 instructions; squares
// and VLC lengths come as one word from a shared-memory table; the 8 packed
// sums of a block share one transposing butterfly.  The three quarters of a
// frame beyond the block lengths are never loaded.  A CTA of 8 warps builds
// the tables once and walks (frame, pass) items with a grid-wide stride.
// Only e1, the f32 sum of x^2, is summed in another order than the plain
// version: that is the one tolerated difference.
#include "quant_block.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
quant_cost_plain_kernel(const float* __restrict__ x,
                        const unsigned char* __restrict__ mask,
                        float* __restrict__ err, int* __restrict__ vlc,
                        long long n_frames) {
    __shared__ QuantTables tab;
    load_tables(tab);
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const long long n_items = n_frames * kDensePasses;
    const long long stride = static_cast<long long>(gridDim.x) * (kThreads / 32);
    for (long long it = static_cast<long long>(blockIdx.x) * (kThreads / 32)
                        + (threadIdx.x >> 5);
         it < n_items; it += stride) {
        const long long f = it / kDensePasses;
        const int pass = static_cast<int>(it - f * kDensePasses);
        frame_pass<false>(x + f * 4096, mask, pass, lane, tab,
                          err + f * 256, vlc + f * 256);
    }
}

}  // namespace

// x [n_frames, 32, 128] f32, mask [32, 128] u8, err/vlc [n_frames, 32, 8].
// Returns cudaGetLastError() of the launch.
extern "C" int atrac3_quant_cost_plain(const float* x, const unsigned char* mask,
                                       float* err, int* vlc, long long n_frames,
                                       void* stream) {
    if (n_frames <= 0) return 0;
    // CTAs the current card holds at once, asked at every launch (a few
    // microseconds on the host): a process may use more than one card
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quant_cost_plain_kernel, kThreads, 0);
    const long long resident = sms * per_sm > 0 ? sms * per_sm : 1;
    const long long want = (n_frames * kDensePasses + kThreads / 32 - 1) / (kThreads / 32);
    const unsigned ctas = static_cast<unsigned>(want < resident ? want : resident);
    quant_cost_plain_kernel<<<ctas, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, mask, err, vlc, n_frames);
    return static_cast<int>(cudaGetLastError());
}
