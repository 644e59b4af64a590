// The bit deposit: [F, K] fields into [F, total_bytes] MSB-first frames.
//
// Replaces no TPU kernel.  The JAX package deposits with XLA alone
// (atracdenc_tpu/ops/bitdeposit.py::deposit_fields: four byte lanes a word
// half, summed by a bf16 one-hot einsum on the MXU); its plain PyTorch
// port (ops/bitdeposit.py::deposit_fields_torch) spells the same lanes out
// as [F, K, 8] int64 temporaries and one scatter_add_, and took most of
// the device time of the ATRAC1 batch call.  This kernel is its CUDA
// counterpart, with the same semantics: field k of frame f deposits
// widths[f, k] bits of values[f, k] (taken as its low 32 bits, pre-masked
// to its width) at bit offsets[f, k]; a width of 0 or less is no field;
// fields do not overlap and are at most 32 bits wide; a field wholly or
// partly past total_bytes loses what lies past the frame's last word.
//
// Bound: the bytes of the three field planes, each read once (ATRAC1's
// 65,536 x 1,151 int64 fields: 1.81 GB, 0.54 ms at 3.35 TB/s); the frames
// written are under 1% of that.
// Design: a frame's (total_bytes + 3) / 4 words, plus one sink word, live
// in shared memory, zeroed first.  The frame's threads stride over its K
// fields with coalesced loads of each plane in the caller's dtype (int32
// or int64; one instantiation a combination, so no conversion pass).  A
// field spans at most two words, split MSB first as the plain version
// splits it (shift = 32 - w - (offset & 31)), and each part is OR-ed into
// its word with a shared-memory atomicOr; a word past the frame is the sink.
// Fields do not overlap, so the OR is exact and independent of order, and
// the bytes are the same on every run.  The words go out byte by byte, most
// significant first, straight into the uint8 output: no global atomics, no
// temporaries in device memory.  Threads a frame come from K (a warp to
// kThreads), frames a block from what is left of kThreads, and shared
// memory from total_bytes, so every caller's shape runs the one algorithm.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;     // a block's opt-in limit on sm_90
constexpr int kDefaultSmemBytes = 48 * 1024;

template <typename V, typename W, typename O>
__global__ void __launch_bounds__(kThreads) deposit_kernel(
        const V* __restrict__ values, const W* __restrict__ widths,
        const O* __restrict__ offsets, unsigned char* __restrict__ out,
        long long n_frames, int k, int total_bytes, int frame_threads) {
    extern __shared__ unsigned int words[];
    const int n_words = (total_bytes + 3) / 4;
    const int pitch = n_words + 1;                      // the sink word last
    const int frames = blockDim.x / frame_threads;
    const long long f0 = static_cast<long long>(blockIdx.x) * frames;
    for (int i = threadIdx.x; i < frames * pitch; i += blockDim.x) words[i] = 0u;
    __syncthreads();

    const int slot = threadIdx.x / frame_threads;
    const long long f = f0 + slot;
    if (f < n_frames) {
        unsigned int* fw = words + slot * pitch;
        const long long row = f * k;
        for (int j = threadIdx.x % frame_threads; j < k; j += frame_threads) {
            const int w = static_cast<int>(widths[row + j]);
            if (w <= 0) continue;
            const long long off = static_cast<long long>(offsets[row + j]);
            const unsigned int v = static_cast<unsigned int>(values[row + j]);
            const long long w0 = off >> 5;
            const int shift = 32 - w - static_cast<int>(off & 31);
            unsigned int hi, lo = 0u;
            if (shift >= 0) {
                hi = v << shift;
            } else {
                hi = v >> -shift;
                lo = v << (32 + shift);
            }
            // unsigned compares send a word past the frame to the sink
            if (hi) atomicOr(&fw[static_cast<unsigned long long>(w0) < n_words
                                 ? w0 : n_words], hi);
            if (lo) atomicOr(&fw[static_cast<unsigned long long>(w0 + 1) < n_words
                                 ? w0 + 1 : n_words], lo);
        }
    }
    __syncthreads();

    const long long left = n_frames - f0;
    const int n_bytes = static_cast<int>(left < frames ? left : frames) * total_bytes;
    unsigned char* dst = out + f0 * total_bytes;
    for (int i = threadIdx.x; i < n_bytes; i += blockDim.x) {
        const int s = i / total_bytes, b = i - s * total_bytes;
        dst[i] = static_cast<unsigned char>(words[s * pitch + (b >> 2)]
                                            >> (24 - 8 * (b & 3)));
    }
}

template <typename V, typename W, typename O>
cudaError_t launch(const void* values, const void* widths, const void* offsets,
                   unsigned char* out, long long n_frames, int k,
                   int total_bytes, cudaStream_t st) {
    const int frame_bytes = ((total_bytes + 3) / 4 + 1) * 4;
    if (frame_bytes > kMaxSmemBytes) return cudaErrorInvalidValue;
    int frame_threads = (k + 31) / 32 * 32;
    frame_threads = frame_threads < 32 ? 32
                  : frame_threads > kThreads ? kThreads : frame_threads;
    int frames = kThreads / frame_threads;
    if (frames * frame_bytes > kDefaultSmemBytes)
        frames = kDefaultSmemBytes / frame_bytes > 1 ? kDefaultSmemBytes / frame_bytes : 1;
    const int smem = frames * frame_bytes;
    if (smem > kDefaultSmemBytes) {
        const cudaError_t attr = cudaFuncSetAttribute(
            deposit_kernel<V, W, O>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (attr != cudaSuccess) return attr;
    }
    const long long blocks = (n_frames + frames - 1) / frames;
    deposit_kernel<V, W, O><<<static_cast<unsigned>(blocks), frames * frame_threads,
                              smem, st>>>(
        static_cast<const V*>(values), static_cast<const W*>(widths),
        static_cast<const O*>(offsets), out, n_frames, k, total_bytes, frame_threads);
    return cudaGetLastError();
}

template <typename V, typename W>
cudaError_t by_offsets(int offset_bytes, const void* values, const void* widths,
                       const void* offsets, unsigned char* out, long long n_frames,
                       int k, int total_bytes, cudaStream_t st) {
    return offset_bytes == 4
        ? launch<V, W, int>(values, widths, offsets, out, n_frames, k, total_bytes, st)
        : launch<V, W, long long>(values, widths, offsets, out, n_frames, k,
                                  total_bytes, st);
}

template <typename V>
cudaError_t by_widths(int width_bytes, int offset_bytes, const void* values,
                      const void* widths, const void* offsets, unsigned char* out,
                      long long n_frames, int k, int total_bytes, cudaStream_t st) {
    return width_bytes == 4
        ? by_offsets<V, int>(offset_bytes, values, widths, offsets, out, n_frames,
                             k, total_bytes, st)
        : by_offsets<V, long long>(offset_bytes, values, widths, offsets, out,
                                   n_frames, k, total_bytes, st);
}

}  // namespace

// values / widths / offsets [n_frames, k] row-major, each a signed integer
// plane of value_bytes / width_bytes / offset_bytes (4 or 8) an element;
// out [n_frames, total_bytes] uint8, every byte written.
extern "C" int deposit_fields(const void* values, int value_bytes,
                              const void* widths, int width_bytes,
                              const void* offsets, int offset_bytes,
                              unsigned char* out, long long n_frames, int k,
                              int total_bytes, void* stream) {
    const auto plane = [](int b) { return b == 4 || b == 8; };
    if (!plane(value_bytes) || !plane(width_bytes) || !plane(offset_bytes)
            || n_frames < 0 || k < 0 || total_bytes < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_frames == 0 || total_bytes == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(value_bytes == 4
        ? by_widths<int>(width_bytes, offset_bytes, values, widths, offsets, out,
                         n_frames, k, total_bytes, st)
        : by_widths<long long>(width_bytes, offset_bytes, values, widths, offsets,
                               out, n_frames, k, total_bytes, st));
}
