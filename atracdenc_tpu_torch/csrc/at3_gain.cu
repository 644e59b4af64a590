// Kernel J: ATRAC3 gain control's spectral upsampler and AnalyzeGain, for
// every (channel, frame, band) window of a chunk in one launch.
//
// Replaces no TPU kernel.  The JAX package runs the upsampler as XLA
// matmuls (atracdenc_tpu/models/atrac3/gain.py upsample_region: the
// 512-sample window times a [512, 2048] region matrix and two [512, 514]
// spectrum matrices) and AnalyzeGain as tensor ops on the 2,048-sample
// region; its plain PyTorch port (models/atrac3/gain.py gain_analysis_torch)
// does the same, and writes the region (8 KiB a window) to device memory
// and reads it back.  This kernel computes, for window w:
//   region = x @ M                            x the window's 512 samples
//   gain[w][s]  = sqrt(sum of region[64 s .. 64 s + 63]^2 / 64)
//   micro[s][i] = sqrt(sum of region[64 s + 8 i .. + 7]^2 / 8)
//   lo[w][s], hi[w][s] = ranks 2 and 6 of micro[s] (the 19-comparator
//                        network of AnalyzeGain's quartiles)
//   sp = x @ E,  hfr[w] = sum (sp h)^2 / sum sp^2   (0 where the sum is 0)
// with h the high-pass response (0, 0.5 or 1 a bin, so sp h is exact and
// the plain version's second product x @ (E h) is not needed), and writes
// only gain, lo, hi and hfr.  E's two all-zero columns (the imaginary parts
// of DC and Nyquist) are left out, so M and E make ten N-tiles of 256
// columns: eight of the region (each four subframes) and two of spectrum.
//
// The window is read straight from the band samples: its first 128 samples
// are the previous frame's last 128 (prev_tail at the chunk's first frame),
// then the frame's 256, then the next frame's first 128 (next_head at the
// chunk's last frame, zeros when there is none).
//
// Bound: operations.  512 x 2,560 multiply-adds a window, 2.62 MFLOP; at
// 262,144 windows (one 64 x 512-frame stereo call) 687.8 GFLOP, 10.27 ms at
// 67 TFLOP/s.  Its bytes (the band samples once, 97 floats out a window)
// take ~0.1 ms at 3.35 TB/s.
// Design: a persistent block per SM walks work units of (64 windows, five
// N-tiles); the units' windows stay in shared memory (128 KiB, rows padded
// so that the four window rows a warp reads fall in distinct banks) and
// the packed matrices (5.2 MB, L2-resident) stream through a three-stage
// cp.async ring of 32-row K-slabs (windows and ring fill the 227 KiB a
// block may have; 16-row slabs in four stages, with twice the barriers,
// ran 7% slower at the cell's shape).  Each of the 256 threads holds 8
// windows x 8 consecutive columns (one micro-chunk) in registers: per K
// step 4 conflict-free 16-byte shared loads (the host permutes each
// N-tile's columns so that a warp's loads are contiguous) feed 64
// multiply-adds, each one __fmaf_rn (one rounding a MAC, as a cuBLAS f32
// GEMM; the build's -fmad=false keeps the epilogue's squares and sums
// unfused, as in the plain version).  The epilogue of a region N-tile
// squares and sums each micro-chunk, gathers a subframe's 8 micro sums
// across the 8 lanes that hold them, and lane i writes window i's gain, lo
// and hi; the spectrum N-tiles add their squares into per-window sums in
// registers, reduced across lanes and warps once a unit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kK = 512;                       // samples a window
constexpr int kMT = 64;                       // windows a unit
constexpr int kNT = 256;                      // columns an N-tile
constexpr int kKS = 32;                       // rows a K-slab
constexpr int kStages = 3;                    // K-slabs in the ring
constexpr int kLdA = kK + 4;                  // a window's row in shared memory
constexpr int kRegionTiles = 8;               // 2,048 region columns
constexpr int kTiles = 10;                    // + 512 spectrum columns
constexpr int kUnitTiles = 5;                 // N-tiles a unit
constexpr int kSplit = kTiles / kUnitTiles;   // units a window tile
constexpr int kSlabsPerTile = kK / kKS;
constexpr int kSlabsPerUnit = kUnitTiles * kSlabsPerTile;
constexpr int kChunks = kK / 4;               // 16-byte chunks a window
constexpr int kSmemFloats = kMT * kLdA + kStages * kKS * kNT + 2 * 4 * kMT;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(kSmemBytes <= 232448, "more shared memory than a block may have");

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? 16 : 0;             // 0: the 16 bytes are zero-filled
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The 64 windows of unit tile `tile` into As (rows past n_windows zeroed).
__device__ __forceinline__ void load_windows(
        float* As, const float* bands, const float* prev_tail,
        const float* next_head, long long tile, int frames,
        long long n_windows) {
    for (int q = threadIdx.x; q < kMT * kChunks; q += kThreads) {
        const int m = q / kChunks, k = 4 * (q % kChunks);
        const long long w = tile * kMT + m;
        const float* src = bands;
        bool ok = false;
        if (w < n_windows) {
            const long long cf = w >> 2;          // channel * frames + frame
            const int b = static_cast<int>(w & 3);
            const int f = static_cast<int>(cf % frames);
            const long long c = cf / frames;
            if (k < 128) {
                src = f > 0 ? bands + ((cf - 1) * 4 + b) * 256 + 128 + k
                            : prev_tail + (c * 4 + b) * 128 + k;
                ok = true;
            } else if (k < 384) {
                src = bands + (cf * 4 + b) * 256 + (k - 128);
                ok = true;
            } else if (f < frames - 1) {
                src = bands + ((cf + 1) * 4 + b) * 256 + (k - 384);
                ok = true;
            } else if (next_head != nullptr) {
                src = next_head + (c * 4 + b) * 128 + (k - 384);
                ok = true;
            }
        }
        cp_async16(As + m * kLdA + k, ok ? src : bands, ok);
    }
}

// K-slab `ks` of N-tile `nt` ([kTiles][kK][kNT], each slab contiguous).
__device__ __forceinline__ void load_slab(float* Bs, const float* tiles, int nt,
                                          int ks) {
    const float* src = tiles + (static_cast<long long>(nt) * kK + ks * kKS) * kNT;
#pragma unroll
    for (int r = 0; r < kKS * kNT / 4 / kThreads; ++r) {
        const int q = threadIdx.x + r * kThreads;
        cp_async16(Bs + 4 * q, src + 4 * q, true);
    }
}

__global__ void __launch_bounds__(kThreads, 1)
gain_kernel(const float* __restrict__ bands, const float* __restrict__ prev_tail,
            const float* __restrict__ next_head, const float* __restrict__ tiles,
            const float* __restrict__ hcol, float* __restrict__ gain,
            float* __restrict__ lo, float* __restrict__ hi,
            float* __restrict__ hfr, int frames, long long n_windows,
            long long n_units) {
    extern __shared__ float4 smem4[];
    float* As = reinterpret_cast<float*>(smem4);
    float* Bs = As + kMT * kLdA;
    float* red = Bs + kStages * kKS * kNT;        // [2][4 warps along N][kMT]

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int lm = lane >> 3, ln = lane & 7;
    const int wm = warp >> 2, wn = warp & 3;
    const int tm = wm * 4 + lm;                   // windows tm + 8 i
    const int tn = wn * 8 + ln;                   // columns 8 tn .. 8 tn + 7

    const long long first = blockIdx.x;
    if (first >= n_units) return;
    const long long n_mine = (n_units - first + gridDim.x - 1) / gridDim.x;
    const long long n_slabs = n_mine * kSlabsPerUnit;
    auto unit_of = [&](long long i) { return first + i * gridDim.x; };
    auto tile_of_slab = [&](long long j) {
        const long long u = unit_of(j / kSlabsPerUnit);
        return static_cast<int>((u % kSplit) * kUnitTiles
                                + (j % kSlabsPerUnit) / kSlabsPerTile);
    };

    load_windows(As, bands, prev_tail, next_head, unit_of(0) / kSplit, frames,
                 n_windows);
    cp_commit();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_slabs)
            load_slab(Bs + s * kKS * kNT, tiles, tile_of_slab(s),
                      s % kSlabsPerTile);
        cp_commit();
    }

    float acc[8][8];
    float tot[8], fil[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        tot[i] = 0.f;
        fil[i] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }

    for (long long j = 0; j < n_slabs; ++j) {
        cp_wait<kStages - 2>();
        __syncthreads();
        {
            const long long nxt = j + kStages - 1;
            if (nxt < n_slabs)
                load_slab(Bs + (nxt % kStages) * kKS * kNT, tiles,
                          tile_of_slab(nxt), static_cast<int>(nxt % kSlabsPerTile));
            cp_commit();
        }
        const int ks = static_cast<int>(j % kSlabsPerTile);
        const float* Bst = Bs + (j % kStages) * kKS * kNT;
        const float* Ar = As + tm * kLdA + ks * kKS;
#pragma unroll
        for (int k4 = 0; k4 < kKS; k4 += 4) {
            float4 a[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                a[i] = *reinterpret_cast<const float4*>(Ar + 8 * i * kLdA + k4);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
                const float* br = Bst + (k4 + kk) * kNT;
                const float4 b0 = *reinterpret_cast<const float4*>(br + 4 * tn);
                const float4 b1 = *reinterpret_cast<const float4*>(br + 128 + 4 * tn);
                const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const float av = lane_of(a[i], kk);
#pragma unroll
                    for (int c = 0; c < 8; ++c)
                        acc[i][c] = __fmaf_rn(av, b[c], acc[i][c]);
                }
            }
        }
        if (ks != kSlabsPerTile - 1) continue;

        // --- epilogue of N-tile nt: 64 windows x 256 columns done
        const int nt = tile_of_slab(j);
        const long long tile = unit_of(j / kSlabsPerUnit) / kSplit;
        if (nt < kRegionTiles) {
            // this thread: micro-chunk ln of subframe 4 nt + wn, 8 windows
            float s[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                float v = 0.f;
#pragma unroll
                for (int c = 0; c < 8; ++c) v += acc[i][c] * acc[i][c];
                s[i] = v;
            }
            // lane ln gathers window ln's 8 micro sums from its row's lanes
            float mine[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
                for (int src = 0; src < 8; ++src) {
                    const float v = __shfl_sync(0xffffffffu, s[i], (lane & ~7) | src);
                    if (i == ln) mine[src] = v;
                }
            }
            float sum = 0.f;
            float xs[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                sum += mine[i];
                xs[i] = sqrtf(mine[i] / 8.f);
            }
            // Batcher's odd-even merge network for 8 (models/atrac3/gain.py _NET8)
#define CX(p, q) { const float u = fminf(xs[p], xs[q]); xs[q] = fmaxf(xs[p], xs[q]); xs[p] = u; }
            CX(0, 1) CX(2, 3) CX(4, 5) CX(6, 7)
            CX(0, 2) CX(1, 3) CX(4, 6) CX(5, 7)
            CX(1, 2) CX(5, 6)
            CX(0, 4) CX(1, 5) CX(2, 6) CX(3, 7)
            CX(2, 4) CX(3, 5)
            CX(1, 2) CX(3, 4) CX(5, 6)
#undef CX
            const long long w = tile * kMT + tm + 8 * ln;
            if (w < n_windows) {
                const long long o = w * 32 + nt * 4 + wn;
                gain[o] = sqrtf(sum / 64.f);
                lo[o] = xs[2];
                hi[o] = xs[6];
            }
        } else {
            float h[8];
#pragma unroll
            for (int c = 0; c < 8; ++c) h[c] = hcol[(nt - kRegionTiles) * kNT + 8 * tn + c];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
#pragma unroll
                for (int c = 0; c < 8; ++c) {
                    const float v = acc[i][c];
                    const float p = v * h[c];
                    tot[i] += v * v;
                    fil[i] += p * p;
                }
            }
            if (nt == kTiles - 1) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
#pragma unroll
                    for (int d = 1; d < 8; d <<= 1) {
                        tot[i] += __shfl_xor_sync(0xffffffffu, tot[i], d);
                        fil[i] += __shfl_xor_sync(0xffffffffu, fil[i], d);
                    }
                    if (ln == 0) {
                        red[wn * kMT + tm + 8 * i] = tot[i];
                        red[(4 + wn) * kMT + tm + 8 * i] = fil[i];
                    }
                    tot[i] = 0.f;
                    fil[i] = 0.f;
                }
                __syncthreads();
                if (threadIdx.x < kMT) {
                    const int m = threadIdx.x;
                    const float t = red[m] + red[kMT + m] + red[2 * kMT + m]
                        + red[3 * kMT + m];
                    const float f = red[4 * kMT + m] + red[5 * kMT + m]
                        + red[6 * kMT + m] + red[7 * kMT + m];
                    const long long w = tile * kMT + m;
                    if (w < n_windows) hfr[w] = t > 0.f ? f / t : 0.f;
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

        // the next unit's windows, once every thread is done with these
        if (j % kSlabsPerUnit == kSlabsPerUnit - 1 && j + 1 < n_slabs) {
            __syncthreads();
            load_windows(As, bands, prev_tail, next_head,
                         unit_of(j / kSlabsPerUnit + 1) / kSplit, frames,
                         n_windows);
            cp_commit();
            cp_wait<0>();
            __syncthreads();
        }
    }
    cp_wait<0>();
}

}  // namespace

// bands [channels, frames, 4, 256], prev_tail and next_head [channels, 4,
// 128] f32 (next_head may be null: zeros), all 16-byte aligned; tiles the
// [10][512][256] packed matrices and hcol the 512 spectrum columns' h
// (models/atrac3/gain.py _kernel_consts_np); gain, lo and hi [channels,
// frames, 4, 32] and hfr [channels, frames, 4], every element written.
extern "C" int at3_gain_analysis(const void* bands, const void* prev_tail,
                                 const void* next_head, const void* tiles,
                                 const void* hcol, void* gain, void* lo,
                                 void* hi, void* hfr, int channels, int frames,
                                 void* stream) {
    if (channels < 0 || frames < 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long n_windows = 4LL * channels * frames;
    if (n_windows == 0) return 0;
    const long long n_units = kSplit * ((n_windows + kMT - 1) / kMT);
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(gain_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long blocks = n_units < sms ? n_units : sms;
    gain_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(bands), static_cast<const float*>(prev_tail),
        static_cast<const float*>(next_head), static_cast<const float*>(tiles),
        static_cast<const float*>(hcol), static_cast<float*>(gain),
        static_cast<float*>(lo), static_cast<float*>(hi),
        static_cast<float*>(hfr), frames, n_windows, n_units);
    return static_cast<int>(cudaGetLastError());
}
