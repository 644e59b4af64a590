// Kernel B: the energy-adjusted (EA) greedy-accept recurrence.
//
// Replaces the Pallas kernel atracdenc_tpu/ops/pallas_greedy.py::
// greedy_scan (_kernel, :32-43).  For each row, over its L candidates in
// |delta|-rank order:
//     ex = (e2 - a_k) + b_k
//     accept_k = elig_k && |ex - e1| < |e2 - e1|;  e2 = accept_k ? ex : e2
// in exactly that float order, so the result is bit-equal to the plain
// version (ops/greedy.py) and to the JAX lax.scan.
//
// Bound: bytes.  Each candidate step is ~7 flops against 10 bytes moved
// (a and b f32, elig and accept one byte each); the recurrence is
// sequential in k, so the parallelism is the rows.
//
// Design: the inputs and the output stay in the caller's row-major
// [rows, L] layout (torch.bool read and written as bytes), so the wrapper
// makes no copy.  A block owns kRows rows, one thread each, and walks L in
// chunks of kChunk candidates.  The block copies a chunk's tiles (kRows x
// kChunk of a and of b, kRows x kChunk bytes of elig) into shared memory
// with 16-byte cp.async copies, neighbouring threads on neighbouring
// pieces of a row, through a ring of kStages stages: kStages - 1 chunks
// are in flight while one is scanned.  The tiles are XOR-swizzled at
// 16-byte granularity so that each thread's 16-byte reads of its own row
// hit distinct banks.  A thread runs its row's recurrence with the carry
// in a register and writes its accept bytes over its elig bytes in the
// tile; the block then stores the tile.  When L is not a multiple of
// kChunk, the same pipeline moves the pieces with scalar loads and stores;
// candidates past L scan as not eligible, which leaves the carry unchanged.
// A 32-candidate chunk is a whole 128-byte line of a row's a and b and a
// whole 32-byte sector of its elig and accept.
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;                   // rows (threads) per block
constexpr int kChunk = 32;                  // candidates per stage
constexpr int kStages = 3;                  // ring of chunk tiles
constexpr int kQuads = kChunk / 4;          // 16-byte pieces of a row's a / b chunk
constexpr int kHalves = kChunk / 16;        // 16-byte pieces of its elig chunk

struct Stage {
    float4 a[kRows * kQuads];               // [row][piece], pieces swizzled
    float4 b[kRows * kQuads];
    uint4 e[kRows * kHalves];               // elig bytes, then accept bytes
};

// Slot of row r's 16-byte piece q among N pieces a row (kQuads or kHalves):
// XOR-swizzled so that the 8 rows of a quarter-warp (one phase of a 16-byte
// shared load) reading their piece q hit the 8 distinct bank groups.
template <int N>
__device__ __forceinline__ int slot(int r, int q) {
    return r * N + (q ^ ((r / (8 / N)) & (N - 1)));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool fill) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(gmem), "r"(fill ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Args {
    const float* a;
    const float* b;
    const unsigned char* elig;
    const float* e1;
    const float* e2;
    float* e2_out;
    unsigned char* accept;
    long long rows;
    int L;
};

// Start the copy of chunk c of the block's rows into stage s (rows past
// the end and candidates past L are zero: not eligible).
template <bool kVec>
__device__ void load_chunk(const Args& p, Stage& s, long long row0, int c) {
    const int t = threadIdx.x;
    const int k0 = c * kChunk;
    if constexpr (kVec) {
#pragma unroll
        for (int i = 0; i < kQuads; ++i) {
            const int piece = t + i * kRows;
            const int r = piece / kQuads, q = piece % kQuads;
            const bool live = row0 + r < p.rows;
            const long long g = live ? (row0 + r) * p.L + k0 + q * 4 : 0;
            cp_async16(&s.a[slot<kQuads>(r, q)], p.a + g, live);
            cp_async16(&s.b[slot<kQuads>(r, q)], p.b + g, live);
        }
#pragma unroll
        for (int i = 0; i < kHalves; ++i) {
            const int piece = t + i * kRows;
            const int r = piece / kHalves, h = piece % kHalves;
            const bool live = row0 + r < p.rows;
            const long long g = live ? (row0 + r) * p.L + k0 + h * 16 : 0;
            cp_async16(&s.e[slot<kHalves>(r, h)], p.elig + g, live);
        }
    } else {
        float* sa = reinterpret_cast<float*>(s.a);
        float* sb = reinterpret_cast<float*>(s.b);
        unsigned char* se = reinterpret_cast<unsigned char*>(s.e);
        for (int i = t; i < kRows * kChunk; i += kRows) {
            const int r = i / kChunk, k = i % kChunk;
            const bool live = row0 + r < p.rows && k0 + k < p.L;
            const long long g = (row0 + r) * p.L + k0 + k;
            const int at = slot<kQuads>(r, k / 4) * 4 + k % 4;
            sa[at] = live ? p.a[g] : 0.0f;
            sb[at] = live ? p.b[g] : 0.0f;
            se[slot<kHalves>(r, k / 16) * 16 + k % 16] = live ? p.elig[g] : 0;
        }
    }
}

// Store the accept bytes of chunk c from stage s.
template <bool kVec>
__device__ void store_chunk(const Args& p, const Stage& s, long long row0, int c) {
    const int t = threadIdx.x;
    const int k0 = c * kChunk;
    if constexpr (kVec) {
#pragma unroll
        for (int i = 0; i < kHalves; ++i) {
            const int piece = t + i * kRows;
            const int r = piece / kHalves, h = piece % kHalves;
            if (row0 + r < p.rows)
                *reinterpret_cast<uint4*>(p.accept + (row0 + r) * p.L + k0 + h * 16) =
                    s.e[slot<kHalves>(r, h)];
        }
    } else {
        const unsigned char* se = reinterpret_cast<const unsigned char*>(s.e);
        for (int i = t; i < kRows * kChunk; i += kRows) {
            const int r = i / kChunk, k = i % kChunk;
            if (row0 + r < p.rows && k0 + k < p.L)
                p.accept[(row0 + r) * p.L + k0 + k] =
                    se[slot<kHalves>(r, k / 16) * 16 + k % 16];
        }
    }
}

__device__ __forceinline__ unsigned step(float& cur, float t, float a, float b,
                                         unsigned el) {
    const float ex = (cur - a) + b;
    const bool acc = el != 0u && fabsf(ex - t) < fabsf(cur - t);
    cur = acc ? ex : cur;
    return acc ? 1u : 0u;
}

// Thread r's row through one chunk: accept bytes replace the elig bytes.
__device__ __forceinline__ void scan_chunk(Stage& s, int r, float t, float& cur) {
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
        const uint4 ev = s.e[slot<kHalves>(r, h)];
        const unsigned el[4] = {ev.x, ev.y, ev.z, ev.w};
        unsigned acc[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float4 av = s.a[slot<kQuads>(r, 4 * h + j)];
            const float4 bv = s.b[slot<kQuads>(r, 4 * h + j)];
            const unsigned w = el[j];
            // one statement per step, so the steps run in order
            unsigned x = step(cur, t, av.x, bv.x, w & 0xffu);
            x |= step(cur, t, av.y, bv.y, (w >> 8) & 0xffu) << 8;
            x |= step(cur, t, av.z, bv.z, (w >> 16) & 0xffu) << 16;
            x |= step(cur, t, av.w, bv.w, w >> 24) << 24;
            acc[j] = x;
        }
        s.e[slot<kHalves>(r, h)] = make_uint4(acc[0], acc[1], acc[2], acc[3]);
    }
}

template <bool kVec>
__global__ void __launch_bounds__(kRows) greedy_scan_kernel(Args p) {
    extern __shared__ uint4 smem[];
    Stage* stage = reinterpret_cast<Stage*>(smem);
    const int t = threadIdx.x;
    const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
    const bool live = row0 + t < p.rows;
    const float e1 = live ? p.e1[row0 + t] : 0.0f;
    float cur = live ? p.e2[row0 + t] : 0.0f;
    const int chunks = (p.L + kChunk - 1) / kChunk;

    for (int c = 0; c < kStages - 1; ++c) {
        if (c < chunks) load_chunk<kVec>(p, stage[c], row0, c);
        cp_async_commit();
    }
    for (int c = 0; c < chunks; ++c) {
        cp_async_wait<kStages - 2>();        // chunk c landed (this thread's copies)
        __syncthreads();                     // ... all threads'; iteration c-1 done
        const int next = c + kStages - 1;    // into the stage that c-1 freed
        if (next < chunks) load_chunk<kVec>(p, stage[next % kStages], row0, next);
        cp_async_commit();
        Stage& s = stage[c % kStages];
        scan_chunk(s, t, e1, cur);
        __syncthreads();                     // chunk c's accept bytes written
        store_chunk<kVec>(p, s, row0, c);
    }
    if (live) p.e2_out[row0 + t] = cur;
}

template <bool kVec>
cudaError_t launch(const Args& p, cudaStream_t st) {
    constexpr int bytes = kStages * static_cast<int>(sizeof(Stage));
    static const cudaError_t attr = cudaFuncSetAttribute(
        greedy_scan_kernel<kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return attr;
    const long long blocks = (p.rows + kRows - 1) / kRows;
    greedy_scan_kernel<kVec><<<static_cast<unsigned>(blocks), kRows, bytes, st>>>(p);
    return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a block (the stage ring), which ptxas does not
// count.
extern "C" int atrac3_greedy_smem_bytes() {
    return kStages * static_cast<int>(sizeof(Stage));
}

// a, b [rows, L] f32; elig [rows, L] bool (bytes); e1, e2 [rows] f32;
// e2_out [rows] f32; accept [rows, L] bool (bytes).  All row-major and
// 16-byte aligned (the wrapper checks), so when L is a multiple of kChunk
// every row's chunk starts on a 16-byte boundary.
extern "C" int atrac3_greedy_scan(const float* a, const float* b,
                                  const unsigned char* elig, const float* e1,
                                  const float* e2, float* e2_out,
                                  unsigned char* accept, int rows, int L,
                                  void* stream) {
    if (rows <= 0 || L <= 0) return 0;
    const Args p{a, b, elig, e1, e2, e2_out, accept, rows, L};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(L % kChunk == 0 ? launch<true>(p, st)
                                            : launch<false>(p, st));
}
