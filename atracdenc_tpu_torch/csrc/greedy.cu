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
// Bound: the recurrence is sequential in k, so the parallelism is the rows
// (tens of thousands per call on the main path); the work is ~6 flops per
// 9 bytes read, i.e. memory bandwidth.  Design: one thread per row with the
// carry in a register, inputs in the [L, rows] transposed layout, so at
// every step k neighbouring threads read neighbouring addresses (coalesced),
// as the TPU kernel put rows on the lane axis.
#include <cuda_runtime.h>

namespace {

__global__ void greedy_scan_kernel(const float* __restrict__ a,
                                   const float* __restrict__ b,
                                   const unsigned char* __restrict__ elig,
                                   const float* __restrict__ e1,
                                   const float* __restrict__ e2,
                                   float* __restrict__ e2_out,
                                   unsigned char* __restrict__ accept,
                                   int rows, int L) {
    const int r = blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= rows) return;
    const float t = e1[r];
    float cur = e2[r];
    for (int k = 0; k < L; ++k) {
        const long long i = static_cast<long long>(k) * rows + r;
        const float ex = (cur - a[i]) + b[i];
        const bool acc = elig[i] != 0 && fabsf(ex - t) < fabsf(cur - t);
        if (acc) cur = ex;
        accept[i] = acc ? 1 : 0;
    }
    e2_out[r] = cur;
}

}  // namespace

// a, b [L, rows] f32; elig [L, rows] u8; e1, e2 [rows] f32;
// e2_out [rows] f32; accept [L, rows] u8.
extern "C" int atrac3_greedy_scan(const float* a, const float* b,
                                  const unsigned char* elig, const float* e1,
                                  const float* e2, float* e2_out,
                                  unsigned char* accept, int rows, int L,
                                  void* stream) {
    if (rows <= 0) return 0;
    const int threads = 128;
    greedy_scan_kernel<<<(rows + threads - 1) / threads, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        a, b, elig, e1, e2, e2_out, accept, rows, L);
    return static_cast<int>(cudaGetLastError());
}
