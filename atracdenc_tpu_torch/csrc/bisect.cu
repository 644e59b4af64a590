// Kernel F: one ATRAC3 lambda bisection at a fixed num_bfu.
//
// Replaces the Pallas kernel atracdenc_tpu/ops/pallas_alloc.py::
// bisect_block (_kernel :137-159, _eval_alloc :41-134, _run_bisection
// :162-184): per channel-frame, the 11-step lambda bisection over [-8, 20]
// at the given num_bfu, then the allocation at the chosen lambda (trunc
// allocation, tonal-BFU discount, energy boost).  The result equals kernel
// C's wordlens with the BFU shrink off (auto=0) and the plain version,
// models/atrac3/bitalloc.py::_bisect.
//
// Bound: latency, as kernel C (12 evaluations of a branchy per-frame loop
// over ~3 KiB of memo read from L2 / L1).  Design: kernel C's, one thread
// per channel-frame on the frame-minor layout, with its evaluation and
// bisection taken from rate_eval.cuh.
#include "rate_eval.cuh"

namespace {

__global__ void bisect_kernel(Inputs in, const int* __restrict__ num_bfu_in,
                              const int* __restrict__ t_active,
                              const int* __restrict__ t_pos,
                              const int* __restrict__ t_len,
                              const int* __restrict__ t_bfu,
                              int* __restrict__ wl_out) {
    const long long f = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long n = in.n;
    if (f >= n) return;

    const Tonal tn = load_tonal(t_active, t_pos, t_len, t_bfu, f, n);
    const int nb = num_bfu_in[f];
    int wl[kBfus];
    bool mode;
    const float last_l = bisect_lambda(in, tn, f, nb, in.target[f], wl);
    eval_alloc(in, tn, f, last_l, nb, wl, &mode);
    for (int k = 0; k < kBfus; ++k) wl_out[k * n + f] = wl[k];
}

}  // namespace

// The arguments of atrac3_rate_control without its num_bfu / mode outputs
// and its auto flag: frame-minor planes [32, n], [32, 8, n] and [n];
// wl_out [32, n].
extern "C" int atrac3_bisect(
        const float* csfi, const unsigned char* gated, const int* tcounts,
        const float* spread, const int* target, const int* num_bfu,
        const float* err, const int* clc, const int* vlc,
        const int* t_active, const int* t_pos, const int* t_len,
        const int* t_bfu, const int* t_vlc, const float* fix,
        const float* xdiv, int* wl_out, int n, void* stream) {
    if (n <= 0) return 0;
    Inputs in{csfi, gated, tcounts, spread, target, err, clc, vlc, t_vlc,
              fix, xdiv, static_cast<long long>(n)};
    const int threads = 128;
    bisect_kernel<<<(n + threads - 1) / threads, threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        in, num_bfu, t_active, t_pos, t_len, t_bfu, wl_out);
    return static_cast<int>(cudaGetLastError());
}
