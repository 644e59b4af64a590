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
// Bound: latency, as kernel C (11 evaluations of a branchy per-frame loop
// over ~5 KiB of inputs).  Design: kernel C's first round with no shrink,
// on the same device code (rate_eval.cuh): one warp per channel-frame on
// the frame-major planes, the memo staged in shared memory.
#include "rate_eval.cuh"

namespace {

__global__ void __launch_bounds__(kWarps * 32)
bisect_kernel(Inputs in, int* __restrict__ wl_out) {
    __shared__ Memo memo[kWarps];
    const long long f = warp_frame(in.n);
    if (f < 0) return;                       // the whole warp
    const int k = threadIdx.x % 32;
    Memo& m = memo[threadIdx.x / 32];
    const Lane ln = load_frame(in, f, k, m);
    const int nb = in.num_bfu[f];
    int w;
    bool mode;
    bisect_alloc(ln, m, k, nb, in.target[f], &w, &mode);
    wl_out[f * kBfus + k] = w;
}

}  // namespace

// The arguments of atrac3_rate_control without its num_bfu / mode outputs
// and its auto flag: frame-major planes [n, 32], [n, 32, 8] and [n];
// wl_out [n, 32].
extern "C" int atrac3_bisect(
        const float* csfi, const unsigned char* gated, const int* tcounts,
        const float* spread, const int* target, const int* num_bfu,
        const float* err, const int* clc, const int* vlc,
        const int* t_active, const int* t_pos, const int* t_len,
        const int* t_bfu, const int* t_vlc, const float* fix,
        const float* xdiv, int* wl_out, int n, int clc_stride, void* stream) {
    if (n <= 0) return 0;
    const Inputs in{csfi, gated, tcounts, spread, target, num_bfu, err, clc,
                    vlc, t_active, t_pos, t_len, t_bfu, t_vlc, fix, xdiv,
                    static_cast<long long>(n), clc_stride};
    bisect_kernel<<<frame_blocks(n), kWarps * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(in, wl_out);
    return static_cast<int>(cudaGetLastError());
}
