// Kernel C: the whole ATRAC3 rate-control loop, one thread per channel-frame.
//
// Replaces the Pallas kernel atracdenc_tpu/ops/pallas_rate.py::
// rate_control_block (_kernel :184-238, _eval_alloc :56-157,
// _run_bisection :160-181).  Per channel-frame:
//   * an 11-step lambda bisection over [-8, 20] (+-0.01 shrink, keep the
//     last lambda under budget);
//   * each evaluation: the trunc allocation from csfi / spread / the fixed
//     table, the tonal-BFU discount, the ConsiderEnergyErr boost (<= 6
//     bumps), the CLC-vs-VLC spectrum cost, and the closed-form tonal
//     dry-run (atracdenc_tpu/models/atrac3/tonal.py::make_cost_fn);
//   * the BFU-shrink loop (CheckBfus -> Repeat) while the last used BFU
//     got no bits (auto mode only; auto=0 is --bfuidxconst).
// Every float op is elementwise, in the plain version's order (built with
// -fmad=false), and every sum is an integer sum, so the result is bit-equal
// to the plain version (models/atrac3/bitalloc.py).
//
// Bound: latency of a long, branchy per-frame computation (~12 evaluations
// of ~32 BFUs x (3 loads + a few compares) plus a <=21x21 tonal pair loop
// per shrink round); the memo inputs (~3 KiB per frame) are read from L2 /
// L1 many times.  Design: one thread per channel-frame (tens of thousands
// on the main path fill the card), inputs in the frame-minor layout
// ([32, N], [32, 8, N]) so that a warp's 32 frames read 32 consecutive
// words at every access; the per-frame wordlens and tonal planes stay in
// the thread's registers / local memory.  The evaluation and the
// bisection are rate_eval.cuh's, shared with kernel F (bisect.cu).
#include "rate_eval.cuh"

namespace {

__global__ void rate_control_kernel(Inputs in, const int* __restrict__ num_bfu_in,
                                    const int* __restrict__ t_active,
                                    const int* __restrict__ t_pos,
                                    const int* __restrict__ t_len,
                                    const int* __restrict__ t_bfu,
                                    int* __restrict__ wl_out,
                                    int* __restrict__ num_bfu_out,
                                    unsigned char* __restrict__ mode_out,
                                    int auto_shrink) {
    const long long f = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const long long n = in.n;
    if (f >= n) return;

    const Tonal tn = load_tonal(t_active, t_pos, t_len, t_bfu, f, n);
    const int target = in.target[f];

    int nb = num_bfu_in[f];
    int wl[kBfus];
    bool mode = false;
    while (true) {
        const float last_l = bisect_lambda(in, tn, f, nb, target, wl);
        eval_alloc(in, tn, f, last_l, nb, wl, &mode);
        if (auto_shrink && nb > 1 && wl[nb - 1] == 0) {
            nb -= 1;
            continue;
        }
        break;
    }
    for (int k = 0; k < kBfus; ++k) wl_out[k * n + f] = wl[k];
    num_bfu_out[f] = nb;
    mode_out[f] = mode ? 1 : 0;
}

}  // namespace

// Frame-minor layout throughout: per-BFU planes [32, n], memo planes
// [32, 8, n], per-frame scalars [n].  fix / xdiv are the [32] f32 tables
// FIXED_BIT_ALLOC and SFI_DIVISOR.
extern "C" int atrac3_rate_control(
        const float* csfi, const unsigned char* gated, const int* tcounts,
        const float* spread, const int* target, const int* num_bfu,
        const float* err, const int* clc, const int* vlc,
        const int* t_active, const int* t_pos, const int* t_len,
        const int* t_bfu, const int* t_vlc, const float* fix,
        const float* xdiv, int* wl_out, int* num_bfu_out,
        unsigned char* mode_out, int n, int auto_shrink, void* stream) {
    if (n <= 0) return 0;
    Inputs in{csfi, gated, tcounts, spread, target, err, clc, vlc, t_vlc,
              fix, xdiv, static_cast<long long>(n)};
    const int threads = 128;
    rate_control_kernel<<<(n + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        in, num_bfu, t_active, t_pos, t_len, t_bfu, wl_out, num_bfu_out,
        mode_out, auto_shrink);
    return static_cast<int>(cudaGetLastError());
}
