// Kernel C: the whole ATRAC3 rate-control loop, one warp per channel-frame.
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
// Bound: latency of a long, branchy per-frame computation (~11 evaluations
// of 32 BFUs x (3 lookups + a few compares) plus the tonal pair test per
// shrink round); the inputs (~5 KiB a frame) are read once.  Design: one
// warp per channel-frame, lane k on BFU k, reading the encoder's
// frame-major planes as they are (coalesced 128-byte rows) and writing wl
// [n, 32] directly; the frame's clc / vlc / tonal VLC planes are staged in
// shared memory once and its err row becomes a per-lane boost table, both
// reused by its ~45 evaluations; the sums are warp reductions and the
// tonal pair test is one __match_any_sync on precomputed peer masks.  The
// evaluation and the bisection are rate_eval.cuh's, shared with kernel F
// (bisect.cu).
#include "rate_eval.cuh"

namespace {

__global__ void __launch_bounds__(kWarps * 32)
rate_control_kernel(Inputs in, int* __restrict__ wl_out,
                    int* __restrict__ num_bfu_out,
                    unsigned char* __restrict__ mode_out, int auto_shrink) {
    __shared__ Memo memo[kWarps];
    const long long f = warp_frame(in.n);
    if (f < 0) return;                       // the whole warp
    const int k = threadIdx.x % 32;
    Memo& m = memo[threadIdx.x / 32];
    const Lane ln = load_frame(in, f, k, m);
    const int target = in.target[f];

    int nb = in.num_bfu[f];
    int w;
    bool mode;
    while (true) {
        bisect_alloc(ln, m, k, nb, target, &w, &mode);
        if (auto_shrink && nb > 1 && __shfl_sync(kAll, w, nb - 1) == 0) {
            nb -= 1;
            continue;
        }
        break;
    }
    wl_out[f * kBfus + k] = w;
    if (k == 0) {
        num_bfu_out[f] = nb;
        mode_out[f] = mode ? 1 : 0;
    }
}

}  // namespace

// Frame-major planes as the encoder makes them: per-BFU [n, 32], memo
// [n, 32, 8] (clc with clc_stride 0 is one [32, 8] table for every frame),
// per-frame scalars [n]; fix / xdiv are the [32] f32 tables
// FIXED_BIT_ALLOC and SFI_DIVISOR.  Outputs wl [n, 32], num_bfu [n], mode
// [n] (bool bytes).
extern "C" int atrac3_rate_control(
        const float* csfi, const unsigned char* gated, const int* tcounts,
        const float* spread, const int* target, const int* num_bfu,
        const float* err, const int* clc, const int* vlc,
        const int* t_active, const int* t_pos, const int* t_len,
        const int* t_bfu, const int* t_vlc, const float* fix,
        const float* xdiv, int* wl_out, int* num_bfu_out,
        unsigned char* mode_out, int n, int clc_stride, int auto_shrink,
        void* stream) {
    if (n <= 0) return 0;
    const Inputs in{csfi, gated, tcounts, spread, target, num_bfu, err, clc,
                    vlc, t_active, t_pos, t_len, t_bfu, t_vlc, fix, xdiv,
                    static_cast<long long>(n), clc_stride};
    rate_control_kernel<<<frame_blocks(n), kWarps * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        in, wl_out, num_bfu_out, mode_out, auto_shrink);
    return static_cast<int>(cudaGetLastError());
}
