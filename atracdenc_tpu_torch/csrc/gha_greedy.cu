// Kernel H: ATRAC3+ GHA's greedy rounds, over only the lanes still searching.
//
// Replaces no TPU kernel.  The JAX package's greedy is XLA
// (atracdenc_tpu/models/atrac3p/gha.py:160 _greedy); its plain PyTorch port
// (models/atrac3p/gha.py::_greedy) runs each of its 8 rounds on every lane
// as two [L, 128] x [128, 1024] f32 GEMMs and ~85 element-wise launches over
// [L, 1024] planes, although a lane stops at its first failed gate and most
// lanes stop after one or two rounds.  This kernel is one round: for each
// listed lane, the zero-padded 2048-point spectrum at bins 0..1023, mag2 and
// its first-index argmax (bin 0 takes part with value 0), the amplitude and
// phase and their quantisation, the tone, its energies, the five gates, the
// accept and the residual update.  No [L, 1024] value reaches device memory.
//
// Semantics (equal to the plain version's, lane by lane):
//   x   = the lane's samples below fit_len, zeros above (round 0: the input;
//         later rounds: its residual in x_work, written when it accepted);
//   re  = sum_n x[n] dft_c[n, k];  im = -sum_n x[n] dft_s[n, k];
//   b   = argmax_k (k == 0 ? 0 : re*re + im*im);
//   amp = 2 sqrt(re_b^2 + im_b^2) / max(fit_len, 1);
//   phi_steps = remainder((atan2(im_b, re_b) + pi/2) * 2048/(2 pi), 2048);
//   sf  = clamp(floor(4 log2(max(amp, 1e-20)) + 3), 0, 63), amp_q = ladder[sf];
//   ph  = rint(phi_steps / 64) & 31;
//   tone[n] = n < fit_len ? amp_q * tone_sin[((ph << 6) + n b) & 2047] : 0;
//   accept = sum (x - tone)^2 < 0.9 sum x^2  &&  amp^2 > sb_ath
//            && amp > max_amp / 10  &&  |b - freq_j| >= 20 for every accepted j
//            (k < max_keep holds for every listed lane).
// Each expression is the plain version's f32 expression in its order (the
// library is built with -fmad=false; max_amp / 10 is max_amp * (1 / 10) as
// PyTorch's CUDA division by a scalar computes it); ``tone_sin`` and
// ``ladder`` are the plain version's own sin and 2^((sf-3)/4) values,
// computed by PyTorch on the device.  Only the DFT's summation order (n
// ascending, one fused multiply-add a term) and that of the two energies
// (a warp's butterfly) differ from cuBLAS's and PyTorch's.
//
// Bound: f32 FMAs, 524,288 FLOP a lane-round (128 x 1024 x 2 multiply-adds)
// at 67 TFLOP/s; the bytes (a lane's 512 B in, 512 B out when it accepts;
// the 1 MiB of tables stay in L2) are under 1% of that.
// Design: a block takes a tile of kTile listed lanes and puts their samples
// in shared memory, sample-major, so that a warp's eight lanes at sample n
// are two 16-byte broadcasts.  It walks the bins in chunks of kChunk; each
// thread keeps a register micro-tile of 8 lanes x 4 bins of re and of im.
// The cos and sin tables stream from L2 through a double-buffered ring of
// kStep-sample stages, copied with 16-byte cp.async.  After a chunk the
// thread forms mag2 for its 32 cells, keeps its per-lane (value, first bin),
// and a warp butterfly brings each lane's chunk maximum to every thread;
// thread l of the warp keeps lane l's running maximum across chunks, ties
// to the lower bin.  The warp then runs its lanes' epilogue, 4 samples a
// thread.  Survivors of the round (accepted, with another round left under
// max_keep) are appended to the next round's list with one atomicAdd a
// block; the list's order does not matter, because a lane's arithmetic does
// not depend on its slot, so the planes are the same on every run.  The
// grid is sized from L on the host; a block whose tile starts at or past
// the round's count (on the device) returns at once: no host sync.
#include <cuda_runtime.h>

namespace {

constexpr int kSamples = 128;            // a lane's samples
constexpr int kBins = 1024;              // bins 0..1023 of the 2048-point grid
constexpr int kWaves = 8;                // rounds (MAX_WAVES)
constexpr int kMinDist = 20;             // MIN_FREQ_DIST
constexpr int kThreads = 256;
constexpr int kWarpLanes = 8;            // lanes a warp
constexpr int kTile = kThreads / 32 * kWarpLanes;   // 64 lanes a block
constexpr int kChunk = 128;              // bins a chunk: 32 threads x 4
constexpr int kStep = 32;                // table rows (samples) a stage
constexpr int kQuads = kChunk / 4;       // float4 pieces of a table row chunk
constexpr int kStages = kBins / kChunk * (kSamples / kStep);
constexpr int kPitch = kTile + 4;        // floats a sample row of the tile
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
    float x[kSamples * kPitch];          // [n][slot]
    float4 c[2][kStep * kQuads];         // [buf][row][piece]
    float4 s[2][kStep * kQuads];
    int lane[kTile];
    int fit[kTile];
    int keep[kTile];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copy stage st (bin chunk st / 4, table rows (st % 4) * kStep ...) into buf.
__device__ __forceinline__ void load_stage(Smem& sm, const float4* dft_c,
                                           const float4* dft_s, int st, int buf) {
    const int chunk = st / (kSamples / kStep);
    const int n0 = st % (kSamples / kStep) * kStep;
#pragma unroll
    for (int u = 0; u < kStep * kQuads / kThreads; ++u) {
        const int i = threadIdx.x + u * kThreads;
        const int r = i / kQuads, q = i % kQuads;
        const int g = (n0 + r) * (kBins / 4) + chunk * kQuads + q;
        cp_async16(&sm.c[buf][i], dft_c + g);
        cp_async16(&sm.s[buf][i], dft_s + g);
    }
    cp_async_commit();
}

// One step of the argmax butterfly: take the (value, bin, re, im) of the
// thread `mask` away if its value is larger, or equal at a lower bin.
__device__ __forceinline__ void take_if_better(float& v, int& b, float& re,
                                               float& im, int mask) {
    const float ov = __shfl_xor_sync(kFull, v, mask);
    const int ob = __shfl_xor_sync(kFull, b, mask);
    const float ore = __shfl_xor_sync(kFull, re, mask);
    const float oim = __shfl_xor_sync(kFull, im, mask);
    if (ov > v || (ov == v && ob < b)) {
        v = ov; b = ob; re = ore; im = oim;
    }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, m));
    return v;                            // the same bits in every thread
}

struct Round {
    int k;
    const float* src;                    // round 0: the input; else x_work
    const int* list_in;
    const int* count_in;
    int* list_out;
    int* count_out;
    const int* fit_len;
    const int* max_keep;
    const float* sb_ath;
    const float4* dft_c;                 // [128, 1024] as float4
    const float4* dft_s;
    const float* tone_sin;               // [2048]
    const float* ladder;                 // [64]
    int* freq;                           // [L, 8]
    int* sf;
    int* ph;
    unsigned char* valid;
    float* max_amp;                      // [L]
    float* x_work;                       // [L, 128]
    unsigned long long* lane_rounds;     // null: not counted
};

__global__ void __launch_bounds__(kThreads, 2) gha_round_kernel(Round p) {
    extern __shared__ float4 smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    const int count = *p.count_in;
    const int start = blockIdx.x * kTile;
    if (start >= count) return;
    const int n_tile = min(kTile, count - start);
    const int warp = threadIdx.x / 32, t = threadIdx.x % 32;
    const int slot0 = warp * kWarpLanes;

    load_stage(sm, p.dft_c, p.dft_s, 0, 0);
    if (threadIdx.x < kTile) {
        const int s = threadIdx.x;
        const int lane = s < n_tile ? p.list_in[start + s] : -1;
        sm.lane[s] = lane;
        sm.fit[s] = lane >= 0 ? p.fit_len[lane] : 0;
    }
    if (threadIdx.x == 0 && p.lane_rounds != nullptr)
        atomicAdd(p.lane_rounds, static_cast<unsigned long long>(n_tile));
    __syncthreads();
    // the tile's samples, zero at and past each lane's fit length
    for (int i = threadIdx.x; i < kTile * kSamples / 4; i += kThreads) {
        const int s = i / (kSamples / 4), q = i % (kSamples / 4);
        const int lane = sm.lane[s];
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (lane >= 0)
            v = reinterpret_cast<const float4*>(p.src)[lane * (kSamples / 4) + q];
        const int fit = sm.fit[s], n = 4 * q;
        sm.x[(n + 0) * kPitch + s] = n + 0 < fit ? v.x : 0.f;
        sm.x[(n + 1) * kPitch + s] = n + 1 < fit ? v.y : 0.f;
        sm.x[(n + 2) * kPitch + s] = n + 2 < fit ? v.z : 0.f;
        sm.x[(n + 3) * kPitch + s] = n + 3 < fit ? v.w : 0.f;
    }

    // thread l < 8 of the warp: lane slot0 + l's running maximum
    float best_v = -1.f, best_re = 0.f, best_im = 0.f;
    int best_b = 0;
    float re[kWarpLanes][4], im[kWarpLanes][4];
    for (int st = 0; st < kStages; ++st) {
        const int buf = st & 1;
        if (st + 1 < kStages) {
            load_stage(sm, p.dft_c, p.dft_s, st + 1, buf ^ 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int n0 = st % (kSamples / kStep) * kStep;
        if (n0 == 0) {
#pragma unroll
            for (int l = 0; l < kWarpLanes; ++l)
#pragma unroll
                for (int j = 0; j < 4; ++j) re[l][j] = im[l][j] = 0.f;
        }
#pragma unroll 4
        for (int r = 0; r < kStep; ++r) {
            const float* xr = &sm.x[(n0 + r) * kPitch + slot0];
            const float4 xa = *reinterpret_cast<const float4*>(xr);
            const float4 xb = *reinterpret_cast<const float4*>(xr + 4);
            const float4 cv = sm.c[buf][r * kQuads + t];
            const float4 sv = sm.s[buf][r * kQuads + t];
            const float xv[kWarpLanes] = {xa.x, xa.y, xa.z, xa.w,
                                          xb.x, xb.y, xb.z, xb.w};
            const float cw[4] = {cv.x, cv.y, cv.z, cv.w};
            const float sw[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
            for (int l = 0; l < kWarpLanes; ++l)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    re[l][j] = __fmaf_rn(xv[l], cw[j], re[l][j]);
                    im[l][j] = __fmaf_rn(xv[l], sw[j], im[l][j]);
                }
        }
        if (n0 + kStep == kSamples) {
            // the chunk's spectrum is complete: its maximum per lane
            const int bin0 = st / (kSamples / kStep) * kChunk + 4 * t;
#pragma unroll
            for (int l = 0; l < kWarpLanes; ++l) {
                float v = -1.f, vr = 0.f, vi = 0.f;
                int vb = 0;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float r_ = re[l][j], i_ = -im[l][j];
                    const float m = bin0 + j == 0 ? 0.f
                        : __fadd_rn(__fmul_rn(r_, r_), __fmul_rn(i_, i_));
                    if (m > v) { v = m; vb = bin0 + j; vr = r_; vi = i_; }
                }
#pragma unroll
                for (int m = 16; m > 0; m >>= 1) take_if_better(v, vb, vr, vi, m);
                if (t == l && v > best_v) {
                    best_v = v; best_b = vb; best_re = vr; best_im = vi;
                }
            }
        }
        __syncthreads();                 // buf is refilled two stages on
    }

    // the epilogue: the warp's lanes one after another, 4 samples a thread
    constexpr float kHalfPi = static_cast<float>(3.14159265358979323846 / 2.0);
    constexpr float kStepsPerRad = static_cast<float>(2048.0 / (2.0 * 3.14159265358979323846));
    for (int l = 0; l < kWarpLanes; ++l) {
        const int s = slot0 + l;
        const int lane = sm.lane[s];
        const float vr = __shfl_sync(kFull, best_re, l);
        const float vi = __shfl_sync(kFull, best_im, l);
        const int b = __shfl_sync(kFull, best_b, l);
        if (lane < 0) continue;          // uniform in the warp
        const int fit = sm.fit[s];
        const float n_fit = static_cast<float>(fit > 1 ? fit : 1);
        const float amp = __fdiv_rn(__fmul_rn(2.0f, __fsqrt_rn(
            __fadd_rn(__fmul_rn(vr, vr), __fmul_rn(vi, vi)))), n_fit);
        const float phi = __fadd_rn(atan2f(vi, vr), kHalfPi);
        float steps = fmodf(__fmul_rn(phi, kStepsPerRad), 2048.0f);
        if (steps < 0.f) steps = __fadd_rn(steps, 2048.0f);   // torch.remainder
        const float lg = log2f(fmaxf(amp, 1e-20f));
        const float sf_f = fminf(fmaxf(floorf(__fadd_rn(__fmul_rn(4.0f, lg), 3.0f)),
                                       0.0f), 63.0f);
        const int sf_k = static_cast<int>(sf_f);
        const float amp_q = p.ladder[sf_k];
        const int ph_k = static_cast<int>(rintf(__fmul_rn(steps, 1.0f / 64.0f))) & 31;

        float e_old = 0.f, e_new = 0.f, res[kSamples / 32];
#pragma unroll
        for (int j = 0; j < kSamples / 32; ++j) {
            const int n = t + 32 * j;
            const float xv = sm.x[n * kPitch + s];
            const float tone = n < fit
                ? __fmul_rn(amp_q, p.tone_sin[((ph_k << 6) + n * b) & 2047]) : 0.f;
            res[j] = __fsub_rn(xv, tone);
            e_old = __fadd_rn(e_old, __fmul_rn(xv, xv));
            e_new = __fadd_rn(e_new, __fmul_rn(res[j], res[j]));
        }
        e_old = warp_sum(e_old);
        e_new = warp_sum(e_new);
        const long long row = static_cast<long long>(lane) * kWaves;
        const float prev_max = p.max_amp[lane];
        const bool near = t < p.k && p.valid[row + t]
                          && abs(p.freq[row + t] - b) < kMinDist;
        const bool accept = e_new < __fmul_rn(e_old, 0.9f)
                            && __fmul_rn(amp, amp) > p.sb_ath[lane]
                            && amp > __fmul_rn(prev_max, 1.0f / 10.0f)
                            && !__any_sync(kFull, near);
        if (accept) {
#pragma unroll
            for (int j = 0; j < kSamples / 32; ++j)
                p.x_work[static_cast<long long>(lane) * kSamples + t + 32 * j] = res[j];
            if (t == 0) {
                p.freq[row + p.k] = b;
                p.sf[row + p.k] = sf_k;
                p.ph[row + p.k] = ph_k;
                p.valid[row + p.k] = 1;
                p.max_amp[lane] = fmaxf(prev_max, amp);
            }
        }
        if (t == 0)
            sm.keep[s] = accept && p.k + 1 < kWaves && p.k + 1 < p.max_keep[lane];
    }
    __syncthreads();

    // the survivors into the next round's list: one atomicAdd a block
    if (warp == 0) {
        const int s0 = t, s1 = t + 32;
        const bool k0 = sm.lane[s0] >= 0 && sm.keep[s0];
        const bool k1 = sm.lane[s1] >= 0 && sm.keep[s1];
        const unsigned m0 = __ballot_sync(kFull, k0), m1 = __ballot_sync(kFull, k1);
        const int total = __popc(m0) + __popc(m1);
        int base = 0;
        if (t == 0 && total > 0) base = atomicAdd(p.count_out, total);
        base = __shfl_sync(kFull, base, 0);
        const unsigned below = (1u << t) - 1u;
        if (k0) p.list_out[base + __popc(m0 & below)] = sm.lane[s0];
        if (k1) p.list_out[base + __popc(m0) + __popc(m1 & below)] = sm.lane[s1];
    }
}

// Zero every lane's planes and list the lanes of round 0: active (or every
// lane when active is null) with max_keep > 0.
__global__ void gha_seed_kernel(const unsigned char* __restrict__ active,
                                const int* __restrict__ max_keep, int lanes,
                                int* __restrict__ list, int* count, int* freq,
                                int* sf, int* ph, unsigned char* valid,
                                float* max_amp) {
    const int stride = gridDim.x * blockDim.x;
    for (int base = blockIdx.x * blockDim.x; base < lanes; base += stride) {
        const int l = base + threadIdx.x;
        bool on = false;
        if (l < lanes) {
            const int4 z = make_int4(0, 0, 0, 0);
            int4* rows[3] = {reinterpret_cast<int4*>(freq) + 2 * l,
                             reinterpret_cast<int4*>(sf) + 2 * l,
                             reinterpret_cast<int4*>(ph) + 2 * l};
#pragma unroll
            for (int i = 0; i < 3; ++i) rows[i][0] = rows[i][1] = z;
            reinterpret_cast<unsigned long long*>(valid)[l] = 0ull;
            max_amp[l] = 0.f;
            on = (active == nullptr || active[l]) && max_keep[l] > 0;
        }
        const unsigned m = __ballot_sync(kFull, on);
        const int t = threadIdx.x % 32;
        int at = 0;
        if (t == 0 && m) at = atomicAdd(count, __popc(m));
        at = __shfl_sync(kFull, at, 0);
        if (on) list[at + __popc(m & ((1u << t) - 1u))] = l;
    }
}

}  // namespace

// x, x_work [lanes, 128] f32; fit_len, max_keep [lanes] int32; sb_ath,
// max_amp [lanes] f32; active [lanes] bool or null (every lane); dft_c,
// dft_s [128, 1024] f32; tone_sin [2048] and ladder [64] f32; freq, sf, ph
// [lanes, 8] int32 and valid [lanes, 8] bool, every element written; lists
// [2, lanes] int32 scratch; counts [9] int32, zero on entry; lane_rounds
// one int64 or null.  Launches the seed kernel and the 8 rounds on stream;
// nothing is read back.
extern "C" int gha_greedy(const float* x, const int* fit_len, const int* max_keep,
                          const float* sb_ath, const unsigned char* active,
                          const float* dft_c, const float* dft_s,
                          const float* tone_sin, const float* ladder, int* freq,
                          int* sf, int* ph, unsigned char* valid, float* max_amp,
                          float* x_work, int* lists, int* counts,
                          long long* lane_rounds, int lanes, void* stream) {
    if (lanes < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (lanes == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int smem = static_cast<int>(sizeof(Smem));
    cudaError_t err = cudaFuncSetAttribute(
        gha_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int seed_blocks = (lanes + 255) / 256 < 2048 ? (lanes + 255) / 256 : 2048;
    gha_seed_kernel<<<seed_blocks, 256, 0, st>>>(active, max_keep, lanes, lists,
                                                 counts, freq, sf, ph, valid, max_amp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const unsigned blocks = static_cast<unsigned>((lanes + kTile - 1) / kTile);
    for (int k = 0; k < kWaves; ++k) {
        Round p{k, k == 0 ? x : x_work, lists + (k & 1) * static_cast<long long>(lanes),
                counts + k, lists + ((k + 1) & 1) * static_cast<long long>(lanes),
                counts + k + 1, fit_len, max_keep, sb_ath,
                reinterpret_cast<const float4*>(dft_c),
                reinterpret_cast<const float4*>(dft_s), tone_sin, ladder, freq, sf,
                ph, valid, max_amp, x_work,
                reinterpret_cast<unsigned long long*>(lane_rounds)};
        gha_round_kernel<<<blocks, kThreads, smem, st>>>(p);
        err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}
