// Kernel I: ATRAC3+'s spectrum fields, one channel of [F] frames.
//
// Replaces no TPU kernel.  The JAX package builds these fields with XLA
// alone (atracdenc_tpu/models/atrac3p/device_pack.py:91 _spec_group_fields:
// every code group of every QU at all 8 table families, the codebooks read
// by an exact one-hot matmul, one family kept a QU); its plain PyTorch port
// (models/atrac3p/device_pack.py::spectrum_fields_torch) spells the same
// work out as int64 temporaries, ~2,300 launching ops a channel.  This is
// its CUDA counterpart, with the same semantics: code group g of QU q sits
// at slot SPECS_START[q] + g of the frame's 2,048; its value merges the
// group flag (g % gs == 0 where gs != 1), the VLC code and, for unsigned
// tables, the sign bits MSB-first in mantissa order; its width is the sum
// of their lengths.  A slot past its QU's ln / nc groups, or of a QU at or
// past num_qu, or of a family outside 0..7, has value 0 and width 0.
// Offsets are pos[f] plus the exclusive prefix of the widths in slot order
// (QU by QU, group by group: the order the bitstream writes them), and
// bits[f] is the section's total.
//
// Bound: bytes.  Each frame reads its 2,048 mantissas (8 KiB of the padded
// [32, 128] rows) and writes 2,048 (int64 value, int32 width, int32 offset)
// slots: 40 KiB a frame, 1.34 GB a channel at 32,768 frames, 0.4 ms at
// 3.35 TB/s.
// Design: a block of 256 threads walks frames (grid-stride); the tables
// (each (family, wordlen) table's (gs, nc, bits, signed), the QUs' start,
// length and wordlen, and the 56 codebooks used, 16 bits an entry) are
// staged into shared memory once a block.  A frame's QU rows are read once
// with 16-byte coalesced loads into shared memory.  Each warp then owns 256
// consecutive slots, in 8 unrolled rounds of 32 (a lane a slot: its QU's
// chosen table only, its group's nc mantissas in one 4-, 8- or 16-byte
// shared load), scanning the widths across the warp with shuffles and
// carrying the sum in registers, so the rounds' loads overlap and the only
// barriers are the staging's and the one that adds the 8 warps' sums.
// Nothing but the three output planes and the bit totals goes to device
// memory, each written coalesced.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 2048;                  // lines, and code-group slots, a frame
constexpr int kChunk = kSlots / kWarps;        // a warp's consecutive slots
constexpr int kPerLane = kChunk / 32;
constexpr int kQu = 32;
constexpr int kRow = 128;                     // mantissas a QU row of the input
constexpr int kTabs = 56;                     // 8 families x 7 wordlens
// the table's int32 words: [kTabs params][kQu geometry][kSlots / 16 QU of
// each 16 slots][the codebooks, two 16-bit entries a word]
constexpr int kGeom = kTabs;
constexpr int kQuOf = kGeom + kQu;
constexpr int kCodes = kQuOf + kSlots / 16;
constexpr int kBookLen = kCodes + kTabs * 256 / 2;

// (value, width) of slot s of the frame staged in shared memory.
__device__ __forceinline__ void code_group(
        int s, int nq, const int* s_book, const unsigned short* codes,
        const int* s_mant, const int* s_tab, unsigned int& v, int& w) {
    const int q = s_book[kQuOf + (s >> 4)];
    const int geom = s_book[kGeom + q];
    const int start = geom & 0xFFF, ln = (geom >> 12) & 0xFF;
    const int wl = geom >> 20, fam = s_tab[q], g = s - start;
    v = 0u;
    w = 0;
    if (q >= nq || static_cast<unsigned>(fam) >= 8u) return;
    const int tab = 7 * fam + wl - 1;
    const int p = s_book[tab];
    const int gs = p & 0xFF, nc = (p >> 8) & 0xFF;
    const int nb = (p >> 16) & 0xFF, sgn = p >> 24;
    if (g * nc >= ln) return;                     // past the QU's ln / nc groups
    const int at = start + g * nc;
    int x[4] = {0, 0, 0, 0};
    if (nc == 4) {
        const int4 t = reinterpret_cast<const int4*>(s_mant)[at >> 2];
        x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else if (nc == 2) {
        const int2 t = reinterpret_cast<const int2*>(s_mant)[at >> 1];
        x[0] = t.x; x[1] = t.y;
    } else {
        x[0] = s_mant[at];
    }
    int idx = 0, sw = 0;
    unsigned int signs = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if (i < nc) {
            const int m = x[i];
            if (sgn) {
                idx += (m & ((1 << nb) - 1)) << (nb * i);
            } else {
                idx += (m < 0 ? -m : m) << (nb * i);
                if (m != 0) {
                    signs = (signs << 1) | (m < 0 ? 1u : 0u);
                    ++sw;
                }
            }
        }
    }
    // a valid group's index is below 256; the mask keeps a stray one
    // inside the table
    const unsigned int cl = codes[tab * 256 + (idx & 255)];
    const int clen = static_cast<int>(cl >> 12);
    const unsigned int flag = (gs != 1 && (g & (gs - 1)) == 0) ? 1u : 0u;  // gs: 1, 2, 4
    v = (flag << (clen + sw)) + ((cl & 0xFFFu) << sw) + signs;
    w = static_cast<int>(flag) + clen + sw;
}

__global__ void __launch_bounds__(kThreads) spectrum_kernel(
        const int* __restrict__ mant, const int* __restrict__ spec_tab,
        const int* __restrict__ num_qu, const int* __restrict__ pos,
        const int* __restrict__ book, long long* __restrict__ values,
        int* __restrict__ widths, int* __restrict__ offsets,
        int* __restrict__ bits, long long n_frames) {
    __shared__ int s_book[kBookLen];
    __shared__ int4 s_mant4[kSlots / 4];      // the frame's lines, packed
    __shared__ int s_tab[kQu];
    __shared__ int s_warp[kWarps];
    for (int i = threadIdx.x; i < kBookLen; i += kThreads) s_book[i] = book[i];
    const unsigned short* codes =
        reinterpret_cast<const unsigned short*>(s_book + kCodes);
    const int* s_mant = reinterpret_cast<const int*>(s_mant4);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int first = warp * kChunk + lane;   // the warp's slots: first + 32 j

    for (long long f = blockIdx.x; f < n_frames; f += gridDim.x) {
        __syncthreads();                      // tables staged; last frame read
        const int4* row = reinterpret_cast<const int4*>(mant + f * (kQu * kRow));
        for (int k = threadIdx.x; k < kSlots / 4; k += kThreads) {
            const int s = 4 * k;
            const int q = s_book[kQuOf + (s >> 4)];
            const int start = s_book[kGeom + q] & 0xFFF;
            s_mant4[k] = row[q * (kRow / 4) + ((s - start) >> 2)];
        }
        if (threadIdx.x < kQu) s_tab[threadIdx.x] = spec_tab[f * kQu + threadIdx.x];
        const int nq = num_qu[f];
        const int pos0 = pos[f];
        __syncthreads();

        // the warp's chunk: 8 rounds of 32 slots, each scanned across the
        // warp and carried into the next in registers
        unsigned int v[kPerLane];
        int w[kPerLane], excl[kPerLane];
        int carry = 0;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
            code_group(first + 32 * j, nq, s_book, codes, s_mant, s_tab, v[j], w[j]);
            int incl = w[j];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
                if (lane >= d) incl += y;
            }
            excl[j] = carry + incl - w[j];
            carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
        }
        if (lane == 0) s_warp[warp] = carry;
        __syncthreads();
        int before = pos0, total = pos0;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) {
            const int t = s_warp[k];
            before += k < warp ? t : 0;
            total += t;
        }
        const long long o = f * kSlots + first;
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
            values[o + 32 * j] = static_cast<long long>(v[j]);
            widths[o + 32 * j] = w[j];
            offsets[o + 32 * j] = before + excl[j];
        }
        if (threadIdx.x == 0) bits[f] = total - pos0;
    }
}

}  // namespace

// mant [n_frames, 32, 128] int32 (16-byte aligned), spec_tab [n_frames, 32],
// num_qu and pos [n_frames] int32, book the kBookLen int32 words laid out
// above; values [n_frames, 2048] int64, widths and offsets [n_frames, 2048]
// int32 and bits [n_frames] int32, every element written.
extern "C" int at3p_spectrum_fields(const void* mant, const void* spec_tab,
                                    const void* num_qu, const void* pos,
                                    const void* book, void* values, void* widths,
                                    void* offsets, void* bits, long long n_frames,
                                    int book_len, void* stream) {
    if (n_frames < 0 || book_len != kBookLen)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n_frames == 0) return 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, spectrum_kernel,
                                                            kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const long long blocks = n_frames < resident ? n_frames : resident;
    spectrum_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(mant), static_cast<const int*>(spec_tab),
        static_cast<const int*>(num_qu), static_cast<const int*>(pos),
        static_cast<const int*>(book), static_cast<long long*>(values),
        static_cast<int*>(widths), static_cast<int*>(offsets),
        static_cast<int*>(bits), n_frames);
    return static_cast<int>(cudaGetLastError());
}
