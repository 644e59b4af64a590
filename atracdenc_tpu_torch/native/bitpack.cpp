// Host-side bitstream finalization: MSB-first packing/unpacking over batches
// of frames.  This is the native runtime counterpart of utils/bitpack.py —
// same contract, built as a shared library and loaded via ctypes
// (utils/native.py).  Frames are independent, so the batch is split across
// worker threads.
//
// Bitstream semantics match the reference writer (reference:
// src/lib/bitstream/bitstream.cpp:40-91 — MSB-first, values pre-masked to
// `width` low bits).
#include <cstdint>
#include <functional>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline void put_bits(uint8_t* frame, int64_t& bitpos, uint32_t value, int width) {
    for (int j = width - 1; j >= 0; --j) {
        if ((value >> j) & 1u) {
            frame[bitpos >> 3] |= uint8_t(0x80u >> (bitpos & 7));
        }
        ++bitpos;
    }
}

inline uint32_t get_bits(const uint8_t* frame, int64_t& bitpos, int width,
                         int64_t total_bits) {
    uint32_t v = 0;
    for (int j = 0; j < width; ++j) {
        uint32_t bit = 0;
        if (bitpos < total_bits) {
            bit = (frame[bitpos >> 3] >> (7 - (bitpos & 7))) & 1u;
        }
        v = (v << 1) | bit;
        ++bitpos;
    }
    return v;
}

void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& fn) {
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nthreads = hw ? (hw < 16 ? hw : 16) : 4;
    if (n < 256 || nthreads <= 1) {
        fn(0, n);
        return;
    }
    std::vector<std::thread> workers;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = lo + chunk < n ? lo + chunk : n;
        if (lo >= hi) break;
        workers.emplace_back(fn, lo, hi);
    }
    for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Generic packer: values/widths are [n_frames, n_fields] int32 row-major;
// output is [n_frames, frame_bytes] (pre-zeroed by the caller or here).
// Returns 0 on success, -1 if any frame overflows.
int pack_frames(const uint32_t* values, const int32_t* widths,
                int64_t n_frames, int64_t n_fields, int64_t frame_bytes,
                uint8_t* out) {
    const int64_t total_bits = frame_bytes * 8;
    int overflow = 0;
    parallel_for(n_frames, [&](int64_t lo, int64_t hi) {
        for (int64_t f = lo; f < hi; ++f) {
            const uint32_t* v = values + f * n_fields;
            const int32_t* w = widths + f * n_fields;
            uint8_t* frame = out + f * frame_bytes;
            std::memset(frame, 0, frame_bytes);
            int64_t pos = 0;
            for (int64_t k = 0; k < n_fields; ++k) {
                if (w[k] <= 0) continue;
                if (pos + w[k] > total_bits) { overflow = 1; break; }
                put_bits(frame, pos, v[k], w[k]);
            }
        }
    });
    return overflow ? -1 : 0;
}

// Generic unpacker: offsets/widths [n_frames, n_fields] -> values (uint32).
void unpack_fields(const uint8_t* frames, int64_t frame_bytes,
                   const int64_t* offsets, const int32_t* widths,
                   int64_t n_frames, int64_t n_fields, uint32_t* out) {
    const int64_t total_bits = frame_bytes * 8;
    parallel_for(n_frames, [&](int64_t lo, int64_t hi) {
        for (int64_t f = lo; f < hi; ++f) {
            const uint8_t* frame = frames + f * frame_bytes;
            const int64_t* off = offsets + f * n_fields;
            const int32_t* w = widths + f * n_fields;
            uint32_t* v = out + f * n_fields;
            for (int64_t k = 0; k < n_fields; ++k) {
                if (w[k] <= 0) { v[k] = 0; continue; }
                int64_t pos = off[k];
                v[k] = get_bits(frame, pos, w[k], total_bits);
            }
        }
    });
}

}  // extern "C"
