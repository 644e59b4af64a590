"""Vectorized MSB-first bit packing/unpacking over batches of frames.

An encoder emits fixed-shape integer planes; serialization into the
codec's MSB-first bitstream (reference: src/lib/bitstream/bitstream.cpp) is
host work.  This NumPy implementation packs/unpacks *all frames at once* via
bit-matrix scatter/gather.

Contract: every frame f is described by a flat list of fields k with
`widths[f, k]` bits (0 = absent) and values `values[f, k]` (only the low
`widths` bits are used, i.e. values must be pre-masked two's complement).
"""
import numpy as np

__all__ = ["pack_frames", "unpack_fields", "make_sign", "mask_sign"]


def mask_sign(values: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Two's-complement truncation of signed values to `widths` bits."""
    w = widths.astype(np.int64)
    return (values.astype(np.int64) & ((1 << w) - 1)).astype(np.uint32)


def make_sign(values: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Sign-extend `widths`-bit values (reference: bitstream.h:27-31)."""
    w = widths.astype(np.int64)
    v = values.astype(np.int64)
    sign_bit = 1 << np.maximum(w - 1, 0)
    out = np.where((w > 0) & (v & sign_bit != 0), v - (1 << w), v)
    return out.astype(np.int32)


def pack_frames(values: np.ndarray, widths: np.ndarray, frame_bytes: int) -> np.ndarray:
    """Pack [F, K] fields into [F, frame_bytes] MSB-first byte frames.

    """
    return _pack_frames_np(values, widths, frame_bytes)


def _pack_frames_np(values: np.ndarray, widths: np.ndarray, frame_bytes: int) -> np.ndarray:
    f, k = values.shape
    total_bits = frame_bytes * 8
    offsets = np.zeros((f, k), np.int64)
    np.cumsum(widths[:, :-1], axis=1, out=offsets[:, 1:])
    if np.any(offsets[:, -1] + widths[:, -1] > total_bits):
        raise ValueError("frame overflow: fields exceed frame size")

    # bit matrix with one sentinel slot for masked scatters
    bits = np.zeros((f, total_bits + 1), np.uint8)
    rows = np.arange(f)[:, None]
    maxw = int(widths.max(initial=0))
    v = values.astype(np.uint32)
    for j in range(maxw):
        active = widths > j
        shift = np.where(active, widths - 1 - j, 0).astype(np.uint32)
        bit = ((v >> shift) & 1).astype(np.uint8)
        pos = np.where(active, offsets + j, total_bits)
        bits[rows, pos] = np.where(active, bit, bits[rows, pos])
    return np.packbits(bits[:, :total_bits], axis=1)


def unpack_frames(frames: np.ndarray, offsets: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Extract fields from [F, B] byte frames; offsets/widths: [F, K].

    Out-of-range reads return 0 bits.  Returns uint32 [F, K].
    """
    bits = np.unpackbits(np.ascontiguousarray(frames, np.uint8), axis=1)
    return unpack_fields(bits, offsets, widths)


def unpack_fields(bits: np.ndarray, offsets: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Extract fields from unpacked bit matrices.

    bits: [F, B*8] uint8 (np.unpackbits output); offsets/widths: [F, K].
    Out-of-range reads return 0 bits.  Returns uint32 [F, K].
    """
    f, total_bits = bits.shape
    rows = np.arange(f)[:, None]
    maxw = int(widths.max(initial=0))
    acc = np.zeros(offsets.shape, np.uint32)
    padded = np.concatenate([bits, np.zeros((f, 1), np.uint8)], axis=1)
    for j in range(maxw):
        active = widths > j
        pos = np.where(active & (offsets + j < total_bits), offsets + j, total_bits)
        bit = padded[rows, pos].astype(np.uint32)
        acc = np.where(active, (acc << 1) | bit, acc)
    return acc
