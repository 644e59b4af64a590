"""ATRAC1 sound-unit serialization: planes <-> 212-byte frames.

Bit layout per channel frame (reference: atrac1_bitalloc.cpp:279-327,
atrac1_dequantiser.cpp:31-68):

  2  bits: 2 - log2(nblocks) low band      (2=long, 0=short)
  2  bits: 2 - log2(nblocks) mid band
  2  bits: 3 - log2(nblocks) hi band       (3=long, 0=short)
  2  bits: 0
  3  bits: BFU-amount table index
  2+3 bits: 0 (reserved)
  4  bits x bfuNum: word length (wl ? wl-1 : 0)
  6  bits x bfuNum: scale factor index
  per BFU with wl >= 2: SpecsPerBlock[i] mantissas of wl bits (two's compl.)
  zero padding to 212 bytes (incl. the reference's 3 explicit zero bytes)
"""
import numpy as np

from portbench.reference.upstream import bitpack
from . import tables as T

_N_HEADER = 7
_HEADER_WIDTHS = np.array([2, 2, 2, 2, 3, 2, 3], np.int64)
_MAXLEN = 20
_TOTAL_FIELDS = _N_HEADER + 52 + 52 + 52 * _MAXLEN


def pack(planes) -> np.ndarray:
    """planes (from encoder.encode_track, single channel axis already merged
    to the frame axis) -> [N, 212] uint8 frames.

    Expects: short_mask [N, 3] bool, bfu_idx [N], wordlen [N, 52],
    sfi [N, 52], mant [N, 52, 20].
    """
    short = np.asarray(planes["short_mask"], bool)
    bfu_idx = np.asarray(planes["bfu_idx"], np.int64)
    wl = np.asarray(planes["wordlen"], np.int64)
    sfi = np.asarray(planes["sfi"], np.int64)
    mant = np.asarray(planes["mant"], np.int64)
    n = bfu_idx.shape[0]
    bfu_num = T.BFU_AMOUNT_TAB[bfu_idx]                       # [N]
    in_use = np.arange(52)[None, :] < bfu_num[:, None]        # [N, 52]

    values = np.zeros((n, _TOTAL_FIELDS), np.uint32)
    widths = np.zeros((n, _TOTAL_FIELDS), np.int64)

    # header
    widths[:, :_N_HEADER] = _HEADER_WIDTHS
    values[:, 0] = np.where(short[:, 0], 0, 2)
    values[:, 1] = np.where(short[:, 1], 0, 2)
    values[:, 2] = np.where(short[:, 2], 0, 3)
    values[:, 4] = bfu_idx

    # word lengths (stored as wl-1 for wl>=2, else 0)
    wl_field = np.where(wl > 0, wl - 1, 0)
    sl = slice(_N_HEADER, _N_HEADER + 52)
    values[:, sl] = wl_field
    widths[:, sl] = np.where(in_use, 4, 0)

    sl = slice(_N_HEADER + 52, _N_HEADER + 104)
    values[:, sl] = sfi
    widths[:, sl] = np.where(in_use, 6, 0)

    # mantissas
    spec_valid = T.GATHER_MASK[None]                          # [1, 52, 20]
    mant_w = np.where(spec_valid & (wl >= 2)[:, :, None] & in_use[:, :, None],
                      wl[:, :, None], 0)
    values[:, _N_HEADER + 104:] = bitpack.mask_sign(
        mant, np.maximum(mant_w, 1)).reshape(n, -1)
    widths[:, _N_HEADER + 104:] = mant_w.reshape(n, -1)

    return bitpack.pack_frames(values, widths, T.SOUND_UNIT_SIZE)


def unpack(frames: np.ndarray):
    """[N, 212] uint8 -> planes dict (+ 'valid' [N] bool).

    Malformed frames (negative block-size mode, overlong mantissa section —
    reference atrac1.cpp:37-53, bitstream read-past-end) are replaced with
    silent planes and long windows, like the reference decoder
    (atrac1denc.cpp:151-162).
    """
    frames = np.ascontiguousarray(frames, np.uint8)
    n = frames.shape[0]

    def field(off, width):  # fixed-offset scalar field
        o = np.full((n, 1), off, np.int64)
        w = np.full((n, 1), width, np.int64)
        return bitpack.unpack_frames(frames, o, w)[:, 0].astype(np.int64)

    log_low = 2 - field(0, 2)
    log_mid = 2 - field(2, 2)
    log_hi = 3 - field(4, 2)
    bfu_idx = field(8, 3)
    valid = (log_low >= 0) & (log_mid >= 0) & (log_hi >= 0)

    bfu_num = T.BFU_AMOUNT_TAB[bfu_idx]
    in_use = np.arange(52)[None, :] < bfu_num[:, None]

    wl_off = 16 + 4 * np.arange(52)[None, :] * np.ones((n, 1), np.int64)
    wl_raw = bitpack.unpack_frames(frames, wl_off, np.where(in_use, 4, 0)).astype(np.int64)
    wl = np.where(wl_raw > 0, wl_raw + 1, 0) * in_use         # actual word length

    sfi_base = (16 + 4 * bfu_num)[:, None]
    sfi_off = sfi_base + 6 * np.arange(52)[None, :]
    sfi = bitpack.unpack_frames(frames, sfi_off, np.where(in_use, 6, 0)).astype(np.int64)

    # mantissa section
    spec_valid = T.GATHER_MASK[None]
    mant_w = np.where(spec_valid & (wl >= 2)[:, :, None], wl[:, :, None], 0)
    mant_w_flat = mant_w.reshape(n, -1)
    mant_base = (16 + 10 * bfu_num)[:, None]
    mant_off = np.zeros((n, mant_w_flat.shape[1]), np.int64)
    np.cumsum(mant_w_flat[:, :-1], axis=1, out=mant_off[:, 1:])
    mant_off += mant_base
    valid &= (mant_off[:, -1] + mant_w_flat[:, -1]) <= T.SOUND_UNIT_SIZE * 8
    raw = bitpack.unpack_frames(frames, mant_off, mant_w_flat)
    mant = bitpack.make_sign(raw, mant_w_flat).reshape(n, 52, _MAXLEN)

    # silence malformed frames, keep neutral long mode
    bad = ~valid
    short_mask = np.stack([log_low > 0, log_mid > 0, log_hi > 0], axis=-1)
    short_mask[bad] = False
    wl[bad] = 0
    sfi[bad] = 0
    mant[bad] = 0

    return {
        "short_mask": short_mask,
        "bfu_idx": bfu_idx.astype(np.int32),
        "wordlen": wl.astype(np.int32),
        "sfi": sfi.astype(np.int32),
        "mant": mant.astype(np.int32),
        "valid": valid,
    }
