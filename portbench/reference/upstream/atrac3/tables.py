"""ATRAC3 format constants.

Facts of the ATRAC3 bitstream format (BFU layout, scale table, windows, gain
tables, Huffman codebooks, container modes) and of the reference encoder's
tuning (fixed allocation table).  Sources: reference src/atrac/at3/atrac3.h
and src/atrac/at3/atrac3_bitstream.cpp:109-134.
"""
import numpy as np

NUM_SAMPLES = 1024         # PCM samples per frame per channel
MAX_BFUS = 32
NUM_QMF = 4
MDCT_SZ = 512

# --- BFU layout -------------------------------------------------------------
# Spectral-line boundaries of the 32 block-floating units (atrac3.h:85-91).
BLOCK_SIZE_TAB = np.array([
    0, 8, 16, 24, 32, 40, 48, 56,
    64, 80, 96, 112, 128, 144, 160, 176,
    192, 224, 256, 288, 320, 352, 384, 416,
    448, 480, 512, 576, 640, 704, 768, 896,
    1024,
], dtype=np.int32)

SPECS_PER_BLOCK = np.diff(BLOCK_SIZE_TAB).astype(np.int32)   # [32], max 128
SPECS_START = BLOCK_SIZE_TAB[:32].copy()
BLOCKS_PER_BAND = np.array([0, 18, 26, 30, 32], dtype=np.int32)
# BFU index -> QMF band
BFU_TO_BAND = np.array([0] * 18 + [1] * 8 + [2] * 4 + [3] * 2, dtype=np.int32)
MAX_SPECS_PER_BLOCK = 128

# --- quantization -----------------------------------------------------------
# Mantissa multiplier per word length 0..7 (atrac3.h:79-83).
MAX_QUANT = np.array([0.0, 1.5, 2.5, 3.5, 4.5, 7.5, 15.5, 31.5],
                     dtype=np.float32)
# Constant-length code bits per word length (atrac3.h:96).
CLC_LENGTH_TAB = np.array([0, 4, 3, 3, 4, 4, 5, 6], dtype=np.int32)

# Same 2^(i/3 - 21) ladder as ATRAC1 (atrac3.h:186-189).
SCALE_TABLE = np.power(2.0, np.arange(64) / 3.0 - 21.0).astype(np.float32)

# --- windows & gain control -------------------------------------------------
_i = np.arange(256)
# EncodeWindow = sin(((i+0.5)/256 - 0.5)*pi) + 1 (atrac3.h:191-194); note NOT
# halved — the implicit x0.5 is folded into the MDCT scale convention.
ENCODE_WINDOW = (np.sin(((_i + 0.5) / 256.0 - 0.5) * np.pi) + 1.0
                 ).astype(np.float32)
DECODE_WINDOW = (2.0 * ENCODE_WINDOW /
                 (ENCODE_WINDOW ** 2 + ENCODE_WINDOW[::-1] ** 2)
                 ).astype(np.float32)

EXPONENT_OFFSET = 4
LOC_SCALE = 3
LOC_SZ = 8
GAIN_INTERPOLATION_POS_SHIFT = 15
GAIN_LEVEL = np.power(2.0, EXPONENT_OFFSET - np.arange(16)).astype(np.float32)
GAIN_INTERPOLATION = np.power(
    2.0, -1.0 / LOC_SZ * (np.arange(31) - 15)).astype(np.float32)
MAX_GAIN_POINTS = 8

LOUD_FACTOR = 0.006  # atrac3denc.h:118

# --- bit allocation ---------------------------------------------------------
# Fixed allocation blend table (atrac3_bitstream.cpp:115-120).
FIXED_BIT_ALLOC = np.array([
    6, 6, 5, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
    2, 2, 2, 2, 2, 1, 1, 1,
    1, 1, 1, 0,
    0, 0,
], dtype=np.int32)

# SFI divisor x per BFU (atrac3_bitstream.cpp:367-378).
def _sfi_divisor() -> np.ndarray:
    x = np.full(MAX_BFUS, 6.0, dtype=np.float32)
    for i in range(MAX_BFUS):
        if i < 3:
            x[i] = 2.8
        elif i < 10:
            x[i] = 2.6
        elif i < 15:
            x[i] = 3.3
        elif i <= 20:
            x[i] = 3.6
        elif i <= 28:
            x[i] = 4.2
    return x


SFI_DIVISOR = _sfi_divisor()

# Energy-adjusted quantization & energy-error boost bounds
# (atrac3_bitstream.cpp:122-134; EAQ is enabled in the reference build).
LOSY_NAQ_START = 18   # EA rounding for BFUs > this
BOOST_NAQ_END = 10    # energy-error wordlen boost for BFUs < this

# --- Huffman spectrum codebooks (atrac3.h:98-180) ---------------------------
# (code, bits) per symbol index; index for wl>1: m=0 -> 0, m>0 -> 2m-1,
# m<0 -> 2|m|.  For wl==1 pairs are coded via VLC_PAIR_INDEX.
HUFF_TABLE_1 = [(0x0, 1), (0x4, 3), (0x5, 3), (0xC, 4), (0xD, 4),
                (0x1C, 5), (0x1D, 5), (0x1E, 5), (0x1F, 5)]
HUFF_TABLE_2 = [(0x0, 1), (0x4, 3), (0x5, 3), (0x6, 3), (0x7, 3)]
HUFF_TABLE_3 = [(0x0, 1), (0x4, 3), (0x5, 3), (0xC, 4), (0xD, 4),
                (0xE, 4), (0xF, 4)]
HUFF_TABLE_5 = [(0x0, 2), (0x2, 3), (0x3, 3),
                (0x8, 4), (0x9, 4), (0xA, 4), (0xB, 4),
                (0x1C, 5), (0x1D, 5),
                (0x3C, 6), (0x3D, 6), (0x3E, 6), (0x3F, 6),
                (0xC, 4), (0xD, 4)]
HUFF_TABLE_6 = [(0x0, 3),
                (0x2, 4), (0x3, 4), (0x4, 4), (0x5, 4), (0x6, 4), (0x7, 4),
                (0x14, 5), (0x15, 5), (0x16, 5), (0x17, 5), (0x18, 5), (0x19, 5),
                (0x34, 6), (0x35, 6), (0x36, 6), (0x37, 6), (0x38, 6),
                (0x39, 6), (0x3A, 6), (0x3B, 6),
                (0x78, 7), (0x79, 7), (0x7A, 7), (0x7B, 7), (0x7C, 7),
                (0x7D, 7), (0x7E, 7), (0x7F, 7),
                (0x8, 4), (0x9, 4)]
HUFF_TABLE_7 = ([(0x0, 3)]
                + [(c, 5) for c in range(0x8, 0x12)]
                + [(c, 6) for c in range(0x24, 0x34)]
                + [(c, 7) for c in range(0x68, 0x76)]
                + [(c, 8) for c in range(0xEC, 0x100)]
                + [(0x2, 4), (0x3, 4)])

# Selector (wordlen) 1..7 -> codebook (atrac3.h:170-178; selector 4 reuses
# table 1).
HUFF_TABLES = [HUFF_TABLE_1, HUFF_TABLE_2, HUFF_TABLE_3, HUFF_TABLE_1,
               HUFF_TABLE_5, HUFF_TABLE_6, HUFF_TABLE_7]

# Dual-mantissa VLC index for wl==1 pairs: idx = rtab[3*(a+1) + (b+1)]
# (atrac3.h:206-212).
VLC_PAIR_RTAB = np.array([8, 4, 7, 2, 0, 1, 6, 3, 5], dtype=np.int32)
# CLC index for wl==1 mantissa in [-2..1]: rtab[m+2] (atrac3.h:199-204).
CLC_RTAB = np.array([2, 3, 0, 1], dtype=np.int32)


def _vlc_cost_tables():
    """[7, 63] VLC bit-cost per (selector-1, symbol index) and the matching
    code values; unused entries are 0-cost/0-code."""
    bits = np.zeros((7, 63), dtype=np.int32)
    code = np.zeros((7, 63), dtype=np.int32)
    for sel in range(7):
        for idx, (c, b) in enumerate(HUFF_TABLES[sel]):
            bits[sel, idx] = b
            code[sel, idx] = c
    return code, bits


VLC_CODE, VLC_BITS = _vlc_cost_tables()

# --- container modes (atrac3.h:214-223) -------------------------------------
# bitrate (bits/s) -> (frame bytes, joint stereo)
CONTAINER_PARAMS = [
    (66150, 192, True),
    (93713, 272, True),
    (104738, 304, False),
    (132300, 384, False),
    (146081, 424, False),
    (176400, 512, False),
    (264600, 768, False),
    (352800, 1024, False),
]


def container_params_for_bitrate(bitrate: int):
    """lower_bound over the mode table; 0 selects the LP2 default
    (atrac3.cpp:46-52)."""
    if bitrate == 0:
        bitrate = 132300
    for br, sz, js in CONTAINER_PARAMS:
        if br >= bitrate:
            return br, sz, js
    return CONTAINER_PARAMS[-1]


def gather_indices():
    """[32, 128] spec-position gather matrix + validity mask for BFU blocks."""
    maxlen = MAX_SPECS_PER_BLOCK
    idx = np.zeros((MAX_BFUS, maxlen), dtype=np.int32)
    mask = np.zeros((MAX_BFUS, maxlen), dtype=bool)
    for b in range(MAX_BFUS):
        ln = SPECS_PER_BLOCK[b]
        idx[b, :ln] = SPECS_START[b] + np.arange(ln)
        mask[b, :ln] = True
    return idx, mask


GATHER_IDX, GATHER_MASK = gather_indices()
