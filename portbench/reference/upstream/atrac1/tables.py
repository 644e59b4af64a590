"""ATRAC1 format constants.

These tables are facts of the ATRAC1 bitstream format (BFU layout, scale
table, window) and of the reference encoder's tuning (fixed allocation
tables, boost mask).  Sources: reference src/atrac/at1/atrac1.h:86-133 and
src/atrac/at1/atrac1_bitalloc.cpp:37-67.
"""
import numpy as np

NUM_SAMPLES = 512          # PCM samples per frame per channel
SOUND_UNIT_SIZE = 212      # bytes per frame per channel
MAX_BFUS = 52
NUM_QMF = 3
BITS_PER_BFU_AMOUNT_TAB_IDX = 3
BITS_PER_IDWL = 4
BITS_PER_IDSF = 6

# Spectral lines per block-floating unit (low 20 / mid 16 / high 16 BFUs).
SPECS_PER_BLOCK = np.array([
    8, 8, 8, 8, 4, 4, 4, 4, 8, 8, 8, 8, 6, 6, 6, 6, 6, 6, 6, 6,
    6, 6, 6, 6, 7, 7, 7, 7, 9, 9, 9, 9, 10, 10, 10, 10,
    12, 12, 12, 12, 12, 12, 12, 12, 20, 20, 20, 20, 20, 20, 20, 20,
], dtype=np.int32)

BLOCKS_PER_BAND = np.array([0, 20, 36, 52], dtype=np.int32)

SPECS_START_LONG = np.array([
    0, 8, 16, 24, 32, 36, 40, 44, 48, 56, 64, 72, 80, 86, 92, 98, 104, 110, 116, 122,
    128, 134, 140, 146, 152, 159, 166, 173, 180, 189, 198, 207, 216, 226, 236, 246,
    256, 268, 280, 292, 304, 316, 328, 340, 352, 372, 392, 412, 432, 452, 472, 492,
], dtype=np.int32)

SPECS_START_SHORT = np.array([
    0, 32, 64, 96, 8, 40, 72, 104, 12, 44, 76, 108, 20, 52, 84, 116, 26, 58, 90, 122,
    128, 160, 192, 224, 134, 166, 198, 230, 141, 173, 205, 237, 150, 182, 214, 246,
    256, 288, 320, 352, 384, 416, 448, 480, 268, 300, 332, 364, 396, 428, 460, 492,
], dtype=np.int32)

BFU_AMOUNT_TAB = np.array([20, 28, 32, 36, 40, 44, 48, 52], dtype=np.int32)

# Scale factors 2^(i/3 - 21); stored in float32 because the encoder's
# lower_bound search and the decoder's dequantization both operate on the
# float32 values (atrac1.h:122-127).
SCALE_TABLE = np.power(2.0, np.arange(64) / 3.0 - 21.0).astype(np.float32)

# 32-point sine transition window sin((i+0.5)*pi/64) (atrac1.h:128-132).
SINE_WINDOW = np.sin((np.arange(32) + 0.5) * (np.pi / 64.0)).astype(np.float32)

# BFU index -> QMF band (0: <20, 1: <36, 2: rest).
BFU_TO_BAND = np.array([0] * 20 + [1] * 16 + [2] * 16, dtype=np.int32)

# Fixed bit-allocation blend tables (atrac1_bitalloc.cpp:37-47).
FIXED_BIT_ALLOC_LONG = np.array([
    7, 7, 7, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
    6, 6, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 4,
    4, 4, 3, 3, 3, 3, 3, 3, 2, 1, 1, 1, 1, 0, 0, 0,
], dtype=np.float32)

FIXED_BIT_ALLOC_SHORT = np.array([
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
    6, 6, 6, 6, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
    4, 4, 4, 4, 4, 4, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0,
], dtype=np.float32)

# Constant spread blend, tuned on EBU SQAM (atrac1_bitalloc.cpp:49-61).
BIT_ALLOC_SPREAD = 0.4

# Band bias constants (atrac1_bitalloc.cpp:140-143).
BAND_BIAS_GAIN = 0.3
BAND_BIAS_TILT_FLOOR = 7.0
BAND_BIAS_MAX = 1.5
BAND_BIAS_HIGH_RATIO = 0.5

# BFUs eligible for leftover-bit boosting (atrac1_bitalloc.cpp:63-67).
BIT_BOOST_MASK = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
    1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
], dtype=np.int32)

LOUD_FACTOR = 0.006  # atrac1denc.h:101


def available_bits(bfu_num):
    """Mantissa+WL+SFI bit budget for a frame with `bfu_num` BFUs.

    212*8 minus: 3 (BFU amount idx), 32 (8 block-mode + 24 trailing zero),
    2+3 (reserved) and per-BFU 4(WL)+6(SFI) bits (atrac1_bitalloc.cpp:247-251
    — note the budget there still includes the WL/SFI fields, the encoder
    compares it against mantissa bits only after subtracting them here).
    """
    return SOUND_UNIT_SIZE * 8 - BITS_PER_BFU_AMOUNT_TAB_IDX - 32 - 2 - 3 \
        - bfu_num * (BITS_PER_IDWL + BITS_PER_IDSF)


def gather_indices(starts):
    """[52, 20] spec-position gather matrix + validity mask for BFU blocks.

    Padded to the max block length (20); `mask` marks real positions.
    """
    maxlen = int(SPECS_PER_BLOCK.max())
    idx = np.zeros((MAX_BFUS, maxlen), dtype=np.int32)
    mask = np.zeros((MAX_BFUS, maxlen), dtype=bool)
    for b in range(MAX_BFUS):
        ln = SPECS_PER_BLOCK[b]
        idx[b, :ln] = starts[b] + np.arange(ln)
        mask[b, :ln] = True
    return idx, mask


GATHER_LONG, GATHER_MASK = gather_indices(SPECS_START_LONG)
GATHER_SHORT, _ = gather_indices(SPECS_START_SHORT)
