"""ATRAC3+ format constants.

Numeric codebooks (spectrum/wordlen/code-table/tone VLCs, mantissa and scale
tables, PQF prototype) are facts of the ATRAC3+ format inherited from the
ffmpeg decoder tables; they are bundled in format_data.npz, extracted
programmatically from the reference build (reference:
src/atrac/at3p/at3p_tables.cpp, src/atrac/at3p/ff/atrac3plus_data.h,
src/atrac/atrac3plus_pqf/atrac3plus_pqf_data.h).  Structural layout tables
below are transcribed from src/atrac/at3p/at3p_tables.h:44-77 and
src/atrac/at3p/ff/atrac3plus_data.h:154-162.
"""
import os

import numpy as np

NUM_SAMPLES = 2048         # PCM samples per frame per channel
FRAME_BYTES = 2048         # fixed 352.8 kbit/s frame
MAX_BFUS = 32              # quant units
NUM_SUBBANDS = 16
SUBBAND_SIZE = 128

_DATA = np.load(os.path.join(os.path.dirname(__file__), "format_data.npz"))

SCALE_TABLE = _DATA["scale_table"]            # [64] float32, normalized
MANT_TAB = _DATA["mant_tab"]                  # [8] quant step per wordlen
INV_MANT_TAB = _DATA["inv_mant"]              # [8] 1/step (0 unused)
SPEC_CODE = _DATA["spec_code"].astype(np.int32)   # [112, 256]
SPEC_LEN = _DATA["spec_len"].astype(np.int32)
SPECTRA_TABS = _DATA["spectra_tabs"].astype(np.int32)  # [112, 4]: group_size,
                                                       # num_coeffs, bits, signed
WL_CODE = _DATA["wl_code"].astype(np.int32)   # [4, 8] wordlen delta VLCs
WL_LEN = _DATA["wl_len"].astype(np.int32)
CT_CODE = _DATA["ct_code"].astype(np.int32)   # [4, 8] code-table VLCs
CT_LEN = _DATA["ct_len"].astype(np.int32)
TONE_BANDS_CODE = _DATA["tone_bands_code"].astype(np.int32)  # [16]
TONE_BANDS_LEN = _DATA["tone_bands_len"].astype(np.int32)
PQF_FIR = _DATA["pqf_fir"]                    # [384] analysis prototype
IPQF_COEFFS1 = _DATA["ipqf_coeffs1"]          # [12, 16]
IPQF_COEFFS2 = _DATA["ipqf_coeffs2"]

# quant-unit layout (at3p_tables.h:58-76)
BLOCK_SIZE_TAB = np.array([
    0, 16, 32, 48, 64, 80, 96, 112,
    128, 160, 192, 224, 256, 288, 320, 352,
    384, 448, 512, 576, 640, 704, 768, 896,
    1024, 1152, 1280, 1408, 1536, 1664, 1792, 1920,
    2048,
], dtype=np.int32)
SPECS_PER_BLOCK = np.diff(BLOCK_SIZE_TAB).astype(np.int32)
SPECS_START = BLOCK_SIZE_TAB[:32].copy()
BLOCKS_PER_BAND = np.array(
    [0, 8, 12, 16, 18, 20, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32],
    dtype=np.int32)
MAX_SPECS_PER_BLOCK = 128

# fixed per-QU wordlen allocation (at3p_bitstream.cpp:107-112)
FIXED_WORDLEN = np.array([
    7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7,
    7, 6, 6, 6, 6, 6, 6, 6,
    6, 6, 5, 5, 4, 3, 2, 1,
], dtype=np.int32)

# quant unit -> subband; subband -> power-compensation group count
# (atrac3plus_data.h:154-162)
QU_TO_SUBBAND = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2,
    3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
], dtype=np.int32)
SUBBAND_TO_NUM_POWGRPS = np.array(
    [1, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 5, 5, 5, 5, 5], dtype=np.int32)

# residual scaling before the MDCT (at3p.cpp:147-152, incl. the +0.5 dB fudge)
RESIDUAL_SCALE = 1.0 / (32768.0 / 1.122018)


def gather_indices():
    """[32, 128] spec-position gather matrix + validity mask for QU blocks."""
    idx = np.zeros((MAX_BFUS, MAX_SPECS_PER_BLOCK), dtype=np.int32)
    mask = np.zeros((MAX_BFUS, MAX_SPECS_PER_BLOCK), dtype=bool)
    for b in range(MAX_BFUS):
        ln = SPECS_PER_BLOCK[b]
        idx[b, :ln] = SPECS_START[b] + np.arange(ln)
        mask[b, :ln] = True
    return idx, mask


GATHER_IDX, GATHER_MASK = gather_indices()
