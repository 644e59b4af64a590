"""Psychoacoustic helpers: ATH, loudness curve and the loudness IIR.

Port of ``atracdenc_tpu/ops/psy.py`` for the ATRAC3 and ATRAC1 encoders
(reference src/atrac/atrac_psy_common.{h,cpp}).  The table builders are
numpy; the per-frame loudness recurrence is each encoder's one true
sequential dependency and runs as a loop of f32 ops in frame order.
"""
import numpy as np
import torch

from atracdenc_tpu_torch import runtime, trace

__all__ = ["ath_formula_frank", "calc_ath", "ath_per_bfu",
           "create_loudness_curve", "track_loudness_scan"]

# Absolute-threshold-of-hearing table in millibel rel 20 uPa, 4 points per
# third starting at 10 Hz (atrac_psy_common.cpp:33-95).
_FRANK_TAB = np.array([
    9669, 9669, 9626, 9512, 9353, 9113, 8882, 8676,
    8469, 8243, 7997, 7748, 7492, 7239, 7000, 6762,
    6529, 6302, 6084, 5900, 5717, 5534, 5351, 5167,
    5004, 4812, 4638, 4466, 4310, 4173, 4050, 3922,
    3723, 3577, 3451, 3281, 3132, 3036, 2902, 2760,
    2658, 2591, 2441, 2301, 2212, 2125, 2018, 1900,
    1770, 1682, 1594, 1512, 1430, 1341, 1260, 1198,
    1136, 1057, 998, 943, 887, 846, 744, 712,
    693, 668, 637, 606, 580, 555, 529, 502,
    475, 448, 422, 398, 375, 351, 327, 322,
    312, 301, 291, 268, 246, 215, 182, 146,
    107, 61, 13, -35, -96, -156, -179, -235,
    -295, -350, -401, -421, -446, -499, -532, -535,
    -513, -476, -431, -313, -179, 8, 203, 403,
    580, 736, 881, 1022, 1154, 1251, 1348, 1421,
    1479, 1399, 1285, 1193, 1287, 1519, 1914, 2369,
    3352, 4352, 5352, 6352, 7352, 8352, 9352, 9999,
    9999, 9999, 9999, 9999,
], dtype=np.float64)


def ath_formula_frank(freq):
    """ATH in dB at `freq` Hz (scalar or array)."""
    f = np.clip(np.asarray(freq, dtype=np.float64), 10.0, 29853.0)
    freq_log = 40.0 * np.log10(0.1 * f)
    index = freq_log.astype(np.int64)
    frac = freq_log - index
    return 0.01 * (_FRANK_TAB[index] * (1.0 - frac)
                   + _FRANK_TAB[index + 1] * frac)


def calc_ath(length, sample_rate):
    """Per-spectral-line ATH in dB (atrac_psy_common.cpp:126-140)."""
    mf = sample_rate / 2000.0
    i = np.arange(length, dtype=np.float64)
    f_khz = (i + 1.0) * mf / length
    trh = ath_formula_frank(1.0e3 * f_khz) - 100.0
    trh -= f_khz * f_khz * 0.015
    return trh


def ath_per_bfu(specs_start, specs_per_block) -> np.ndarray:
    """Min ATH power over each BFU's lines (atrac3_bitstream.cpp:772-788);
    the JAX package's ``tables.ath_per_bfu``."""
    ath_spec = calc_ath(1024, 44100)
    return np.array([10.0 ** (0.1 * ath_spec[s: s + n].min())
                     for s, n in zip(specs_start, specs_per_block)])


def create_loudness_curve(sz):
    """Equal-loudness weighting per spectral line
    (atrac_psy_common.cpp:142-156)."""
    i = np.arange(sz, dtype=np.float64)
    f = (i + 3.0) * 0.5 * 44100.0 / sz
    t = np.log10(f) - 3.5
    t = -10.0 * t * t + 3.0 - f / 3000.0
    return np.power(10.0, 0.1 * t).astype(np.float32)


@trace.span("loudness_scan")
def track_loudness_scan(l0, l1, use_both, use_one, init):
    """Per-frame loudness IIR over the last axis (frames).

    l0, l1 [..., F] f32, use_both / use_one [F] or [..., F] bool (ATRAC1
    gates them per stream by its window modes), init [...] f32.
      if use_both: L = 0.98 L + 0.01 (l0 + l1)
      elif use_one: L = 0.98 L + 0.02 l0
    Returns the post-update loudness per frame [..., F].

    Sequential in frame order, never reassociated: the regrouped sum
    differs in the last ulp, and those ulps cross ATH-gate knife edges
    (atracdenc_tpu/ops/psy.py:76-83)."""
    a = torch.where(use_both | use_one, 0.98, 1.0).to(l0.dtype)
    b = torch.where(use_both, 0.01 * (l0 + l1),
                    torch.where(use_one, 0.02 * l0, 0.0)).to(l0.dtype)
    carry = runtime.from_host(init, l0.device, l0.dtype)
    carry = carry.expand(l0.shape[:-1])
    out = []
    for k in range(l0.shape[-1]):
        carry = a[..., k] * carry + b[..., k]
        out.append(carry)
    return torch.stack(out, dim=-1)
