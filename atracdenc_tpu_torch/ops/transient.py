"""ATRAC1 transient detection over a whole band signal.

Port of ``atracdenc_tpu/ops/transient.py`` (reference
src/transient_detector.cpp:52-93, transient_detector.h:30-50): a 21-tap
high-pass FIR, the RMS of each 16-sample block in dB, and attack / release
thresholds against the previous block's level, carried across frames.  The
whole signal is filtered at once and the carried level is a one-block
shift.  The FIR is a fixed-order sum of its 22 taps on shifted views (no
``conv1d``, which would go to cuDNN).
"""
import numpy as np
import torch

__all__ = ["hpf", "transient_mask"]

# 10 half-taps of the 21-tap symmetric HPF (transient_detector.cpp:52-57;
# the *2.0 is part of the table there)
_FIRCOEF = np.array([
    -8.65163e-18, -0.00851586, -6.74764e-18, 0.0209036,
    -3.36639e-17, -0.0438162, -1.54175e-17, 0.0931738,
    -5.52212e-17, -0.313819,
], dtype=np.float64) * 2.0


def _hpf_kernel():
    """22 taps h with out[t] = sum_k h[k] * x[t + k - 20]."""
    h = np.zeros(22, dtype=np.float64)
    h[10] = 1.0
    for j in range(10):
        h[j] = _FIRCOEF[j]
        h[21 - j] = _FIRCOEF[j]
    return (h / 2.0).astype(np.float32)


_HPF = [float(v) for v in _hpf_kernel()]


def hpf(x):
    """High-pass filter a [..., T] band signal (zero initial history)."""
    t = x.shape[-1]
    xp = torch.nn.functional.pad(x, (20, 1))
    out = _HPF[0] * xp[..., 0:t]
    for k in range(1, 22):
        out = out + _HPF[k] * xp[..., k:k + t]
    return out


def transient_mask(band, frame_sz, short_sz=16):
    """Per-frame transient flags of a [..., T] band signal -> bool [..., T
    // frame_sz].  Attack: a rise of > 16 dB between adjacent 16-sample
    blocks; release: a drop of > 20 dB; the previous level starts at 0 dB.
    A silent block is -inf dB, and -inf - -inf is NaN, which compares
    false, as the reference's C floats do."""
    filtered = hpf(band)
    lead = band.shape[:-1]
    sq = filtered.reshape(lead + (-1, short_sz))
    rms = torch.sqrt(torch.mean(sq * sq, dim=-1))
    db = 19.0 * torch.log10(rms)
    prev = torch.cat([torch.zeros(lead + (1,), dtype=db.dtype, device=db.device),
                      db[..., :-1]], dim=-1)
    hit = ((db - prev) > 16.0) | ((prev - db) > 20.0)
    return torch.any(hit.reshape(lead + (-1, frame_sz // short_sz)), dim=-1)
