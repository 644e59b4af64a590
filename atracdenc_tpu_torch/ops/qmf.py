"""Two-band QMF analysis as a blocked-Toeplitz matmul.

Port of ``atracdenc_tpu/ops/qmf.py::qmf_analysis``: the reference's 48-tap
polyphase QMF with 46 samples of history (src/qmf/qmf.h:47-64) equals one
stride-2 FIR over the whole track with zero initial history, written as
dense [*, 174] x [174, 128] products.  ``torch.matmul`` keeps it in f32 on
CUDA (runtime turns TF32 off); ``conv1d`` would go to cuDNN.
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch import runtime  # noqa: F401  (f32 policy)

__all__ = ["QMF_WINDOW", "qmf_analysis"]

# 24 half-taps of the 48-tap symmetric prototype lowpass (reference
# src/qmf/qmf.cpp:25-32; the full window is TapHalf mirrored, x2)
_TAP_HALF = np.array([
    -0.00001461907, -0.00009205479, -0.000056157569, 0.00030117269,
    0.0002422519, -0.00085293897, -0.0005205574, 0.0020340169,
    0.00078333891, -0.0042153862, -0.00075614988, 0.0078402944,
    -0.000061169922, -0.01344162, 0.0024626821, 0.021736089,
    -0.007801671, -0.034090221, 0.01880949, 0.054326009,
    -0.043596379, -0.099384367, 0.13207909, 0.46424159,
], dtype=np.float64)

QMF_WINDOW = np.concatenate([_TAP_HALF, _TAP_HALF[::-1]]) * 2.0  # [48]

_BLOCK_IN = 128     # input samples per output block (64 outputs at stride 2)
_WIN = 174          # window per block: 126 + 48-tap reach


def _analysis_matrix() -> np.ndarray:
    """[174, 128] Toeplitz bank: col u = lower[64j+u], col 64+u = upper."""
    a = np.zeros(47, np.float64)
    b = np.zeros(47, np.float64)
    a[0:47:2] = QMF_WINDOW[0:47:2]   # even taps -> lower
    b[1:47:2] = QMF_WINDOW[1:47:2]   # odd taps  -> upper
    ka = a[::-1].astype(np.float32)
    kb = b[::-1].astype(np.float32)
    w = np.zeros((_WIN, _BLOCK_IN), np.float32)
    for u in range(64):
        w[2 * u:2 * u + 47, u] = ka
        w[2 * u:2 * u + 47, 64 + u] = kb
    return w


@functools.lru_cache(maxsize=None)
def _analysis_w(dev):
    return torch.as_tensor(_analysis_matrix(), device=dev)


def _blocked_fir(x, w, pad_lo):
    """Stride-2 FIR bank: x [..., T] -> [..., T/128, 128], block j reading
    x_ext[128j : 128j+174] with x_ext = pad(x, (pad_lo, 46-pad_lo))."""
    t_in = x.shape[-1]
    t = -(-t_in // _BLOCK_IN) * _BLOCK_IN
    j = t // _BLOCK_IN
    batch = x.shape[:-1]
    x_ext = torch.nn.functional.pad(x, (pad_lo, t - t_in + 46 - pad_lo))
    z1 = x_ext[..., :t].reshape(batch + (j, _BLOCK_IN))
    tail = x_ext[..., t:]
    z2 = torch.cat([z1[..., 1:, :46], tail[..., None, :]], dim=-2)
    win = torch.cat([z1, z2], dim=-1)                 # [..., j, 174]
    return torch.matmul(win, w)


def qmf_analysis(x):
    """Split [..., T] (T % 128 == 0) into (sum, diff) half-rate bands
    [..., T/2]."""
    out = _blocked_fir(x, _analysis_w(x.device), pad_lo=45)
    j = out.shape[-2]
    half = x.shape[-1] // 2
    lower = out[..., :64].reshape(x.shape[:-1] + (j * 64,))[..., :half]
    upper = out[..., 64:].reshape(x.shape[:-1] + (j * 64,))[..., :half]
    return lower + upper, lower - upper
