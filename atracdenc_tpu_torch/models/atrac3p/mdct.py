"""ATRAC3+ per-subband MDCT / IMDCT (sine windows), batched over frames.

Port of ``atracdenc_tpu/models/atrac3p/mdct.py`` (reference
src/atrac/at3p/at3p_mdct.cpp:52-100): per subband the MDCT input is [stored
previous half | falling-windowed current], the stored half being the
previous frame's samples under the rising window; odd subbands are
spectrum-reversed.
"""
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from atracdenc_tpu_torch.ops.mdct import mdct_matrix

SINE_WIN_128 = (2.0 * np.sin((np.arange(128) + 0.5)
                             * (np.pi / 256.0))).astype(np.float32)


def _win(x):
    return _window(x.dtype, x.device)


@lru_cache(maxsize=None)
def _window(dtype, dev):
    """The sine window on ``dev``, copied there once."""
    return torch.as_tensor(SINE_WIN_128, dtype=dtype, device=dev)


def _odd_flip(s):
    """Reverse the last axis of the odd subbands of [..., 16, 128]."""
    odd = (torch.arange(16, device=s.device) % 2 == 1)[:, None]
    return torch.where(odd, s.flip(-1), s)


def _prev_frame(x):
    """[..., F, 16, n] -> the previous frame's [..., F, 16, n], zeros first."""
    return F.pad(x[..., :-1, :, :], (0, 0, 0, 0, 1, 0))


def mdct_frames(bands):
    """[..., F, 16, 128] band samples -> specs [..., F, 2048]."""
    w = _win(bands)
    buf = torch.cat([_prev_frame(w * bands), w.flip(0) * bands], dim=-1)
    basis = mdct_matrix(256, 1.0 / 256.0, buf.dtype, buf.device)  # TMDCT<256>(1)
    spec = torch.matmul(buf, basis.t())
    return _odd_flip(spec).reshape(bands.shape[:-2] + (2048,))


def imdct_frames(specs):
    """QA inverse: [..., F, 2048] -> bands [..., F, 16, 128]; out[f]
    reconstructs input frame f-1 (OLA latency), as TAt3pMIDCT."""
    s = _odd_flip(specs.reshape(specs.shape[:-1] + (16, 128)))
    basis = mdct_matrix(256, 1.0, s.dtype, s.device)   # TMIDCT<256>(256)
    inv = torch.matmul(s, basis)
    w = _win(s)
    return inv[..., :128] * w + _prev_frame(inv[..., 128:] * w.flip(0))
