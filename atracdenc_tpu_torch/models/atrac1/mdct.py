"""ATRAC1 framed, windowed MDCT / IMDCT, batched over frames.

Port of ``atracdenc_tpu/models/atrac1/mdct.py`` (reference
src/atrac1denc.cpp:70-137).  The framing is linear in (the previous
frame's last 32 band samples, the current frame), so it folds into
precomputed matrices evaluated for all frames at once; the long and short
window variants are both computed and selected by the per-frame window
mask.  The matrices are built in f64 from ``ops/mdct.py::_mdct_matrix_np``
and cast to f32; the products are plain f32 matmuls (TF32 off).

Per band (atrac1denc.cpp:70-102):
  band 0 (low, 128 samples): long MDCT-256 (net scale 1/512), short 4 x MDCT-64
  band 1 (mid, 128):         same, spectrum reversed per MDCT block
  band 2 (hi, 256):          long MDCT-512 (1/512), short 8 x MDCT-64 with x2
                             level compensation, spectrum reversed per block
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch import runtime  # noqa: F401  (f32 policy)
from atracdenc_tpu_torch.ops.mdct import _mdct_matrix_np

__all__ = ["mdct_frames", "imdct_frames"]

_SINE64 = np.sin((np.arange(32) + 0.5) * np.pi / 64.0)  # 32-pt transition

_BANDS = (
    # (bufsz, N_long, long_scale, winstart, short_scale)
    (128, 256, 0.5 / 256.0, 48, 0.5 / 64.0),
    (128, 256, 0.5 / 256.0, 48, 0.5 / 64.0),
    (256, 512, 1.0 / 512.0, 112, 1.0 / 64.0),  # x2 level comp folded in
)


def _fwd_matrices_np(band):
    bufsz, n, lscale, winstart, sscale = _BANDS[band]
    m_long = _mdct_matrix_np(n)          # [n/2, n]
    m64 = _mdct_matrix_np(64)            # [32, 64]
    # long: spec = prev32 @ A + frame @ B
    a = np.zeros((32, bufsz))
    for i in range(32):
        a[i] = lscale * _SINE64[i] * m_long[:, winstart + i]
    b = np.zeros((bufsz, bufsz))
    for j in range(bufsz):
        w = _SINE64[31 - (j - (bufsz - 32))] if j >= bufsz - 32 else 1.0
        b[j] = lscale * w * m_long[:, winstart + 32 + j]
    # short: spec32 = prevblk32 @ R + blk32 @ F (fully sine-windowed 64-pt)
    r = np.zeros((32, 32))
    f = np.zeros((32, 32))
    for i in range(32):
        r[i] = sscale * _SINE64[i] * m64[:, i]
        f[i] = sscale * _SINE64[31 - i] * m64[:, 32 + i]
    return tuple(np.asarray(x, np.float32) for x in (a, b, r, f))


def _inv_matrices_np(band):
    bufsz, n, _, _, _ = _BANDS[band]
    m_long = _mdct_matrix_np(n)
    m64 = _mdct_matrix_np(64)
    # inv = spec @ (2 M); keep only the middle half [n/4, 3n/4)
    return (np.asarray(2.0 * m_long[:, n // 4: 3 * n // 4], np.float32),
            np.asarray(2.0 * m64[:, 16:48], np.float32))


@functools.lru_cache(maxsize=None)
def _fwd(band, dev):
    return tuple(torch.as_tensor(x, device=dev) for x in _fwd_matrices_np(band))


@functools.lru_cache(maxsize=None)
def _inv(band, dev):
    return tuple(torch.as_tensor(x, device=dev) for x in _inv_matrices_np(band))


@functools.lru_cache(maxsize=None)
def _sine(dev):
    sw = torch.as_tensor(_SINE64.astype(np.float32), device=dev)
    return sw[:16], sw[16:].flip(0)              # sw[:16], sw[31:15:-1]


def _reverse_blocks(spec, blk):
    """Reverse every ``blk``-sized group along the last axis."""
    shape = spec.shape
    return spec.reshape(shape[:-1] + (-1, blk)).flip(-1).reshape(shape)


def mdct_frames(band_frames, short_mask, band):
    """Windowed MDCT of one QMF band for all frames.

    band_frames [..., nF, bufsz] band samples, short_mask [..., nF] bool
    (True where this band uses short windows) -> specs [..., nF, bufsz]."""
    a, b, r, f = _fwd(band, band_frames.device)
    bufsz = band_frames.shape[-1]
    prev32 = torch.cat([torch.zeros_like(band_frames[..., :1, -32:]),
                        band_frames[..., :-1, -32:]], dim=-2)  # [..., nF, 32]
    spec_long = prev32 @ a + band_frames @ b
    blocks = band_frames.reshape(band_frames.shape[:-1] + (bufsz // 32, 32))
    prevblk = torch.cat([prev32[..., None, :], blocks[..., :-1, :]], dim=-2)
    spec_short = (prevblk @ r + blocks @ f).reshape(band_frames.shape)
    if band > 0:
        spec_long = _reverse_blocks(spec_long, bufsz)
        spec_short = _reverse_blocks(spec_short, 32)
    return torch.where(short_mask[..., None], spec_short, spec_long)


def _overlap(tail16, head16, sw_lo, sw_hi):
    """32-sample sine cross-fade (vector_fmul_window, atrac1denc.cpp:51-68):
    out[p] = tail[p] sw[31-p] - head[15-p] sw[p],
    out[31-p] = tail[p] sw[p] + head[15-p] sw[31-p]."""
    rev_head = head16.flip(-1)
    first = tail16 * sw_hi - rev_head * sw_lo
    second = (tail16 * sw_lo + rev_head * sw_hi).flip(-1)
    return torch.cat([first, second], dim=-1)


def imdct_frames(specs, short_mask, band):
    """Inverse of ``mdct_frames``: specs [..., nF, bufsz] -> band samples.

    The reference overlap-add (atrac1denc.cpp:103-137): a 32-sample sine
    cross-fade at every MDCT block boundary, a rectangular centre for long
    blocks, and the 16-sample tail carried across frames (computed per
    frame and shifted by one frame, so there is no recurrence)."""
    inv_long, inv_short = _inv(band, specs.device)
    sw_lo, sw_hi = _sine(specs.device)
    bufsz = specs.shape[-1]
    spec_long = _reverse_blocks(specs, bufsz) if band > 0 else specs
    spec_short = _reverse_blocks(specs, 32) if band > 0 else specs

    invbuf = spec_long @ inv_long                             # [..., nF, bufsz]
    tail_long = invbuf[..., bufsz - 16:]
    blocks = spec_short.reshape(specs.shape[:-1] + (bufsz // 32, 32))
    invblk = blocks @ inv_short                               # [..., nF, nblk, 32]
    tail_short = invblk[..., -1, 16:]

    # the previous frame's carried tail follows ITS window mode
    tail = torch.where(short_mask[..., None], tail_short, tail_long)
    prev_tail = torch.cat([torch.zeros_like(tail[..., :1, :]),
                           tail[..., :-1, :]], dim=-2)

    out_long = torch.cat([_overlap(prev_tail, invbuf[..., :16], sw_lo, sw_hi),
                          invbuf[..., 16:bufsz - 16]], dim=-1)
    # short: chain the overlaps through the frame's blocks
    tails = torch.cat([prev_tail[..., None, :], invblk[..., :-1, 16:]], dim=-2)
    out_short = _overlap(tails, invblk[..., :16], sw_lo, sw_hi
                         ).reshape(specs.shape)
    return torch.where(short_mask[..., None], out_short, out_long)
