"""ATRAC3 windowed MDCT with gain modulation, batched over frames.

Port of the encoder half of ``atracdenc_tpu/models/atrac3/mdct.py``
(reference src/atrac3denc.cpp:33-91 + gain_processor.h): the MDCT input is
[stored previous half | windowed current half]; the stored half is the
previous frame's current half, windowed and divided by that frame's gain
divisor curve, and is divided again by the current frame's first gain
level.  Divisor curves come from a float32 ramp table, so the reference's
sequential ``level *= gainInc`` is reproduced exactly.
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch.shared import tables as T
from atracdenc_tpu_torch.ops.mdct import mdct_matrix


@functools.lru_cache(maxsize=None)
def _ramp_table_np() -> np.ndarray:
    """[16, 16, 8] float32: sequential level * inc^k products for a ramp
    from level index `cur` toward `next` (gain_processor.h:108-118)."""
    out = np.empty((16, 16, T.LOC_SZ), np.float32)
    for cur in range(16):
        for nxt in range(16):
            inc = T.GAIN_INTERPOLATION[nxt - cur + T.GAIN_INTERPOLATION_POS_SHIFT]
            level = T.GAIN_LEVEL[cur]
            for k in range(T.LOC_SZ):
                out[cur, nxt, k] = level
                level = np.float32(level * inc)
    return out


@functools.lru_cache(maxsize=None)
def _consts(dev):
    return {"ramp": torch.as_tensor(_ramp_table_np().reshape(256, T.LOC_SZ),
                                    device=dev),
            "level": torch.as_tensor(T.GAIN_LEVEL, device=dev),
            "enc_win": torch.as_tensor(T.ENCODE_WINDOW, device=dev)}


def gain_divisors(levels, locs, npoints):
    """Per-sample divisor curves from gain points.

    levels, locs [..., P] int (P <= 8, arbitrary beyond npoints),
    npoints [...] int.  Returns div [..., 256] f32 (ones when npoints == 0).
    Points are 8-sample aligned and strictly ascending, so each 8-sample
    block is one point's ramp or a constant level."""
    c = _consts(levels.device)
    p = levels.shape[-1]
    batch = levels.shape[:-1]
    levels = levels.reshape(-1, p).long()
    locs = locs.reshape(-1, p).long()
    np_f = npoints.reshape(-1).long()
    slot = torch.arange(p, device=levels.device)
    valid = slot < np_f[:, None]
    locb = torch.where(valid, locs, 64)
    lev = torch.where(valid, levels, T.EXPONENT_OFFSET)
    lev_ext = torch.cat([lev, torch.full_like(lev[:, :1], 4)], dim=-1)

    b = torch.arange(256 // T.LOC_SZ, device=levels.device)
    # level of the constant region at block b: the first point after it
    sel = torch.sum(locb[:, None, :] <= b[None, :, None], dim=-1)
    sel = torch.minimum(sel, np_f[:, None])                       # [L, 32]
    const_div = c["level"][torch.gather(lev_ext, 1, sel)]

    # point p's own block ramps from lev[p] toward lev_ext[p+1]
    cn = torch.where(valid, lev * 16 + lev_ext[:, 1:], 255)
    rampvals = c["ramp"][cn]                                      # [L, P, 8]
    oh_b = locb[:, None, :] == b[None, :, None]                   # [L, 32, P]
    has_ramp = oh_b.any(-1)
    ramp_idx = torch.argmax(oh_b.to(torch.int32), dim=-1)         # [L, 32]
    ramp_b = torch.gather(
        rampvals, 1, ramp_idx[..., None].expand(-1, -1, T.LOC_SZ))
    div_b = torch.where(has_ramp[..., None], ramp_b, const_div[..., None])
    div = div_b.reshape(div_b.shape[0], 256)
    div = torch.where((np_f > 0)[:, None], div, 1.0)
    return div.reshape(batch + (256,))


def first_level_scale(levels, npoints):
    """GainLevel[first point] or 1.0 when no points (gain_processor.h:97)."""
    lev0 = torch.where(npoints > 0, levels[..., 0], T.EXPONENT_OFFSET)
    return _consts(levels.device)["level"][lev0.long()]


def mdct_frames(bands, div=None, scale=None, prev_half=None):
    """Forward windowed MDCT over a whole track (or one exact chunk).

    bands [..., F, 4, 256] (QMF output, /4 scaled), div [..., F, 4, 256]
    gain divisor curves (optional), scale [..., F, 4] first-level scale of
    the current frame's curve, prev_half [..., 4, 256] carried windowed
    half from the frame before (zeros at track start).
    Returns specs [..., F, 1024] (odd bands spectrum-reversed,
    atrac3denc.cpp:52-54)."""
    win = _consts(bands.device)["enc_win"]
    cur = bands if div is None else bands / div
    stored = win * cur
    if prev_half is None:
        prev_half = torch.zeros_like(stored[..., 0, :, :])
    prev = torch.cat([prev_half[..., None, :, :], stored[..., :-1, :, :]],
                     dim=-3)
    if scale is not None:
        prev = prev / scale[..., None]
    tail = torch.flip(win, [0]) * cur
    buf = torch.cat([prev, tail], dim=-1)                         # [..., F, 4, 512]
    basis = mdct_matrix(512, 1.0 / 512.0, buf.dtype, buf.device)
    spec = torch.matmul(buf, basis.t())                           # [..., F, 4, 256]
    spec = torch.stack([spec[..., 0, :], torch.flip(spec[..., 1, :], [-1]),
                        spec[..., 2, :], torch.flip(spec[..., 3, :], [-1])],
                       dim=-2)
    return spec.reshape(bands.shape[:-2] + (1024,))
