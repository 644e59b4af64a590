"""Kernel A: plain-rounding quantisation costs for all 8 wordlens.

Counterpart of ``atracdenc_tpu/ops/pallas_quant.py::quant_cost_plain``.
The CUDA kernel is ``csrc/quant_cost.cu`` (its header says what bounds it
on an H100 and how it is laid out); its plain version, ``quant_cost_torch``,
computes ``bitalloc._plain_costs_xla`` of the JAX package one wordlen at a
time (so the [N, 32, 8, 128] broadcast is never materialised), with the
kernel's inline sanitisation (NaN -> 0, inf -> FLT_MAX).
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch.shared import tables as T
from atracdenc_tpu_torch import kernels

MAX_WL = 8

# launches of the CUDA kernel (the plain version is not counted)
launches = 0


def vlc_step_table() -> np.ndarray:
    """[7, 64] bit length of symbol idx under codebook sel, as the step
    function of the JAX package's ``bitalloc._vlc_bits_arith`` (the last
    length holds past the table's end)."""
    tab = np.zeros((7, 64), np.int32)
    for sel in range(7):
        lens = T.VLC_BITS[sel]
        out = np.full(64, int(lens[0]), np.int32)
        prev = int(lens[0])
        for j in range(1, 63):
            if lens[j] == 0:
                break
            d = int(lens[j]) - prev
            if d:
                out[j:] += d
            prev = int(lens[j])
        tab[sel] = out
    return tab


@functools.lru_cache(maxsize=None)
def _consts(dev):
    return {"maxq": torch.as_tensor(T.MAX_QUANT, device=dev),
            "vlc_step": torch.as_tensor(vlc_step_table(), device=dev)}


def vlc_bits(idx, sel):
    """Bit length of symbol indices ``idx`` (int tensor) in codebook
    ``sel`` (python int 0..6)."""
    tab = _consts(idx.device)["vlc_step"][sel]
    return tab[idx.clamp(max=63).long()]


def vlc_index(m):
    """Single-mantissa VLC symbol index: 0 -> 0, m > 0 -> 2m-1, m < 0 -> -2m."""
    return torch.where(m < 0, -m * 2, torch.where(m > 0, m * 2 - 1, 0))


def sanitize(err):
    """NaN -> 0, +inf -> FLT_MAX (bitalloc.quant_tensors' select-safe map)."""
    fmax = torch.finfo(torch.float32).max
    return torch.where(torch.isnan(err), 0.0,
                       torch.where(torch.isinf(err), fmax, err))


def quant_cost_torch(scaled, valid_mask):
    """Plain version.  scaled [..., 32, 128] f32, valid_mask [32, 128] bool
    -> (err [..., 32, 8] f32, vlc [..., 32, 8] i32)."""
    maxq = _consts(scaled.device)["maxq"]
    e1 = torch.sum(torch.where(valid_mask, scaled * scaled, 0.0), dim=-1)
    errs, vlcs = [], []
    for w in range(MAX_WL):
        mul = maxq[w]
        mant = torch.where(valid_mask, torch.round(scaled * mul), 0.0)
        e2 = torch.sum(mant * mant, dim=-1) * (1.0 / (mul * mul))
        errs.append(sanitize(e1 / e2))
        bits = vlc_bits(vlc_index(mant.to(torch.int32)), min(max(w - 1, 0), 6))
        vlcs.append(torch.sum(torch.where(valid_mask, bits, 0), dim=-1,
                              dtype=torch.int32))
    return torch.stack(errs, dim=-1), torch.stack(vlcs, dim=-1)


def quant_cost_plain(scaled, valid_mask):
    """scaled [..., 32, 128] f32, valid_mask [32, 128] bool ->
    (err [..., 32, 8] f32, vlc [..., 32, 8] i32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    if scaled.device.type == "cpu":
        return quant_cost_torch(scaled, valid_mask)
    global launches
    lib = kernels.library()
    if scaled.dtype != torch.float32 or tuple(scaled.shape[-2:]) != (32, 128):
        raise ValueError(f"quant_cost_plain: need [..., 32, 128] f32, got "
                         f"{tuple(scaled.shape)} {scaled.dtype}")
    if tuple(valid_mask.shape) != (32, 128):
        raise ValueError("quant_cost_plain: valid_mask must be [32, 128]")
    lead = scaled.shape[:-2]
    x = scaled.contiguous()
    mask = valid_mask.to(device=x.device, dtype=torch.uint8).contiguous()
    n_blocks = x.numel() // 128
    err = torch.empty(lead + (32, MAX_WL), dtype=torch.float32, device=x.device)
    vlc = torch.empty(lead + (32, MAX_WL), dtype=torch.int32, device=x.device)
    kernels.require_cuda("quant_cost_plain", x, mask, err, vlc)
    kernels.check(lib.atrac3_quant_cost_plain(
        x.data_ptr(), mask.data_ptr(), err.data_ptr(), vlc.data_ptr(),
        n_blocks, kernels.stream_ptr(x)), "quant_cost_plain")
    launches += 1
    return err, vlc
