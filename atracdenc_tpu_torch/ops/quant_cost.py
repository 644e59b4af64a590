"""Kernels A and D: the ATRAC3 quantisation-cost memo.

Counterparts of ``atracdenc_tpu/ops/pallas_quant.py``:

* A, ``quant_cost_plain``: plain-rounding costs of all 8 wordlens.  The
  CUDA kernel is ``csrc/quant_cost.cu``; its plain version,
  ``quant_cost_torch``, computes ``bitalloc._plain_costs_xla`` of the JAX
  package one wordlen at a time (so the [N, 32, 8, 128] broadcast is never
  materialised), with the kernel's inline sanitisation (NaN -> 0,
  inf -> FLT_MAX).
* D, ``quant_cost_full``: the complete memo in one kernel
  (``csrc/quant_full.cu``): the plain lanes, the energy-adjusted (EA)
  overlay on BFUs 19-31 and the wl==1 pair codebook.  Its plain version,
  ``quant_cost_full_torch``, is ``memo`` on the plain versions of A and B.

``memo`` is the one copy of the memo's arithmetic: the ATRAC3 encoder runs
it on kernels A and B by default, and D computes the same function.
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch.models.atrac3 import tables as T
from atracdenc_tpu_torch import kernels, trace
from atracdenc_tpu_torch.ops.greedy import greedy_torch
from atracdenc_tpu_torch.ops.quant import (_flip_dn, _flip_up, _round_energy,
                                           quant_blocks)

MAX_WL = 8


def ea_groups():
    """EA-region BFU runs grouped by block length: [(b, e, len), ...],
    i.e. (19, 26, 32), (26, 30, 64), (30, 32, 128)."""
    groups = []
    b = T.LOSY_NAQ_START + 1
    while b < T.MAX_BFUS:
        ln = int(T.SPECS_PER_BLOCK[b])
        e = b
        while e < T.MAX_BFUS and int(T.SPECS_PER_BLOCK[e]) == ln:
            e += 1
        groups.append((b, e, ln))
        b = e
    return groups


def pair_bits_table() -> np.ndarray:
    """[9] bit length of the wl==1 pair symbol with key 3(a+1) + (b+1)."""
    return np.array([T.VLC_BITS[0, T.VLC_PAIR_RTAB[k]] for k in range(9)],
                    np.int32)


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
            "vlc_step": torch.as_tensor(vlc_step_table(), device=dev),
            "pair_bits": torch.as_tensor(pair_bits_table(), device=dev)}


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


def _kernel_tensors(scaled, valid_mask):
    """(x, mask, err, vlc) as kernels A and D take them.  A contiguous
    ``scaled`` and a bool (or uint8) mask on its device are passed as they
    are: a bool tensor is one byte of 0 or 1 an element, so it is viewed as
    uint8, never cast."""
    x = scaled.contiguous()
    mask = valid_mask.to(x.device).contiguous()
    mask = mask.view(torch.uint8) if mask.dtype == torch.bool \
        else mask.to(torch.uint8)
    shape = scaled.shape[:-1] + (MAX_WL,)
    return (x, mask, torch.empty(shape, dtype=torch.float32, device=x.device),
            torch.empty(shape, dtype=torch.int32, device=x.device))


def quant_cost_plain(scaled, valid_mask):
    """scaled [..., 32, 128] f32, valid_mask [32, 128] bool ->
    (err [..., 32, 8] f32, vlc [..., 32, 8] i32).

    ``valid_mask`` is the mask by block length (``tables.GATHER_MASK``), or
    that mask with further values switched off: the kernel reads no mask
    byte at or beyond a block's ``SPECS_PER_BLOCK``.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    if scaled.device.type == "cpu":
        return quant_cost_torch(scaled, valid_mask)
    lib = kernels.library()
    if scaled.dtype != torch.float32 or tuple(scaled.shape[-2:]) != (32, 128):
        raise ValueError(f"quant_cost_plain: need [..., 32, 128] f32, got "
                         f"{tuple(scaled.shape)} {scaled.dtype}")
    if tuple(valid_mask.shape) != (32, 128):
        raise ValueError("quant_cost_plain: valid_mask must be [32, 128]")
    x, mask, err, vlc = _kernel_tensors(scaled, valid_mask)
    kernels.require_cuda("quant_cost_plain", x, mask, err, vlc)
    kernels.check(lib.atrac3_quant_cost_plain(
        x.data_ptr(), mask.data_ptr(), err.data_ptr(), vlc.data_ptr(),
        x.numel() // (32 * 128), kernels.stream_ptr(x)), "quant_cost_plain")
    trace.count("launch.quant_cost")
    return err, vlc


def memo(scaled, valid_mask, plain, scan):
    """The complete memo (the reference TEncCache) from the plain lanes of
    ``plain`` (``quant_cost_plain`` or ``quant_cost_torch``), the EA overlay
    through ``quant_blocks`` with the accept recurrence ``scan``
    (``greedy_scan`` or ``greedy_torch``), and the wl==1 pair codebook.

    scaled [..., 32, 128] f32, valid_mask [32, 128] bool -> (err
    [..., 32, 8] f32 (e1/e2, sanitised), vlc [..., 32, 8] i32).  EA lanes
    add their VLC cost as per-flip deltas inside the greedy pass; the wl==1
    pair codebook needs actual mantissas, so that lane runs in mantissa
    mode."""
    c = _consts(scaled.device)
    err, vlc = plain(scaled, valid_mask)
    pair1 = torch.where(valid_mask, torch.round(scaled * c["maxq"][1]), 0.0
                        ).to(torch.int32)

    for b, e, ln in ea_groups():
        sub = scaled[..., b:e, None, :ln].expand(
            scaled.shape[:-2] + (e - b, MAX_WL - 1, ln))    # wl 1..7
        subv = valid_mask[b:e, None, :ln]
        subm = c["maxq"][1:].expand(sub.shape[:-1])
        ones = torch.ones(subm.shape, dtype=torch.bool, device=scaled.device)
        # wl==1 lane in mantissa mode (pair codes need the values)
        ea_m1, ea_e1 = quant_blocks(sub[..., 0, :], subv[:, 0], subm[..., 0],
                                    ones[..., 0], scan=scan)
        pair1[..., b:e, :ln] = ea_m1
        err[..., b:e, 1] = ea_e1
        # wl 2..7 in cost mode, with the per-candidate VLC bit delta of the
        # flip quant_blocks would make; _round_energy is where quant_blocks
        # takes m_old, e1 and e2 from, so the up/dn branch is its branch
        sub2 = sub[..., 1:, :]
        m2 = subm[..., 1:]
        m_old, e1g, e2g = _round_energy(sub2, subv, m2)
        m_new = torch.where((e2g < e1g)[..., None],
                            _flip_up(m_old, sub2 * m2[..., None] > 0),
                            _flip_dn(m_old))
        dbits = torch.stack(
            [vlc_bits(vlc_index(m_new[..., w - 2, :]), min(w - 1, 6))
             - vlc_bits(vlc_index(m_old[..., w - 2, :]), min(w - 1, 6))
             for w in range(2, MAX_WL)], dim=-2).to(torch.int32)
        ea_err, ea_db = quant_blocks(sub2, subv, m2, ones[..., 1:], aux=dbits,
                                     scan=scan)
        err[..., b:e, 2:] = ea_err
        vlc[..., b:e, 2:] += ea_db

    # wl==1 pairs: (a+1)*3 + (b+1) -> table-1 index
    pairs = pair1.reshape(pair1.shape[:-1] + (64, 2))
    key = 3 * (pairs[..., 0] + 1) + (pairs[..., 1] + 1)
    bits_pair = c["pair_bits"][key.clamp(0, 8).long()]
    pair_valid = valid_mask.reshape(32, 64, 2)[..., 0]
    vlc[..., 1] = torch.sum(torch.where(pair_valid, bits_pair, 0), dim=-1,
                            dtype=torch.int32)
    # non-finite err lanes -> select-safe values with the same boost
    # decisions (NaN -> 0, +inf -> FLT_MAX)
    return sanitize(err), vlc


def quant_cost_full_torch(scaled, valid_mask):
    """Plain version of kernel D: ``memo`` on the plain versions of kernels
    A and B, so it launches no kernel on any device."""
    return memo(scaled, valid_mask, quant_cost_torch, greedy_torch)


def quant_cost_full(scaled, valid_mask):
    """scaled [..., 32, 128] f32, valid_mask [32, 128] bool ->
    (err [..., 32, 8] f32, vlc [..., 32, 8] i32): the complete memo.
    ``valid_mask`` as for ``quant_cost_plain``.

    A CPU tensor takes the plain version; a CUDA tensor launches kernel D
    (or raises)."""
    if scaled.device.type == "cpu":
        return quant_cost_full_torch(scaled, valid_mask)
    lib = kernels.library()
    if scaled.dtype != torch.float32 or tuple(scaled.shape[-2:]) != (32, 128):
        raise ValueError(f"quant_cost_full: need [..., 32, 128] f32, got "
                         f"{tuple(scaled.shape)} {scaled.dtype}")
    if tuple(valid_mask.shape) != (32, 128):
        raise ValueError("quant_cost_full: valid_mask must be [32, 128]")
    x, mask, err, vlc = _kernel_tensors(scaled, valid_mask)
    kernels.require_cuda("quant_cost_full", x, mask, err, vlc)
    kernels.check(lib.atrac3_quant_cost_full(
        x.data_ptr(), mask.data_ptr(), err.data_ptr(), vlc.data_ptr(),
        x.numel() // (32 * 128), kernels.stream_ptr(x)), "quant_cost_full")
    trace.count("launch.quant_full")
    return err, vlc
