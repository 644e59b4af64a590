"""ATRAC3 rate control: quantisation-cost memo, lambda bisection, mantissas.

Port of ``atracdenc_tpu/models/atrac3/bitalloc.py`` (reference
src/atrac/at3/atrac3_bitstream.cpp:261-760 and the bs_encode lambda
bisection).  The per-(BFU, wordlen) costs are computed once
(``quant_tensors``: plain lanes by kernel A, the energy-adjusted lanes by
``quant_blocks`` / kernel B, the wl==1 pair codebook; or all of it in
kernel D with ``fused_memo=True``), then every
bisection step is a gather + sum over all channel-frames.  ``allocate``
runs the whole loop through kernel C (``ops/rate_control.py``) or, with
``use_rate_kernel=False``, through the tensor-op form below (the JAX
package's XLA path).
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch import runtime, trace
from atracdenc_tpu_torch.models.atrac3 import tables as T
from atracdenc_tpu_torch.ops import psy
from atracdenc_tpu_torch.ops.greedy import greedy_scan
from atracdenc_tpu_torch.ops.quant import quant_blocks, _round_energy
from atracdenc_tpu_torch.ops.quant_cost import (
    ea_groups, memo, quant_cost_full, quant_cost_plain)
from atracdenc_tpu_torch.ops.rate_control import rate_control_block

_BISECT_STEPS = 11  # (28 / 2^k - 0.02) <= 0 at k = 11
_MAX_WL = 8


def _clc_table() -> np.ndarray:
    """[32, 8] CLC spectrum bits (atrac3_bitstream.cpp:163-184): wl > 1 ->
    len * blockSize; wl == 1 -> 4 * blockSize/2; wl == 0 -> 0."""
    wl = np.arange(_MAX_WL)
    spb = T.SPECS_PER_BLOCK.astype(np.int32)
    return np.where(wl[None, :] > 1,
                    T.CLC_LENGTH_TAB[wl][None, :] * spb[:, None],
                    T.CLC_LENGTH_TAB[wl][None, :] * (spb[:, None] // 2)
                    ).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _consts(dev):
    ath = psy.ath_per_bfu(T.SPECS_START, T.SPECS_PER_BLOCK)
    return {"ath": torch.as_tensor(ath.astype(np.float32), device=dev),
            "fix": torch.as_tensor(T.FIXED_BIT_ALLOC.astype(np.float32),
                                   device=dev),
            "xdiv": torch.as_tensor(T.SFI_DIVISOR, device=dev),
            "maxq": torch.as_tensor(T.MAX_QUANT, device=dev),
            "clc": torch.as_tensor(_clc_table(), device=dev),
            "band": torch.as_tensor(T.BFU_TO_BAND.astype(np.int64), device=dev),
            "iota32": torch.arange(32, device=dev, dtype=torch.int32)}


@trace.span("quant_tensors")
def quant_tensors(scaled, valid_mask, fused_memo=False):
    """Per-(BFU, wordlen) quantisation costs (the reference TEncCache).

    scaled [..., 32, 128], valid_mask [32, 128] bool.  Returns
    {"err": [..., 32, 8] f32 (e1/e2, sanitised), "clc": [..., 32, 8] i32,
    "vlc": [..., 32, 8] i32}.  fused_memo=False computes the memo from
    kernels A and B (``quant_cost.memo``); True runs it whole in kernel D
    (``quant_cost_full``), the JAX package's ``use_pallas=True``.  On a CPU
    tensor both take the kernels' plain versions."""
    if fused_memo:
        err, vlc = quant_cost_full(scaled, valid_mask)
    else:
        err, vlc = memo(scaled, valid_mask, quant_cost_plain, greedy_scan)
    return {"err": err, "clc": _consts(scaled.device)["clc"].expand(err.shape),
            "vlc": vlc}


@trace.span("final_mantissas")
def final_mantissas(scaled, valid_mask, wl):
    """Mantissas [..., 32, 128] int8 at the chosen wordlens only."""
    mul = _consts(scaled.device)["maxq"][wl.long()]
    mant, _, _ = _round_energy(scaled, valid_mask, mul)
    mant = mant.clone()
    for b, e, ln in ea_groups():
        ea_m, _ = quant_blocks(scaled[..., b:e, :ln], valid_mask[b:e, :ln],
                               mul[..., b:e],
                               torch.ones(mul[..., b:e].shape, dtype=torch.bool,
                                          device=scaled.device),
                               scan=greedy_scan)
        mant[..., b:e, :ln] = ea_m
    return mant.to(torch.int8)


def csfi_gated(sfi, gain_scale_frame, energy, loudness):
    """Lambda-independent allocation inputs: the gain-energy-corrected SFI
    and the ATH x loudness gate (atrac3_bitstream.cpp:343-371).  The log2
    here is the only transcendental of the rate control."""
    c = _consts(sfi.device)
    gs = gain_scale_frame[..., c["band"]]
    gs = torch.where(torch.isfinite(gs) & (gs > 0), gs, 1.0)
    gated = energy * gs < c["ath"] * loudness[..., None]
    csfi = torch.clamp(sfi.to(torch.float32) + 1.5 * torch.log2(gs), 0.0, 63.0)
    return csfi, gated


def trunc_allocation(csfi, gated, spread, shift, num_bfu, tonal_bfu_counts):
    """CalcBitsAllocation (atrac3_bitstream.cpp:343-407) from csfi / gated:
    wordlens [..., 32] int32 (zero beyond num_bfu), with the tonal-BFU
    discount (one -1 per tonal block while wl > 2, at most 3)."""
    c = _consts(csfi.device)
    in_use = c["iota32"] < num_bfu[..., None]
    tmp = torch.trunc(spread[..., None] * (csfi / c["xdiv"])
                      + (1.0 - spread[..., None]) * c["fix"] - shift[..., None])
    wl = torch.where(tmp > 7, 7.0, torch.where(
        tmp < 0, 0.0, torch.where(tmp == 0, 1.0, tmp))).to(torch.int32)
    wl = torch.where(gated | ~in_use, 0, wl)
    for i in range(3):
        wl = torch.where(in_use & (tonal_bfu_counts > i) & (wl > 2), wl - 1, wl)
    return wl


def calc_bits_allocation(sfi, gain_scale_frame, energy, spread, shift,
                         num_bfu, loudness, tonal_bfu_counts):
    """Vectorised CalcBitsAllocation with the JAX package's signature."""
    csfi, gated = csfi_gated(sfi, gain_scale_frame, energy, loudness)
    return trunc_allocation(csfi, gated, spread, shift, num_bfu,
                            tonal_bfu_counts)


def _select(table, wl):
    return torch.gather(table, -1, wl.long()[..., None])[..., 0]


def _spec_cost(wl, qt, num_bfu):
    """(coding_mode [...], bits [...]) of an allocation
    (CalcSpecsBitsConsumption, atrac3_bitstream.cpp:261-298)."""
    in_use = (_consts(wl.device)["iota32"] < num_bfu[..., None]) & (wl > 0)
    clc_sum = torch.sum(torch.where(in_use, _select(qt["clc"], wl), 0), dim=-1,
                        dtype=torch.int32)
    vlc_sum = torch.sum(torch.where(in_use, _select(qt["vlc"], wl), 0), dim=-1,
                        dtype=torch.int32)
    mode = clc_sum <= vlc_sum          # 1 = CLC
    bits = 3 * num_bfu + 6 * torch.sum(in_use, dim=-1, dtype=torch.int32) \
        + torch.where(mode, clc_sum, vlc_sum)
    return mode, bits


def _energy_boost(wl, qt, num_bfu):
    """ConsiderEnergyErr fixed point (atrac3_bitstream.cpp:312-328): bump
    the wordlens of the first 10 BFUs while the block energy ratio is off.
    Each lane bumps at most 6 times (wl 1 -> 7)."""
    iota = _consts(wl.device)["iota32"]
    boostable = iota < torch.clamp(num_bfu, max=T.BOOST_NAQ_END)[..., None]
    for _ in range(6):
        e = torch.where(wl > 0, _select(qt["err"], wl), 0.0)
        cond = (((e > 0) & (e < 0.7)) | (e > 1.2)) & (wl < 7) & boostable
        wl = torch.where(cond, wl + 1, wl)
    return wl


def _bisect(csfi, gated, spread, num_bfu, tonal_counts, tonal_bits_fn, qt,
            target):
    """One lambda bisection at a given num_bfu (bs_encode/encode.cpp:57-98);
    returns the energy-boosted wordlens at the best under-budget lambda."""
    min_l = torch.full(num_bfu.shape, -8.0, device=csfi.device)
    max_l = torch.full(num_bfu.shape, 20.0, device=csfi.device)
    last_l = torch.full(num_bfu.shape, 20.0, device=csfi.device)

    def eval_alloc(shift):
        wl = trunc_allocation(csfi, gated, spread, shift, num_bfu, tonal_counts)
        wl = _energy_boost(wl, qt, num_bfu)
        _, bits = _spec_cost(wl, qt, num_bfu)
        return wl, bits + tonal_bits_fn(wl, num_bfu)

    for _ in range(_BISECT_STEPS):
        active = max_l > min_l
        cur = (max_l + min_l) * 0.5
        _, bits = eval_alloc(cur)
        under = bits < target
        over = bits > target
        exact = ~under & ~over
        last_l = torch.where(active & (under | exact), cur, last_l)
        max_l = torch.where(active & under, cur - 0.01, max_l)
        min_l = torch.where(active & over, cur + 0.01, min_l)
        max_l = torch.where(active & exact, min_l, max_l)
    wl, _ = eval_alloc(last_l)
    return wl


def allocate_torch(qt, csfi, gated, spread, target, num_bfu, tonal_counts,
                   tonal_bits_fn, auto=True):
    """The tensor-op rate control (the JAX package's XLA path): bisection,
    then the BFU-shrink rounds (CheckBfus -> Repeat) while any lane's last
    used BFU got no bits.  Returns (num_bfu, mode, wl)."""
    def one_round(nb):
        wl = _bisect(csfi, gated, spread, nb, tonal_counts, tonal_bits_fn,
                     qt, target)
        last = torch.gather(wl, -1, (nb - 1).long()[..., None])[..., 0]
        return wl, (last == 0) & (nb > 1) & auto

    num_bfu = num_bfu.to(torch.int32)
    wl, shrink = one_round(num_bfu)
    num_bfu = torch.where(shrink, num_bfu - 1, num_bfu)
    while runtime.host_bool(torch.any(shrink)):
        wl, shrink = one_round(num_bfu)
        num_bfu = torch.where(shrink, num_bfu - 1, num_bfu)
    mode, _ = _spec_cost(wl, qt, num_bfu)
    return num_bfu, mode, wl


def _empty_tonal_cost(wl, num_bfu):
    return torch.full(num_bfu.shape, 5, dtype=torch.int32, device=wl.device)


@trace.span("allocate")
def allocate(qt, sfi, gain_scale, energy, spread, loudness, target_bits,
             tonal_planes=None, bfu_idx_const=0, use_rate_kernel=True):
    """Full rate control for a batch of channel-frames.

    qt: ``quant_tensors`` output; sfi [..., 32], gain_scale [..., 4],
    energy [..., 32], spread [...], loudness [...] (Loudness/LoudFactor),
    target_bits [...] int32; tonal_planes: ``tonal.scale_groups`` output
    (None: no tonal components, the 5-bit empty tonal header).
    use_rate_kernel: True runs kernel C (its plain version on the CPU);
    False runs the tensor-op form (``allocate_torch``) on any device.
    Returns (num_bfu [...] i32, coding_mode [...] bool (1 = CLC),
    wordlen [..., 32] i32)."""
    dev = sfi.device
    shape = spread.shape
    init = bfu_idx_const if bfu_idx_const else 32
    lim = torch.where(target_bits > 5,
                      torch.clamp((target_bits - 5) // 3, min=1), 1)
    num_bfu = torch.where(target_bits < 101, torch.clamp(lim, max=init),
                          torch.full_like(target_bits, init))
    num_bfu = torch.clamp(num_bfu, min=1).to(torch.int32).expand(shape)
    csfi, gated = csfi_gated(sfi, gain_scale, energy, loudness)
    auto = bfu_idx_const == 0

    z32 = torch.zeros(sfi.shape, dtype=torch.int32, device=dev)
    if tonal_planes is None:
        t_active = t_pos = t_len = t_bfu = tonal_counts = z32
        t_vlc = torch.zeros(sfi.shape + (_MAX_WL,), dtype=torch.int32,
                            device=dev)
    else:
        t_active = tonal_planes["active"].to(torch.int32)
        t_pos = tonal_planes["start"].to(torch.int32)
        t_len = tonal_planes["len"].to(torch.int32)
        t_bfu = tonal_planes["bfu"].to(torch.int32)
        t_vlc = tonal_planes["vlc_cost"].to(torch.int32)
        tonal_counts = tonal_bfu_counts(tonal_planes)

    if use_rate_kernel:
        return rate_control_block(
            csfi, gated, tonal_counts, spread, target_bits, num_bfu,
            qt["err"], qt["clc"], qt["vlc"], t_active, t_pos, t_len, t_bfu,
            t_vlc, auto=auto)
    if tonal_planes is None:
        cost_fn = _empty_tonal_cost
    else:
        from .tonal import make_cost_fn
        cost_fn = make_cost_fn(tonal_planes)
    return allocate_torch(qt, csfi, gated, spread, target_bits, num_bfu,
                          tonal_counts, cost_fn, auto)


def tonal_bfu_counts(tonal_planes):
    """Tonal blocks per BFU [..., 32] int32 (keyed on each block's
    first-component BFU) for the allocation discount."""
    act = tonal_planes["active"].to(torch.int32)
    out = torch.zeros(act.shape, dtype=torch.int32, device=act.device)
    return out.scatter_add_(-1, tonal_planes["bfu"].long(), act)
