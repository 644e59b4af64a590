"""ATRAC3 tonal components: extraction, regrouping, scaling, rate cost.

Port of ``atracdenc_tpu/models/atrac3/tonal.py`` (reference
atrac3denc.cpp:581-662, atrac3_bitstream.cpp:409-595): spectral flatness
gates extraction; per gated BFU in [8, 29) the best run of <= 5 lines is
lifted out; the runs regroup into coded blocks of <= 7 consecutive lines;
the rate control prices the tonal section per allocation with the closed
form of the subgroup walk (``make_cost_fn``).  The one-hot einsums of the
JAX regroup are exact permutations and become an integer scatter here.
"""
import functools

import torch

from atracdenc_tpu_torch.models.atrac3 import tables as T
from atracdenc_tpu_torch.ops import scale as scale_ops
from atracdenc_tpu_torch.ops.quant_cost import vlc_bits, vlc_index
from . import specblocks

FLATNESS_THRESHOLD = 0.01
MAX_TONAL_LEN = 5
TONAL_BFU_FIRST = 8
TONAL_BFU_LAST = 29          # exclusive
BLOCK_LEN = 7                # MapTonalComponents groups <= 7 coefficients


@functools.lru_cache(maxsize=None)
def _consts(dev):
    return {"mask": torch.as_tensor(T.GATHER_MASK, device=dev),
            "spb": torch.as_tensor(T.SPECS_PER_BLOCK, device=dev),
            "start": torch.as_tensor(T.SPECS_START, device=dev),
            "scale": torch.as_tensor(T.SCALE_TABLE, device=dev),
            "maxq": torch.as_tensor(T.MAX_QUANT, device=dev),
            "iota32": torch.arange(32, device=dev, dtype=torch.int32)}


def flatness_per_bfu(mdct_energy, energy_floor=1e-12):
    """[..., 1024] per-line energies -> [..., 32] geometric / arithmetic
    mean ratios (CalcSpectralFlatnessPerBfu)."""
    c = _consts(mdct_energy.device)
    vals = specblocks.to_blocks(mdct_energy)
    floor = max(energy_floor, 1e-20)
    e = torch.clamp(vals, min=0.0)
    n = c["spb"].to(torch.float32)
    arith = torch.sum(torch.where(c["mask"], e, 0.0), dim=-1) / n
    mean_log = torch.sum(torch.where(c["mask"], torch.log(torch.clamp(e, min=floor)),
                                     0.0), dim=-1) / n
    ratio = torch.clamp(torch.exp(mean_log) / arith, 0.0, 1.0)
    return torch.where(arith <= floor, 1.0, ratio)


def extract(specs, flatness):
    """Lift the best tonal run out of each gated BFU.

    specs [..., 1024], flatness [..., 32].  Returns (specs_out, block
    planes) — see ``regroup``."""
    c = _consts(specs.device)
    iota = c["iota32"]
    gate = (flatness < FLATNESS_THRESHOLD) & (iota >= TONAL_BFU_FIRST) \
        & (iota < TONAL_BFU_LAST)

    blocks = specblocks.to_blocks(specs)
    absb = torch.abs(blocks) * c["mask"]

    # score[start] = sum of |spec| over the (capped) 5-line window: |spec|
    # >= 0 makes the score nondecreasing in length, so the first strictly
    # greater candidate in (start, len) order is the first argmax over
    # starts of the full-length score (atracdenc_tpu tonal.extract)
    cum = torch.cumsum(absb, dim=-1)
    pad = torch.nn.functional.pad(cum, (1, 0))
    ext = torch.cat([cum, cum[..., -1:].expand(
        cum.shape[:-1] + (MAX_TONAL_LEN - 1,))], dim=-1)
    score = ext[..., MAX_TONAL_LEN - 1:] - pad[..., :-1]
    starts = torch.arange(128, device=specs.device)
    score = torch.where(starts < c["spb"][:, None], score, -1.0)
    best_start = torch.argmax(score, dim=-1)
    best_score = torch.amax(score, dim=-1)

    offs = torch.arange(MAX_TONAL_LEN, device=specs.device)
    pos = best_start[..., None] + offs                     # [..., 32, 5]
    inside = pos < 128
    pos_c = torch.clamp(pos, max=127)
    va = torch.where(inside, torch.gather(absb, -1, pos_c), 0.0)
    best_len = torch.clamp(torch.amax(torch.where(va > 0, offs + 1, 0), dim=-1),
                           min=1)

    active = gate & (best_score > 0.0)
    start_abs = c["start"] + best_start
    ln = torch.where(active, best_len, 0)

    in_run = active[..., None] & (offs < ln[..., None])    # [..., 32, 5]
    # the run values (+0.0 maps a -0.0 to +0.0 like the masked sums)
    vals = torch.where(in_run & inside,
                       torch.gather(blocks, -1, pos_c) + 0.0, 0.0)
    sel = starts - best_start[..., None]                   # [..., 32, 128]
    run_mask = active[..., None] & (sel >= 0) & (sel < ln[..., None])
    specs_out = specblocks.from_blocks(torch.where(run_mask, 0.0, blocks))

    planes = {"active": active, "start": (start_abs * active).to(torch.int32),
              "len": ln.to(torch.int32), "values": vals}
    return specs_out, regroup(planes)


def regroup(run_planes):
    """Per-BFU runs -> coded tonal blocks (MapTonalComponents,
    atrac3denc.cpp:646-662): the components regroup into runs of
    consecutive positions, split every 7, merging across BFU boundaries;
    a block's BFU is its first component's BFU.

    Returns active [..., 32] bool, start / len / bfu [..., 32] int32,
    values [..., 32, 7]."""
    act = run_planes["active"]
    start = run_planes["start"].long()
    ln = run_planes["len"].long()
    vals = run_planes["values"]
    dev = act.device
    lead = act.shape[:-1]

    offs = torch.arange(MAX_TONAL_LEN, device=dev)
    cvalid = act[..., None] & (offs < ln[..., None])       # [..., 32, 5]
    cpos = torch.where(cvalid, start[..., None] + offs, 1 << 20)
    cbfu = torch.arange(32, device=dev)[:, None].expand(32, MAX_TONAL_LEN)
    cpos = cpos.reshape(lead + (-1,))
    cval = vals.reshape(lead + (-1,))
    cvalid = cvalid.reshape(lead + (-1,))
    cbfu = cbfu.reshape(-1).expand(cpos.shape)

    # previous valid component's position (ascending, so a running max)
    cp = torch.where(cvalid, cpos, -(1 << 20))
    prev_pos = torch.cat([torch.full_like(cp[..., :1], -(1 << 20)),
                          torch.cummax(cp, dim=-1).values[..., :-1]], dim=-1)
    new_run = cvalid & (cpos != prev_pos + 1)
    rank = torch.cumsum(cvalid.long(), dim=-1) - 1
    run_start_rank = torch.cummax(torch.where(new_run, rank, -1), dim=-1).values
    off_in_run = rank - run_start_rank
    new_block = cvalid & (new_run | (off_in_run % BLOCK_LEN == 0))
    block_id = torch.cumsum(new_block.long(), dim=-1) - 1
    within = off_in_run % BLOCK_LEN

    # each (block, within) slot receives at most one component; invalid
    # components land in a dump slot past the end
    nslot = 32 * BLOCK_LEN
    keep = cvalid & (block_id < 32)
    dst = torch.where(keep, block_id * BLOCK_LEN + within, nslot)

    def scatter(x, dtype):
        out = torch.zeros(lead + (nslot + 1,), dtype=dtype, device=dev)
        out.scatter_(-1, dst, x.to(dtype))
        return out[..., :nslot].reshape(lead + (32, BLOCK_LEN))

    bvals = scatter(torch.where(keep, cval, 0.0), cval.dtype)
    bcount = scatter(keep, torch.int32)
    bpos = scatter(torch.where(keep, cpos, 0), torch.int32)
    bbfu = scatter(torch.where(keep, cbfu, 0), torch.int32)

    blen = torch.sum(bcount, dim=-1, dtype=torch.int32)
    bactive = blen > 0
    return {"active": bactive,
            "start": torch.where(bactive, bpos[..., 0], 0),
            "len": blen,
            "bfu": torch.where(bactive, bbfu[..., 0], 0),
            "values": bvals}


def scale_groups(planes):
    """Scale tonal blocks like MapTonalComponents (per-block block float).
    Adds sfi [..., 32], vlc_cost [..., 32, 8] (VLC bits at each quantiser;
    only 2..7 are used) and mant [..., 32, 8, 7]."""
    c = _consts(planes["values"].device)
    vals = planes["values"]
    dev = vals.device
    in_run = torch.arange(BLOCK_LEN, device=dev) < planes["len"][..., None]
    sfi, scaled, _ = scale_ops.scale_blocks(
        vals, torch.ones(vals.shape[-2:], dtype=torch.bool, device=dev),
        c["scale"])
    scaled = scaled * in_run

    # mantissas per quantiser: plain lrint, no EA (atrac3_bitstream.cpp:576)
    mant = torch.round(scaled[..., None, :] * c["maxq"][:, None]).to(torch.int32)
    idx = vlc_index(mant)
    vlc = torch.stack(
        [torch.sum(torch.where(in_run, vlc_bits(idx[..., qq, :],
                                                min(max(qq - 1, 0), 6)), 0),
                   dim=-1, dtype=torch.int32)
         for qq in range(8)], dim=-1)
    planes = dict(planes)
    planes["sfi"] = sfi
    planes["vlc_cost"] = vlc
    planes["mant"] = mant
    return planes


def block_quant(planes, wl, num_bfu):
    """(active, quant) per tonal block for an allocation: quantiser =
    clamp(alloc[first-component BFU] + 4, 2, 7); blocks whose BFU fell off
    the allocation table are dropped (atrac3_bitstream.cpp:417-424)."""
    bfu = planes["bfu"].long()
    active = planes["active"] & (bfu < num_bfu[..., None])
    wl_b = torch.gather(wl, -1, bfu)
    quant = torch.clamp(torch.where(active, wl_b + 4, 0), 2, 7)
    return active, torch.where(active, quant, 0).to(torch.int32)


def make_cost_fn(planes):
    """tonal_bits_fn(wl, num_bfu) -> [...] tonal section bits for an
    allocation (EncodeTonalComponents dry-run, atrac3_bitstream.cpp:
    453-595), in closed form: block positions ascend, so within one
    (quantiser, length) bucket a block opens a subgroup iff it is the first
    of its bucket or its rank within the same 64-line anchor group is
    8, 15, ...; it opens a window-count section iff it opens a subgroup or
    no earlier same-bucket block shares its 256-line window."""
    ln = planes["len"]
    pos = planes["start"]
    vlc = planes["vlc_cost"]
    dev = ln.device
    iota = torch.arange(32, device=dev)
    grp = pos >> 6
    win = pos >> 8
    lt = iota[:, None] > iota[None, :]                     # [i, j]: j < i
    le = iota[:, None] >= iota[None, :]
    same_len = ln[..., :, None] == ln[..., None, :]
    pre_lg = le & same_len & (grp[..., :, None] == grp[..., None, :])
    pre_lw = lt & same_len & (win[..., :, None] == win[..., None, :])
    pre_lb = lt & same_len

    def cost(wl, num_bfu):
        active, quant = block_quant(planes, wl, num_bfu)
        vlc_at_q = torch.gather(vlc, -1, quant.long()[..., None])[..., 0]
        member_bits = torch.where(active, 12 + vlc_at_q, 0)
        base = torch.sum(member_bits, dim=-1, dtype=torch.int32)

        qeq = quant[..., :, None] == quant[..., None, :]
        actj = active[..., None, :]
        first = active & ~torch.any(actj & qeq & pre_lb, dim=-1)
        cnt = torch.sum(actj & qeq & pre_lg, dim=-1, dtype=torch.int32)
        brk = active & (cnt > 1) & ((cnt - 1) % 7 == 0)
        new_sub = first | brk
        samewin = torch.any(actj & qeq & pre_lw, dim=-1)
        new_win = active & (new_sub | ~samewin)

        tcsgn = torch.sum(new_sub, dim=-1, dtype=torch.int32)
        sub_bits = 10 * tcsgn + 12 * torch.sum(new_win, dim=-1, dtype=torch.int32)
        return 5 + torch.where(tcsgn > 0, 2 + sub_bits + base, 0)

    return cost
