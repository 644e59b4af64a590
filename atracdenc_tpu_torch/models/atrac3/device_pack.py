"""ATRAC3 sound-unit serialization on the device.

Port of ``atracdenc_tpu/models/atrac3/device_pack.py``.  The same field
planes as the host packer (``frame.pack``) are computed with tensor ops,
every field's absolute bit offset comes in closed form from prefix sums
over the fixed entity grid, and ``ops/bitdeposit.deposit_fields`` writes
the frame bytes.  Bit layout per the reference writer
(src/atrac/at3/atrac3_bitstream.cpp: WriteSoundUnit :830-918, EncodeSpecs
:597-636, tonal groups :409-595).  Byte-identical to ``frame.pack``
(tests/test_torch_device_pack.py).

All planes are int32 (every field fits in 28 bits), so the 1024-line
spectrum planes cost half of what int64 would on the card.  The tonal
section is the only part whose field order depends on the data; its slots
carry explicit offsets, so slot order never has to match stream order.
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.models.atrac3 import tables as T
from atracdenc_tpu_torch.ops.bitdeposit import deposit_fields

__all__ = ["channel_fields", "pack_device", "pack_device_batch"]

_MAXLEN = T.MAX_SPECS_PER_BLOCK
_SLACK = 64       # the reference's TBitStream may overrun; the tail is cut
_I32 = torch.int32


def _full(n, v, dev):
    return torch.full((n,), v, dtype=_I32, device=dev)


def _mask_sign(v, w):
    return v & ((1 << w) - 1)


def _chain_merge(fields):
    """Merge stream-adjacent fields [(v, w), ...] into one field (total
    width <= 32).  Earlier fields land in the higher bits, their earlier
    stream position under MSB-first deposit.  Each value is masked to its
    width here, so a zero-width hole with garbage contributes nothing."""
    v, w = fields[0]
    w = w.to(_I32)
    v = _mask_sign(v.to(_I32), w)
    for v2, w2 in fields[1:]:
        w2 = w2.to(_I32)
        v = (v << w2) | _mask_sign(v2.to(_I32), w2)
        w = w + w2
    return v, w


def _vlc_idx(m):
    return torch.where(m < 0, -m * 2, torch.where(m > 0, m * 2 - 1, 0))


def _vlc_steps(sel):
    """(bit-length, code) of spectrum codebook ``sel`` as step-function
    breakpoints over the symbol index (the codebooks are canonical: codes
    are consecutive within a run of equal lengths)."""
    lens = T.VLC_BITS[sel]
    codes = T.VLC_CODE[sel]
    n = int(np.max(np.nonzero(lens)[0])) + 1 if lens.any() else 0
    len_steps, code_steps = [(0, int(lens[0]))], [(0, int(codes[0]))]
    for j in range(1, n):
        if int(lens[j]) != int(lens[j - 1]):
            len_steps.append((j, int(lens[j]) - int(lens[j - 1])))
        off = int(codes[j]) - j
        prev_off = int(codes[j - 1]) - (j - 1)
        if off != prev_off:
            code_steps.append((j, off - prev_off))
        if not (int(codes[j]) == int(codes[j - 1]) + 1
                or int(lens[j]) != int(lens[j - 1])):
            raise ValueError("non-canonical codebook")
    return len_steps, code_steps


def _vlc_tables():
    """The step functions of the 7 codebooks tabulated: [7, L] bit lengths
    and codes for symbol indices below L, the first index past every
    breakpoint.  Past L - 1 a length holds and a code rises by one per
    index, as the step functions do."""
    steps = [_vlc_steps(s) for s in range(7)]
    last = max(j for ls, cs in steps for j, _ in ls + cs)
    idx = np.arange(last + 1)
    lens = np.zeros((7, last + 1), np.int32)
    codes = np.zeros((7, last + 1), np.int32)
    for sel, (len_steps, code_steps) in enumerate(steps):
        lens[sel] = len_steps[0][1] + sum(d * (idx >= j) for j, d in len_steps[1:])
        codes[sel] = idx + code_steps[0][1] + sum(d * (idx >= j)
                                                  for j, d in code_steps[1:])
    return lens, codes


@functools.lru_cache(maxsize=None)
def _consts(dev):
    lens, codes = _vlc_tables()
    pair = [int(T.VLC_PAIR_RTAB[k]) for k in range(9)]
    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)
    return {"vlc_bits": i32(lens).reshape(-1), "vlc_code": i32(codes).reshape(-1),
            "vlc_last": lens.shape[1] - 1,
            "clc_len": i32(T.CLC_LENGTH_TAB),
            "pair_code": i32([T.VLC_CODE[0, p] for p in pair]),
            "pair_bits": i32([T.VLC_BITS[0, p] for p in pair]),
            "specs": i32(T.SPECS_PER_BLOCK)}


def _vlc_lookup(idx, sel):
    """(bits, code) of symbol indices ``idx`` >= 0 in codebooks ``sel``
    (int tensors of one shape, sel in 0..6): a gather from the tabulated
    step functions (on the card one pass, where the JAX package's step
    arithmetic, written for the TPU's slow gathers, takes dozens)."""
    k = _consts(idx.device)
    last = k["vlc_last"]
    flat = (sel * (last + 1) + torch.clamp(idx, max=last)).long()
    return (k["vlc_bits"][flat],
            k["vlc_code"][flat] + torch.clamp(idx - last, min=0).to(_I32))


def _segment_sum(idx, valid, x, n_seg):
    """[N, K] values x summed into n_seg segments per row (integers)."""
    out = torch.zeros((idx.shape[0], n_seg), dtype=_I32, device=idx.device)
    return out.scatter_add_(1, idx.long(), torch.where(valid, x, 0).to(_I32))


@trace.span("tonal_fields")
def _tonal_fields(planes):
    """Tonal-section fields with explicit in-section bit offsets.

    Returns (values [N, S], widths [N, S], rel_offsets [N, S], total_bits
    [N])."""
    act = planes["tonal_active"].bool()                   # [N, 32]
    pos = planes["tonal_start"].to(_I32)
    ln = planes["tonal_len"].to(_I32)
    sfi = planes["tonal_sfi"].to(_I32)
    quant = planes["tonal_quant"].to(_I32)
    mant = planes["tonal_mant"].to(_I32)                  # [N, 32, 7]
    n, dev = act.shape[0], act.device
    m32 = torch.arange(32, device=dev)

    # sort the blocks by (bucket, slot); the JAX one-hot permutation sums
    # every slot of one rank, so the inactive slots (one shared key) add up
    # in one place: an integer scatter-add keeps that exactly
    bucket = quant * 8 + ln
    key = torch.where(act, bucket * 64 + m32, 1 << 20)
    rank = torch.sum(key[:, None, :] < key[:, :, None], dim=-1)   # [N, 32]

    def srt(x):
        r = rank if x.dim() == 2 else rank[..., None].expand(x.shape)
        return torch.zeros_like(x).scatter_add_(1, r, x)

    s_act = srt(act.to(_I32)).bool()
    s_bucket, s_pos, s_sfi, s_quant, s_ln = (srt(x) for x in
                                             (bucket, pos, sfi, quant, ln))
    s_mant = srt(mant)

    # subgroup-split walk (GroupTonalComponents :427-449) over sorted slots:
    # the member whose in-window run would reach 7 starts the next subgroup
    z = torch.zeros(n, dtype=_I32, device=dev)
    bprev, anchor, limiter, sgid = z - 1, z, z, z - 1
    cols = []
    for i in range(32):
        a, b, p = s_act[:, i], s_bucket[:, i], s_pos[:, i]
        new_bucket = a & (b != bprev)
        within = (p - (anchor & ~63)) < 64
        lim_try = torch.where(within, limiter + 1, 0)
        overflow = a & ~new_bucket & within & (lim_try >= 7)
        new_sg = new_bucket | overflow
        sgid = torch.where(new_sg, sgid + 1, sgid)
        anchor = torch.where(new_sg | (a & ~within), p, anchor)
        limiter = torch.where(new_sg, 0, torch.where(a, lim_try, limiter))
        cols.append(torch.where(a, sgid, -1))
        bprev = torch.where(a, b, bprev)
    sg = torch.stack(cols, dim=1).to(_I32)                # [N, 32], -1 inactive
    num_sg = torch.amax(sg, dim=-1) + 1                   # [N]

    s32 = torch.arange(32, device=dev)
    in_sg = sg[:, None, :] == s32[None, :, None]          # [N, s, i]
    sg_quant = torch.amax(torch.where(in_sg, s_quant[:, None, :], 0), dim=-1)
    sg_len = torch.amax(torch.where(in_sg, s_ln[:, None, :], 0), dim=-1)
    sg_used = s32[None, :] < num_sg[:, None]

    win = s_pos >> 6                                      # [N, i]
    j16 = torch.arange(16, device=dev)
    member = (sg >= 0) & (win >= 0) & (win < 16)
    seg = torch.clamp(sg, 0, 31) * 16 + torch.clamp(win, 0, 15)
    cnt = _segment_sum(seg, member, torch.ones_like(sg), 512).reshape(n, 32, 16)
    band_any = cnt.reshape(n, 32, 4, 4).sum(-1) > 0       # [N, s, b]
    cw = torch.where(band_any[:, :, j16 >> 2] & sg_used[:, :, None], 3, 0)

    # member VLC codes / bits (coding mode fixed to VLC, :484-487)
    t7 = torch.arange(7, device=dev)
    midx = _vlc_idx(s_mant)                               # [N, i, 7]
    qsel = torch.clamp(s_quant - 1, 0, 6)[..., None].expand(midx.shape)
    mbits_raw, mcode = _vlc_lookup(midx, qsel)
    mbits = torch.where(s_act[..., None] & (t7 < s_ln[..., None]), mbits_raw, 0)
    member_bits = torch.where(s_act, 12 + mbits.sum(-1, dtype=_I32), 0)

    mwin = _segment_sum(seg, member, member_bits, 512).reshape(n, 32, 16)
    sg_bits = torch.where(sg_used, 10 + (cw + mwin).sum(-1, dtype=_I32), 0)
    head_bits = 5 + torch.where(num_sg > 0, 2, 0)
    with trace.span("offset_scan"):
        sg_start = head_bits[:, None] + torch.cumsum(sg_bits, -1) - sg_bits
    total = head_bits + sg_bits.sum(-1)

    wm = cw + mwin
    with trace.span("offset_scan"):
        wstart = sg_start[:, :, None] + 10 + torch.cumsum(wm, -1) - wm
    mem_region = wstart + cw                              # [N, s, j]

    # member offsets: prefix over sorted order within (subgroup, window)
    segkey = torch.where(s_act, sg * 16 + win, -1)
    same_before = (segkey[:, None, :] == segkey[:, :, None]) \
        & (m32[None, :] < m32[:, None])[None]             # [N, i, j]
    mem_prefix = torch.sum(same_before * member_bits[:, None, :], dim=-1)
    moff = torch.gather(mem_region.reshape(n, 512), 1, seg.long()) + mem_prefix
    moff = torch.where(s_act, moff, 0)

    vals, wids, offs = [], [], []

    def emit(v, w, o):
        vals.append(v.to(_I32).reshape(n, -1))
        wids.append(w.to(_I32).reshape(n, -1))
        offs.append(o.to(_I32).reshape(n, -1))

    emit(num_sg, _full(n, 5, dev), z)                     # count
    emit(z, torch.where(num_sg > 0, 2, 0), _full(n, 5, dev))  # mode = VLC

    # subgroup header: 4 band flags + (cv-1) + quant -> one 10-bit slot
    uw = torch.where(sg_used, 1, 0)
    hdr = [(band_any[:, :, b], uw) for b in range(4)]
    hdr += [(sg_len - 1, 3 * uw), (sg_quant, 3 * uw)]
    emit(*_chain_merge(hdr), sg_start)
    emit(cnt, cw, wstart)                                 # window counts

    # member header: sfi (6) + in-window position (6) -> one 12-bit slot
    aw = torch.where(s_act, 6, 0)
    emit(*_chain_merge([(s_sfi, aw), (s_pos - (win << 6), aw)]), moff)
    # mantissa codes, two lines per slot; inactive lines carry garbage
    # codes, zeroed so the pair OR cannot corrupt the active line
    mcode = torch.where(mbits > 0, mcode, 0)
    with trace.span("offset_scan"):
        mant_off = moff[:, :, None] + 12 + torch.cumsum(mbits, -1) - mbits
    codd = torch.nn.functional.pad(mcode[..., 1::2], (0, 1))
    wodd = torch.nn.functional.pad(mbits[..., 1::2], (0, 1))
    emit((mcode[..., 0::2] << wodd) | codd, mbits[..., 0::2] + wodd,
         mant_off[..., 0::2])

    with trace.span("field_cat"):
        return (torch.cat(vals, 1), torch.cat(wids, 1), torch.cat(offs, 1),
                total)


@trace.span("channel_fields")
def channel_fields(planes, js1=False):
    """One channel's field planes [N, K] (values, widths, absolute offsets).

    planes: frame-major single-channel dict (the contract of
    ``frame.pack_channel``)."""
    num_bfu = planes["num_bfu"].to(_I32)
    mode = planes["coding_mode"].to(_I32)
    wl = planes["wordlen"].to(_I32)
    sfi = planes["sfi"].to(_I32)
    mant = planes["mant"].to(_I32)
    gnp = planes["gain_npoints"].to(_I32)
    glev = planes["gain_levels"].to(_I32)
    gloc = planes["gain_locs"].to(_I32)
    n, dev = num_bfu.shape[0], num_bfu.device
    num_qmf = planes.get("num_qmf")
    num_qmf = _full(n, 4, dev) if num_qmf is None else num_qmf.to(_I32)

    vals, wids = [], []

    def emit(v, w):
        vals.append(v.to(_I32).reshape(n, -1))
        wids.append(w.to(_I32).reshape(n, -1))

    # channel id / JS params (atrac3_bitstream.cpp:848-853, 791-798)
    if js1:
        emit(_full(n, (0 << 13) | (7 << 10) | 0b11_11_11_11_11, dev),
             _full(n, 14, dev))
    else:
        emit(_full(n, 0x28, dev), _full(n, 6, dev))
    emit(num_qmf - 1, _full(n, 2, dev))

    in_band = torch.arange(4, device=dev)[None, :] < num_qmf[:, None]   # [N, 4]
    # gain points two per slot: a point is 9 bits (level << 5 | loc); the
    # active points are a prefix, so a pair slot holds its first
    # cnt = clamp(np - 2p, 0, 2) points in the high bits
    p4 = torch.arange(4, device=dev)
    pt = (glev << 5) | gloc                               # [N, 4, 8]
    pair_full = (pt[..., 0::2] << 9) | pt[..., 1::2]      # [N, 4, 4]
    cnt = torch.clamp(gnp[:, :, None] - 2 * p4, 0, 2)
    pair_v = pair_full >> (9 * (2 - cnt))
    gain_v, gain_w = [], []
    for band in range(4):
        gain_v.append(torch.where(in_band[:, band], gnp[:, band], 0)[:, None])
        gain_w.append(torch.where(in_band[:, band], 3, 0)[:, None])
        gain_v.append(pair_v[:, band])
        gain_w.append(9 * cnt[:, band])
    with trace.span("field_cat"):
        emit(torch.cat(gain_v, 1), torch.cat(gain_w, 1))
        pre_v = torch.cat(vals, 1)
        pre_w = torch.cat(wids, 1)
    with trace.span("offset_scan"):
        pre_off = torch.cumsum(pre_w, -1) - pre_w
    pre_end = pre_off[:, -1] + pre_w[:, -1]

    if "tonal_active" in planes:
        tv, tw, trel, tbits = _tonal_fields(planes)
    else:
        tv = torch.zeros((n, 1), dtype=_I32, device=dev)
        tw = torch.full((n, 1), 5, dtype=_I32, device=dev)
        trel = torch.zeros((n, 1), dtype=_I32, device=dev)
        tbits = _full(n, 5, dev)
    t_off = pre_end[:, None] + trel
    post_base = pre_end + tbits

    vals, wids = [], []
    emit(num_bfu - 1, _full(n, 5, dev))
    emit(mode, _full(n, 1, dev))

    in_use = torch.arange(32, device=dev)[None, :] < num_bfu[:, None]
    used = in_use & (wl > 0)
    wl_w = torch.where(in_use, 3, 0)
    for g in range(0, 32, 8):                     # 8 x 3b = 24 bits max
        emit(*_chain_merge([(wl[:, i], wl_w[:, i]) for i in range(g, g + 8)]))
    sfi_v = torch.where(used, sfi, 0)
    sfi_w = torch.where(used, 6, 0)
    for g in range(0, 32, 4):                     # 4 x 6b = 24 bits max
        emit(*_chain_merge([(sfi_v[:, i], sfi_w[:, i])
                            for i in range(g, g + 4)]))

    # spectrum planes (frame.pack_channel:198-231): the single-line codes of
    # wordlens 2..7 (CLC or the VLC codebook wl - 1), and the wl == 1 pairs
    k = _consts(dev)
    specs = k["specs"]
    line_valid = (torch.arange(_MAXLEN, device=dev)[None, :]
                  < specs[:, None])[None]
    clc_mode = used & (mode == 1)[:, None]
    vlc_mode = used & (mode == 0)[:, None]

    coded = ((wl >= 2) & (wl <= 7))[:, :, None]
    clc_w = torch.where(coded, k["clc_len"][torch.clamp(wl, 0, 7).long()]
                        [:, :, None], 0)
    clc_v = _mask_sign(mant, clc_w)
    vbits, vcode = _vlc_lookup(_vlc_idx(mant), torch.clamp(wl - 1, 0, 6)
                               [:, :, None].expand(mant.shape))
    vbits = torch.where(coded, vbits, 0)
    vcode = torch.where(coded, vcode, 0)

    single = (wl > 1)[:, :, None] & line_valid
    clc_w = torch.where(single & clc_mode[:, :, None], clc_w, 0)
    vlc_w = torch.where(single & vlc_mode[:, :, None], vbits, 0)

    pair_valid = (torch.arange(64, device=dev)[None, :]
                  < (specs // 2)[:, None])[None]
    a = mant[:, :, 0::2]
    b = mant[:, :, 1::2]
    # CLC_RTAB[m+2] for m in [-2,1] == (m+2) ^ 2 (atrac3.h:199-204)
    clcp_v = (((torch.clamp(a, -2, 1) + 2) ^ 2) << 2) \
        | ((torch.clamp(b, -2, 1) + 2) ^ 2)
    key = (3 * (torch.clamp(a, -1, 1) + 1) + (torch.clamp(b, -1, 1) + 1)).long()
    vlcp_v = k["pair_code"][key]
    vlcp_w = k["pair_bits"][key]

    wl_gt1 = (wl > 1)[:, :, None]
    spec_v = torch.where(wl_gt1, torch.where(clc_mode[:, :, None], clc_v,
                                             vcode), 0)
    spec_w = torch.where(wl_gt1, clc_w + vlc_w, 0)
    # unused BFUs can carry wl > 1 with garbage codes at width 0
    spec_v = torch.where(spec_w > 0, spec_v, 0)

    # slot j of a BFU covers lines (2j, 2j+1): two single-line codes
    # concatenate (first line in the high bits), or one wl == 1 pair code
    mv = (spec_v[:, :, 0::2] << spec_w[:, :, 1::2]) | spec_v[:, :, 1::2]
    mw = spec_w[:, :, 0::2] + spec_w[:, :, 1::2]
    pair_clc = clc_mode[:, :, None] & (wl == 1)[:, :, None] & pair_valid
    pair_vlc = vlc_mode[:, :, None] & (wl == 1)[:, :, None] & pair_valid
    mv = torch.where(pair_clc, clcp_v, torch.where(pair_vlc, vlcp_v, mv))
    mw = torch.where(pair_clc, 4, torch.where(pair_vlc, vlcp_w, mw))

    halves = [int(x) // 2 for x in T.SPECS_PER_BLOCK]
    with trace.span("field_cat"):
        emit(torch.cat([mv[:, b, :h] for b, h in enumerate(halves)], dim=1),
             torch.cat([mw[:, b, :h] for b, h in enumerate(halves)], dim=1))
        post_v = torch.cat(vals, 1)
        post_w = torch.cat(wids, 1)
    with trace.span("offset_scan"):
        post_off = post_base[:, None] + torch.cumsum(post_w, -1) - post_w

    with trace.span("field_cat"):
        values = torch.cat([pre_v, tv, post_v], 1)
        widths = torch.cat([pre_w, tw, post_w], 1)
        offsets = torch.cat([pre_off.to(_I32), t_off.to(_I32),
                             post_off.to(_I32)], 1)
    return values, widths, offsets


def _empty_js_channel1(n, dev):
    def z(*shape):
        return torch.zeros((n,) + shape, dtype=_I32, device=dev)
    return {"num_bfu": _full(n, 1, dev), "coding_mode": _full(n, 1, dev),
            "wordlen": z(32), "sfi": z(32), "mant": z(32, _MAXLEN),
            "gain_npoints": z(4), "gain_levels": z(4, 8), "gain_locs": z(4, 8),
            "num_qmf": _full(n, 1, dev)}


@trace.span("at3.pack")
def pack_device_batch(planes, frame_bytes, js=False):
    """Planes [S, C, F, ...] ([S, F] for ms_shift / loudness) -> [S, F,
    frame_bytes] uint8.  Packing is frame-local, so the stream axis folds
    into the frame axis of one ``pack_device`` call."""
    s, c, f = planes["num_bfu"].shape[:3]
    merged = {}
    for k, v in planes.items():
        if k in ("ms_shift", "loudness"):
            merged[k] = v.reshape((s * f,) + v.shape[2:])
        else:
            merged[k] = v.transpose(0, 1).reshape((c, s * f) + v.shape[3:])
    return _pack(merged, frame_bytes, js).reshape(s, f, frame_bytes)


@trace.span("at3.pack")
def pack_device(planes, frame_bytes, js=False):
    """Device counterpart of ``frame.pack``: [C, F, ...] planes -> [F,
    frame_bytes] uint8, with mono duplication, the JS byte reversal and the
    M/S byte-budget boundary (atrac3_bitstream.cpp:899-914)."""
    return _pack(planes, frame_bytes, js)


def _pack(planes, frame_bytes, js):
    c, n = planes["num_bfu"].shape[:2]
    dev = planes["num_bfu"].device
    half = frame_bytes // 2
    shift = planes.get("ms_shift")
    shift = torch.zeros(n, dtype=_I32, device=dev) if shift is None \
        else shift.to(_I32)

    chans = [{k: v[ch] for k, v in planes.items()
              if k not in ("loudness", "ms_shift")} for ch in range(c)]
    js1_flags = [False] * c
    if js and c == 1:
        chans.append(_empty_js_channel1(n, dev))
        js1_flags.append(True)
    elif js:
        js1_flags[1] = True

    # a non-JS channel owns `half` bytes of the frame; the JS boundary moves
    # per frame (M/S byte shift), so those buffers span the whole frame
    span = frame_bytes if js else half
    bufs = [deposit_fields(*channel_fields(p, js1=js1), span + _SLACK)[:, :span]
            for p, js1 in zip(chans, js1_flags)]

    if not js:
        return torch.cat([bufs[0], bufs[0] if c == 1 else bufs[1]], dim=1)
    return js_assemble(bufs[0], bufs[1], shift)


@trace.span("js_assemble")
def js_assemble(buf0, buf1, shift):
    """A JS frame from its two whole-frame deposits [N, frame_bytes]:
    channel 0's bytes before the boundary frame_bytes / 2 + shift [N],
    channel 1's bytes reversed from the frame's end after it
    (atrac3_bitstream.cpp:899-914)."""
    frame_bytes = buf0.shape[1]
    j = torch.arange(frame_bytes, device=buf0.device)[None, :]
    boundary = (frame_bytes // 2 + shift)[:, None]
    return torch.where(j < boundary, buf0, buf1.flip(1))
