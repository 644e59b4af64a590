"""ATRAC3+ frame serialization on the device.

Port of ``atracdenc_tpu/models/atrac3p/device_pack.py``: byte-identical to
the host ``frame.pack``, producing the fixed 2048-byte frames with
``ops/bitdeposit.deposit_fields``.  Bit layout per the reference writer
(src/atrac/at3p/at3p_bitstream.cpp).

  * the header / wordlen sections depend only on numQU: per-numQU field
    tables, one row gathered per frame;
  * per-QU spectra: one merged field per VLC code group (group flag, code
    and sign bits in one field of at most 18 bits), packed 2,048 slots a
    channel with their offsets and the section's bits: kernel I
    (``csrc/at3p_spectrum.cu``) on a card, codes each group at its QU's
    chosen table only; the plain version codes the static (wordlen, block
    length) classes at all 8 table families and keeps the chosen one, with
    the codebooks read by an integer gather (the JAX form uses an exact
    one-hot matmul for the same lookup);
  * the tonal block has a fixed entity grid whose widths are masked and
    whose offsets are prefix sums; both the ascending and the descending
    frequency layouts are built and the cheaper one keeps its widths
    (CreateFreqBitPack, at3p_bitstream.cpp:41-94).

Everything is integer arithmetic on int32 / int64 tensors (values are
taken as their low 32 bits, the JAX package's uint32).
"""
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from atracdenc_tpu_torch import kernels, trace
from atracdenc_tpu_torch.ops.bitdeposit import deposit_fields
from . import frame as host_frame
from . import tables as T

MAX_W = 8                   # wave slots carried by the encoder planes
_POW2 = tuple(1 << k for k in range(1, 31))


# --- static per-numQU section tables ---------------------------------------

@lru_cache(maxsize=None)
def _nq_tables(channels):
    """Per-numQU [33, S] (values, widths) for everything before the
    scale-factor section (header + wordlen sections)."""
    max_slots = 4 + 5 + 31 + 3 + 32          # header + ch0 wl + ch1 wl
    vals = np.zeros((33, max_slots), np.int64)
    wids = np.zeros((33, max_slots), np.int32)
    for nq in range(1, 33):
        fields = [(0, 1), (channels - 1, 2), (nq - 1, 5), (0, 1)]
        fields += host_frame._wl_fields(nq)
        if channels == 2:
            fields += host_frame._wl_fields_ch1(nq)
        for k, (v, w) in enumerate(fields):
            vals[nq, k] = v
            wids[nq, k] = w
    return vals, wids


@lru_cache(maxsize=None)
def _npwr_table():
    out = np.zeros(33, np.int32)
    for nq in range(1, 33):
        out[nq] = int(T.SUBBAND_TO_NUM_POWGRPS[T.QU_TO_SUBBAND[nq - 1]])
    return out


def _wordlen_section_bits():
    """([33], [33]) ch0/ch1 wordlen-section bits per numQU, summed from the
    packer's own field widths (TWordLenEncoder, at3p_bitstream.cpp:156-247)."""
    ch0 = np.zeros(33, np.int64)
    ch1 = np.zeros(33, np.int64)
    for nq in range(1, 33):
        ch0[nq] = sum(w for _, w in host_frame._wl_fields(nq))
        ch1[nq] = sum(w for _, w in host_frame._wl_fields_ch1(nq))
    return ch0, ch1


_WL_BITS_CH0, _WL_BITS_CH1 = _wordlen_section_bits()


def const_bits(channels):
    """[33] per-numQU section bits that don't depend on the spectra."""
    nq = np.arange(33)
    bits = np.zeros(33, np.int64)
    bits += 5 + 1                                   # TConfigure
    bits += _WL_BITS_CH0
    if channels == 2:
        bits += _WL_BITS_CH1
    bits += channels * (2 + 6 * nq)                 # TSfIdx
    bits += 1 + channels * (1 + 2 + 1 + 3 * nq)     # EncodeCodeTab (full table)
    pwr = T.SUBBAND_TO_NUM_POWGRPS[T.QU_TO_SUBBAND[np.maximum(nq, 1) - 1]]
    bits += channels * 4 * pwr                      # power-comp stubs
    if channels == 2:
        bits += 2                                   # swap/negate flags
    bits += channels * 1                            # window shape (all sine)
    bits += channels * 1                            # gain comp
    bits += 1                                       # no tonal block
    bits += 1 + 2                                   # no noise + terminator
    return bits


@lru_cache(maxsize=None)
def _table(name, dev):
    """A host table as a tensor on ``dev``, built once per device: the
    packer's and the encoder's (the VLC costing's shifts and code lengths,
    the numQU shrink's candidates and constant bits)."""
    if name == "tone_bands":
        a = np.stack([T.TONE_BANDS_CODE, T.TONE_BANDS_LEN])
    elif name == "npwr":
        a = _npwr_table()
    elif name == "pow2":
        a = np.asarray(_POW2, np.int32)
    elif name[0] == "spec":
        a = np.stack([T.SPEC_CODE[name[1]], T.SPEC_LEN[name[1]]])
    elif name[0] == "shifts":                 # ("shifts", bits, nc)
        a = name[1] * np.arange(name[2], dtype=np.int32)
    elif name == "num_qu":                    # the shrink's candidates
        a = np.asarray([32] + list(range(28, 0, -1)), np.int32)
    elif name[0] == "const_bits":             # ("const_bits", channels)
        a = const_bits(name[1]).astype(np.int32)
    elif name == "code_tab":                  # widths, offsets of its header
        a = np.asarray([[1, 2, 1], [0, 1, 3]], np.int32)
    elif name == "spec_book":                 # kernel I's tables
        a = _spec_book()
    else:                                     # ("nq", channels)
        return tuple(torch.as_tensor(x, device=dev)
                     for x in _nq_tables(name[1]))
    return torch.as_tensor(np.asarray(a), device=dev)


def _fsb(x):
    """Index of the highest set bit of max(x, 1), as 31 - clz."""
    pow2 = _table("pow2", x.device)
    return (torch.clamp(x, min=1)[..., None] >= pow2).sum(-1, dtype=torch.int32)


def _excl_cumsum(w, dim=-1):
    return torch.cumsum(w, dim) - w


# --- spectra: one merged field per code group ------------------------------

@lru_cache(maxsize=None)
def _qu_classes():
    """QU runs sharing (wordlen, block length): [(q0, q1, wl, ln)]."""
    classes = []
    q = 0
    while q < 32:
        wl = int(T.FIXED_WORDLEN[q])
        ln = int(T.SPECS_PER_BLOCK[q])
        e = q
        while e < 32 and int(T.FIXED_WORDLEN[e]) == wl \
                and int(T.SPECS_PER_BLOCK[e]) == ln:
            e += 1
        classes.append((q, e, wl, ln))
        q = e
    return classes


def spectrum_fields_torch(mant, spec_tab, num_qu, pos):
    """Plain version of ``spectrum_fields``; arguments and results as
    there.  Per (wordlen, block length) class of QUs it codes every group
    at each of the 8 table families and keeps the family each QU chose."""
    n = mant.shape[0]
    dev = mant.device
    in_nq = torch.arange(32, device=dev)[None, :] < num_qu[:, None]
    vals, wids = [], []
    for q0, q1, wl, ln in _qu_classes():
        m = mant[:, q0:q1, :ln]                  # [N, Q, ln]
        fam = spec_tab[:, q0:q1]                 # [N, Q]
        cls_v = torch.zeros(m.shape, dtype=torch.int64, device=dev)
        cls_w = torch.zeros(m.shape, dtype=torch.int32, device=dev)
        for f in range(8):
            tab_idx = 7 * f + wl - 1
            gs, nc, bits, signed = (int(x) for x in T.SPECTRA_TABS[tab_idx])
            ncodes = ln // nc
            grp = m.reshape(m.shape[:2] + (ncodes, nc)).to(torch.int64)
            if signed:
                t = grp & ((1 << bits) - 1)
                sw = torch.zeros(grp.shape[:-1], dtype=torch.int64, device=dev)
                signpack = torch.zeros_like(sw)
            else:
                t = torch.abs(grp)
                nz = (grp != 0).to(torch.int64)
                # sign bits MSB-first in mantissa order: each sign shifts
                # left by the number of signed mantissas after it (a masked
                # sum over the <= 4 mantissas of a code: torch's scan kernel
                # is slow on so short an inner axis)
                later = torch.ones((nc, nc), dtype=torch.bool,
                                   device=dev).triu(1)
                after = (nz[..., None, :] * later).sum(-1)
                signpack = ((grp < 0).to(torch.int64) << after).sum(-1)
                sw = nz.sum(-1)
            val = (t << _table(("shifts", bits, nc), dev)).sum(-1)

            # codebook lookup: rows (code, len) of the table, gathered
            cl = _table(("spec", tab_idx), dev)[:, val]
            code, clen = cl[0].to(torch.int64), cl[1].to(torch.int64)

            # merge group flag (first code of each gs-run) + code + signs
            gi = torch.arange(ncodes, device=dev)
            flag = ((gi % gs == 0) & (gs != 1)).to(torch.int64)
            v = (flag << (clen + sw)) + (code << sw) + signpack
            w = flag + clen + sw
            pad = ln - ncodes
            if pad:
                v = F.pad(v, (0, pad))
                w = F.pad(w, (0, pad))
            sel = ((fam == f) & in_nq[:, q0:q1])[..., None]
            cls_v = torch.where(sel, v, cls_v)
            cls_w = torch.where(sel, w.to(torch.int32), cls_w)
        vals.append(cls_v.reshape(n, -1))
        wids.append(cls_w.reshape(n, -1))
    values, widths = torch.cat(vals, 1), torch.cat(wids, 1)
    offsets = (pos[:, None] + _excl_cumsum(widths)).to(torch.int32)
    return values, widths, offsets, widths.sum(-1, dtype=torch.int32)


def _spec_book():
    """Kernel I's tables as int32 words (``csrc/at3p_spectrum.cu``): per
    (family, wordlen) table 7 * family + wordlen - 1 its gs | nc << 8 |
    bits << 16 | signed << 24; per QU its start | length << 12 | wordlen
    << 20; per 16 slots their QU; then the 56 codebooks used, code | length
    << 12 in 16 bits an entry, two entries a word."""
    tabs = T.SPECTRA_TABS[:56].astype(np.int64)
    params = tabs[:, 0] | tabs[:, 1] << 8 | tabs[:, 2] << 16 | tabs[:, 3] << 24
    geom = (T.SPECS_START.astype(np.int64) | T.SPECS_PER_BLOCK << 12
            | T.FIXED_WORDLEN.astype(np.int64) << 20)
    qu_of = np.repeat(np.arange(32), T.SPECS_PER_BLOCK // 16)
    code, length = T.SPEC_CODE[:56], T.SPEC_LEN[:56]
    if code.max() >= 1 << 12 or code.min() < 0 or length.max() >= 1 << 4 \
            or length.min() < 0:
        raise ValueError("kernel I: a codeword does not fit 12 + 4 bits")
    if not np.isin(tabs[:, 0], (1, 2, 4)).all():
        raise ValueError("kernel I: a group size is not 1, 2 or 4")
    entries = (code | length << 12).astype(np.uint16).reshape(-1)
    return np.concatenate([params, geom, qu_of,
                           entries.view(np.int32)]).astype(np.int32)


def _spectrum_fields_cuda(mant, spec_tab, num_qu, pos):
    """Kernel I's launch (``csrc/at3p_spectrum.cu``)."""
    n = mant.shape[0]
    i32 = torch.int32
    if mant.dtype != i32 or mant.dim() != 3 or tuple(mant.shape[1:]) != (32, 128) \
            or spec_tab.dtype != i32 or tuple(spec_tab.shape) != (n, 32) \
            or any(t.dtype != i32 or tuple(t.shape) != (n,)
                   for t in (num_qu, pos)):
        raise ValueError("spectrum_fields: need mant [F, 32, 128], spec_tab "
                         "[F, 32], num_qu and pos [F], all int32")
    mant, spec_tab, num_qu, pos = (t.contiguous() for t in
                                   (mant, spec_tab, num_qu, pos))
    dev = mant.device
    book = _table("spec_book", dev)
    values = torch.empty((n, 2048), dtype=torch.int64, device=dev)
    widths = torch.empty((n, 2048), dtype=i32, device=dev)
    offsets = torch.empty((n, 2048), dtype=i32, device=dev)
    bits = torch.empty((n,), dtype=i32, device=dev)
    kernels.require_cuda("spectrum_fields", mant, spec_tab, num_qu, pos, book,
                         values, widths, offsets, bits, align=4)
    if mant.data_ptr() % 16:
        raise ValueError("spectrum_fields: mant not 16-byte aligned")
    kernels.check(kernels.library().at3p_spectrum_fields(
        mant.data_ptr(), spec_tab.data_ptr(), num_qu.data_ptr(), pos.data_ptr(),
        book.data_ptr(), values.data_ptr(), widths.data_ptr(),
        offsets.data_ptr(), bits.data_ptr(), n, book.numel(),
        kernels.stream_ptr(mant)), "spectrum_fields")
    trace.count("launch.at3p_spectrum")
    return values, widths, offsets, bits


@trace.span("spectrum_fields")
def spectrum_fields(mant, spec_tab, num_qu, pos):
    """The spectrum section of one channel, one merged field per VLC code
    group (group flag, code and sign bits).

    mant [F, 32, 128], spec_tab [F, 32] (family 0..7), num_qu [F] and pos
    [F] (the section's first bit) int32.  Returns values [F, 2048] int64,
    widths and absolute bit offsets [F, 2048] int32 and the section's bits
    [F] int32: code group g of QU q sits at slot SPECS_START[q] + g (a QU
    of ln lines has at most ln groups); a slot past its QU's groups or of a
    QU at or past num_qu has value and width 0; offsets run in slot order.

    A CPU tensor takes ``spectrum_fields_torch``; a CUDA tensor launches
    kernel I or raises."""
    if mant.device.type == "cpu":
        return spectrum_fields_torch(mant, spec_tab, num_qu, pos)
    return _spectrum_fields_cuda(mant, spec_tab, num_qu, pos)


# --- tonal block -----------------------------------------------------------

def _sb_flags_fields(flags, nb):
    """WriteSubbandFlags as 2 + 8 masked slots; flags [N, 8] bool, nb [N].
    Returns (values [N, 10], widths [N, 10])."""
    n = flags.shape[0]
    in_nb = torch.arange(8, device=flags.device)[None, :] < nb[:, None]
    f = flags & in_nb
    s = f.sum(-1)
    all_set = s == nb
    none = s == 0
    v0 = torch.where(none, 0, 1)
    v1 = torch.where(all_set, 0, 1)
    w1 = torch.where(none, 0, 1)
    per = torch.where((~none & ~all_set)[:, None] & in_nb, 1, 0)
    vals = torch.cat([v0[:, None], v1[:, None], f.to(torch.int64)], dim=1)
    wids = torch.cat([torch.ones((n, 1), dtype=torch.int64,
                                 device=flags.device), w1[:, None], per], dim=1)
    return vals.to(torch.int64), wids.to(torch.int32)


@trace.span("tonal_fields")
def tonal_fields_device(tones, channels):
    """Tonal-block fields with explicit in-block offsets.

    tones: wire-effective planes (freq/amp_sf/phase/valid [C, F, 8, W],
    env_start/env_stop [C, F, 8], sharing [F, 8], leader [F]).
    Returns (values [F, S], widths [F, S], rel_offsets [F, S],
    total_bits [F], nb [F])."""
    valid = tones["valid"]
    c, f = valid.shape[:2]
    dev = valid.device
    sb8 = torch.arange(8, device=dev)
    any_sb = valid.any(-1).any(0)                       # [F, 8] any channel
    nb = torch.amax(torch.where(any_sb, sb8 + 1, 0), dim=-1).to(torch.int32)
    present = nb > 0

    if channels == 2:
        leader = tones["leader"].to(torch.int32)        # [F]
        sharing = tones["sharing"] & (sb8[None, :] < nb[:, None])
    else:
        leader = torch.zeros((f,), dtype=torch.int32, device=dev)
        sharing = torch.zeros((f, 8), dtype=torch.bool, device=dev)

    def wire(x, wch):
        """Wire channel wch (0 = the leader) of x [C, F, ...]."""
        if c == 1:
            return x[0]
        use1 = (leader == 1) if wch == 0 else (leader == 0)
        return torch.where(use1.reshape((f,) + (1,) * (x.dim() - 2)),
                           x[1], x[0])

    vals, wids, offs = [], [], []

    def emit(v, w, o):
        vals.append(v.to(torch.int64).reshape(f, -1))
        wids.append(w.to(torch.int32).reshape(f, -1))
        offs.append(o.to(torch.int32).reshape(f, -1))

    def g(w):
        return torch.where(present, w, 0)

    z = torch.zeros((f,), dtype=torch.int32, device=dev)
    one = torch.ones((f,), dtype=torch.int32, device=dev)

    # header: amplitude mode, num tone bands VLC
    emit(one, g(one), z)
    tb = _table("tone_bands", dev)[:, torch.clamp(nb - 1, min=0).long()]
    nb_code, nb_len = tb[0], tb[1].to(torch.int32)
    pos = g(one)
    emit(nb_code, g(nb_len), pos)
    pos = pos + g(nb_len)

    if channels == 2:
        shv, shw = _sb_flags_fields(sharing, nb)
        shw = torch.where(present[:, None], shw, 0)
        emit(shv, shw, pos[:, None] + _excl_cumsum(shw))
        pos = pos + shw.sum(-1)
        ldv, ldw = _sb_flags_fields(
            F.pad((leader == 1)[:, None], (0, 7)), one)
        ldv, ldw = ldv[:, :3], torch.where(present[:, None], ldw[:, :3], 0)
        emit(ldv, ldw, pos[:, None] + _excl_cumsum(ldw))
        pos = pos + ldw.sum(-1)
        emit(z, g(one), pos)                            # no phase inversion
        pos = pos + g(one)

    for wch in range(channels):
        coded = (sb8[None, :] < nb[:, None]) & (
            ~sharing if wch == 1 else torch.ones_like(sharing))
        w_valid = wire(valid, wch)                      # [F, 8, W]
        nw = w_valid.sum(-1)                            # [F, 8]
        es = wire(tones["env_start"], wch)
        et = wire(tones["env_stop"], wch)
        freq = torch.where(w_valid, wire(tones["freq"], wch), 0)
        asf = wire(tones["amp_sf"], wch)
        ph = wire(tones["phase"], wch)

        if wch:
            emit(z, g(one), pos)                        # own envelope data
            pos = pos + g(one)

        # envelopes: per sb 4 slots (start flag, start, stop flag, stop)
        sp = (es >= 0) & coded
        tp = (et >= 0) & coded
        ev = torch.stack([sp.to(torch.int64), torch.clamp(es, min=0),
                          tp.to(torch.int64), torch.clamp(et, min=0)], -1)
        ew = torch.stack([torch.where(coded, 1, 0), torch.where(sp, 5, 0),
                          torch.where(coded, 1, 0), torch.where(tp, 5, 0)],
                         -1)                            # [F, 8, 4]
        ew_flat = ew.reshape(f, 32)
        emit(ev.reshape(f, 32), ew_flat, pos[:, None] + _excl_cumsum(ew_flat))
        pos = pos + ew_flat.sum(-1)

        # num-waves mode + counts
        emit(z, g(one * (wch + 1)), pos)
        pos = pos + g(one * (wch + 1))
        nw_w = torch.where(coded, 4, 0)
        emit(nw, nw_w, pos[:, None] + _excl_cumsum(nw_w))
        pos = pos + nw_w.sum(-1)

        if wch:
            emit(z, g(one), pos)                        # freqs independent
            pos = pos + g(one)

        # frequency packs: order bit + asc/desc layouts (the cheaper one
        # keeps its widths).  Waves are frequency-ascending in slot order.
        has = coded & (nw > 0)
        hv = w_valid & has[..., None]
        wi = torch.arange(MAX_W, device=dev)
        # ascending: first 10 bits; then 10 if prev < 512 else fsb(1023-prev)+1
        prev_a = F.pad(freq[..., :-1], (1, 0))
        wa = torch.where(prev_a < 512, 10, _fsb(1023 - prev_a) + 1)
        wa = torch.where(wi == 0, 10, wa)
        va = torch.where(wi == 0, freq, torch.where(
            prev_a < 512, freq, freq - (1024 - (1 << torch.clamp(wa, 0, 10)))))
        wa = torch.where(hv, wa, 0)
        bits_asc = wa.sum(-1)
        # descending: emitted from the highest wave down; first field is the
        # highest freq at 10 bits, then width = fsb(prev)+1 with prev = the
        # next-higher wave's freq
        last_i = torch.clamp(nw - 1, min=0)
        is_last = wi[None, None, :] == last_i[..., None]
        prev_d = F.pad(freq[..., 1:], (0, 1))
        wd = torch.where(is_last, 10, _fsb(prev_d) + 1)
        wd = torch.where(hv, wd, 0)
        vd = torch.where(is_last, freq,
                         freq & ((1 << torch.clamp(wd, 0, 10)) - 1))
        bits_desc = wd.sum(-1)
        multi = nw > 1
        # CreateFreqBitPack returns asc only when strictly cheaper (desc
        # wins ties, at3p_bitstream.cpp:88-93); single-wave has no order bit
        use_desc = multi & (bits_asc >= bits_desc) & has
        ob_w = torch.where(has & multi, 1, 0)
        pack_bits = torch.where(use_desc, bits_desc,
                                torch.where(has, bits_asc, 0))
        sb_bits = ob_w + pack_bits                      # [F, 8]
        sb_off = pos[:, None] + _excl_cumsum(sb_bits)
        emit(use_desc, ob_w, sb_off)
        base = sb_off + ob_w
        # asc offsets: cumsum of wa in slot order; desc offsets: fields run
        # highest wave first, so slot i sits after the widths of slots > i
        off_a = base[..., None] + _excl_cumsum(wa)
        off_d = base[..., None] + wd.flip(-1).cumsum(-1).flip(-1) - wd
        ud = use_desc[..., None]
        emit(torch.where(ud, vd, va) * w_valid, torch.where(ud, wd, wa),
             torch.where(ud, off_d, off_a))
        pos = pos + sb_bits.sum(-1)

        # amplitude mode + amp sf + phases
        emit(z, g(one * (wch + 1)), pos)
        pos = pos + g(one * (wch + 1))
        aw_flat = torch.where(hv, 6, 0).reshape(f, -1)
        emit((asf * w_valid).reshape(f, -1), aw_flat,
             pos[:, None] + _excl_cumsum(aw_flat))
        pos = pos + aw_flat.sum(-1)
        pw_flat = torch.where(hv, 5, 0).reshape(f, -1)
        emit((ph * w_valid).reshape(f, -1), pw_flat,
             pos[:, None] + _excl_cumsum(pw_flat))
        pos = pos + pw_flat.sum(-1)

    return (torch.cat(vals, 1), torch.cat(wids, 1), torch.cat(offs, 1),
            pos, nb)


# --- frame assembly --------------------------------------------------------

@trace.span("at3p.pack")
def pack_device(planes, channels):
    """Device counterpart of frame.pack: planes -> [F, 2048] uint8.

    planes: num_qu [F], sfi / spec_tab [C, F, 32], mant [C, F, 32, 128] and
    optional tones (wire-ordered, as ``encode_track`` returns them), all
    tensors on one device."""
    num_qu = planes["num_qu"].to(torch.int32)            # [F]
    sfi = planes["sfi"].to(torch.int32)                  # [C, F, 32]
    mant = planes["mant"].to(torch.int32)                # [C, F, 32, 128]
    spec_tab = planes["spec_tab"].to(torch.int32)        # [C, F, 32]
    tones = planes.get("tones")
    f = num_qu.shape[0]
    dev = num_qu.device
    in_nq = torch.arange(32, device=dev)[None, :] < num_qu[:, None]

    vals, wids, offs = [], [], []

    def emit(v, w, o):
        vals.append(v.to(torch.int64).reshape(f, -1))
        wids.append(w.to(torch.int32).reshape(f, -1))
        offs.append(o.to(torch.int32).reshape(f, -1))

    def full(n, v):
        return torch.full((f, n), v, dtype=torch.int32, device=dev)

    # header + wordlen sections (function of numQU only)
    hv, hw = _table(("nq", channels), dev)
    head_v, head_w = hv[num_qu.long()], hw[num_qu.long()]
    head_off = _excl_cumsum(head_w)
    emit(head_v, head_w, head_off)
    pos = head_off[:, -1] + head_w[:, -1]

    # scale factors: per ch (0,2) + nq x 6
    for ch in range(channels):
        emit(full(1, 0), full(1, 2), pos)
        pos = pos + 2
        w6 = torch.where(in_nq, 6, 0)
        emit(torch.where(in_nq, sfi[ch], 0), w6, pos[:, None] + _excl_cumsum(w6))
        pos = pos + w6.sum(-1)

    # code-table section (useFullTable=1)
    emit(full(1, 1), full(1, 1), pos)
    pos = pos + 1
    ct_w, ct_o = _table("code_tab", dev)
    for ch in range(channels):
        emit(full(3, 0), ct_w.expand(f, 3), pos[:, None] + ct_o)
        pos = pos + 4
        w3 = torch.where(in_nq, 3, 0)
        emit(torch.where(in_nq, spec_tab[ch], 0), w3,
             pos[:, None] + _excl_cumsum(w3))
        pos = pos + w3.sum(-1)

    # spectra + power stubs per channel
    npwr = _table("npwr", dev)[num_qu.long()]             # [F]
    for ch in range(channels):
        sv, sw, so, sbits = spectrum_fields(mant[ch], spec_tab[ch], num_qu,
                                            pos.to(torch.int32))
        emit(sv, sw, so)
        pos = pos + sbits
        pw = torch.where(torch.arange(5, device=dev)[None, :] < npwr[:, None],
                         4, 0)
        emit(full(5, 15), pw, pos[:, None] + _excl_cumsum(pw))
        pos = pos + pw.sum(-1)

    # window shapes (sine), gain comp, tonal, noise, terminator
    if channels == 2:
        emit(full(1, 0), full(1, 2), pos)
        pos = pos + 2
    for _ in range(2 * channels):
        emit(full(1, 0), full(1, 1), pos)
        pos = pos + 1
    if tones is not None:
        tv, tw, trel, tbits, nb = tonal_fields_device(tones, channels)
        emit(nb > 0, full(1, 1), pos)
        pos = pos + 1
        emit(tv, tw, pos[:, None] + trel)
        pos = pos + tbits
    else:
        emit(full(1, 0), full(1, 1), pos)
        pos = pos + 1
    emit(full(1, 0), full(1, 1), pos)                       # no noise
    pos = pos + 1
    emit(full(1, 3), full(1, 2), pos)                       # terminator
    return deposit_fields(torch.cat(vals, 1), torch.cat(wids, 1),
                          torch.cat(offs, 1), T.FRAME_BYTES)
