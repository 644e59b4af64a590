"""ATRAC3 gain control, batched over all frames.

Port of ``atracdenc_tpu/models/atrac3/gain.py`` (reference
src/atrac3denc.cpp:299-579 CreateSubbandInfo + src/transient_detector.cpp
AnalyzeGain / CalcCurve + the spectral upsampler): the upsampler's analysis
region is three f32 matmuls; the per-subframe staircase runs as short
Python loops over [C, F, 4] lanes; the cross-frame context (LastLevel,
LastHpfEnergy, LastTarget) resolves with shifts and hold-last-valid gathers.

Layout: bands [C, F, 4, 256] with C any flattened stream x channel axis.
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch.shared import tables as T
from .mdct import gain_divisors

# upsampler (transient_spectral_upsampler.h:66-96)
_IN_N = 512
_UPS = 8
_OUT_N = 4096
_EPS = 0.15
_SAMPLE_RATE = 11025.0
_LOW_CUT_HZ = 800.0
_LOW_CUT_BIN = int(np.ceil(_LOW_CUT_HZ * _IN_N / _SAMPLE_RATE))   # 38
HIGH_FREQ_THRESHOLD = 0.05

# CreateSubbandInfo constants (atrac3denc.cpp:303,418,430)
_MIN_SCORE = 1.9
_MIN_SIGNAL = 1e-4
_MIN_HFR_FOR_AMPLIFY = 0.3

# CalcCurve constants (transient_detector.cpp)
_MIN_PLATEAU_LEN = 3
_MIN_PLATEAU_FRACTION = 0.4
_STICKY_MAX_INTRA = 7.0
_STICKY_MAX_INTER = 10.0
_TRANSIENT_WINDOW = 3
_MAX_CURVE_POINTS = 6

# Batcher odd-even mergesort network for 8 elements (19 compare-exchanges)
_NET8 = ((0, 1), (2, 3), (4, 5), (6, 7),
         (0, 2), (1, 3), (4, 6), (5, 7),
         (1, 2), (5, 6),
         (0, 4), (1, 5), (2, 6), (3, 7),
         (2, 4), (3, 5),
         (1, 2), (3, 4), (5, 6))


def _planck_window() -> np.ndarray:
    e_n = _EPS * _IN_N
    w = np.ones(_IN_N, np.float32)
    n = np.arange(_IN_N, dtype=np.float64)
    left = (n > 0) & (n < e_n)
    zp = np.where(left, e_n * (1.0 / np.where(left, n, 1)
                               + 1.0 / np.where(left, n - e_n, 1)), 0.0)
    w[left] = (1.0 / (1.0 + np.exp(zp[left]))).astype(np.float32)
    m = _IN_N - n
    right = (m > 0) & (m < e_n)
    zp = np.where(right, e_n * (1.0 / np.where(right, m, 1)
                                + 1.0 / np.where(right, m - e_n, 1)), 0.0)
    w[right] = (1.0 / (1.0 + np.exp(zp[right]))).astype(np.float32)
    w[0] = 0.0
    return w


def _hpf_response() -> np.ndarray:
    """H[k] for the 3-bin raised-cosine high-pass (upsampler step 3)."""
    h = np.ones(_IN_N // 2 + 1, np.float32)
    h[:_LOW_CUT_BIN] = 0.0
    h[_LOW_CUT_BIN] = 0.5
    h[_LOW_CUT_BIN + 1] = 1.0
    return h


@functools.lru_cache(maxsize=None)
def _region_matrices_np():
    """The upsampler is linear in x and the analysis reads only samples
    [1024, 3072) of its 4096 outputs: window + rFFT + HPF + 8x zero-pad +
    irFFT collapse into one [512, 2048] matrix, and the hfr energies into
    [512, 514] quadratic-form factors.  Built once in float64."""
    win = _planck_window().astype(np.float64)
    h = _hpf_response().astype(np.float64)
    spec = np.fft.rfft(np.diag(win), axis=1)             # [512, 257]
    y = spec * (h * _UPS)[None, :]
    y[:, _IN_N // 2] = spec[:, _IN_N // 2].real * (_UPS * 0.5)
    ypad = np.zeros((_IN_N, _OUT_N // 2 + 1), np.complex128)
    ypad[:, : y.shape[1]] = y
    sig = np.fft.irfft(ypad, n=_OUT_N, axis=1)           # [512, 4096]
    region = sig[:, 1024:3072]
    E = np.concatenate([spec.real, spec.imag], axis=1)   # [512, 514]
    Ef = E * np.concatenate([h, h])[None, :]
    return (region.astype(np.float32), E.astype(np.float32),
            Ef.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _consts(dev):
    m, e, ef = _region_matrices_np()
    return {"region": torch.as_tensor(m, device=dev),
            "E": torch.as_tensor(e, device=dev),
            "Ef": torch.as_tensor(ef, device=dev),
            "level": torch.as_tensor(T.GAIN_LEVEL, device=dev),
            "enc_win": torch.as_tensor(T.ENCODE_WINDOW, device=dev)}


def upsample_region(x):
    """[..., 512] -> (upsampled region [..., 2048], high_freq_ratio [...])."""
    c = _consts(x.device)
    region = torch.matmul(x, c["region"])
    sp = torch.matmul(x, c["E"])
    spf = torch.matmul(x, c["Ef"])
    total = torch.sum(sp * sp, dim=-1)
    filt = torch.sum(spf * spf, dim=-1)
    hfr = torch.where(total > 0, filt / total, 0.0)
    return region, hfr


def _rms(x):
    return torch.sqrt(torch.mean(x * x, dim=-1))


def analyze_gain(region):
    """[..., 2048] -> (gain [..., 32], lo, hi): AnalyzeGain with 32 points
    plus the 8-micro-chunk inter-quartiles from a 19-comparator network
    (transient_detector.cpp:95-136)."""
    sub = region.reshape(region.shape[:-1] + (32, 64))
    gain = _rms(sub)
    micro = _rms(sub.reshape(sub.shape[:-1] + (8, 8)))
    xs = [micro[..., i] for i in range(8)]
    for i, j in _NET8:
        xs[i], xs[j] = torch.minimum(xs[i], xs[j]), torch.maximum(xs[i], xs[j])
    return gain, xs[2], xs[6]


def _first_set_bit(v):
    """Position of the highest set bit of a non-negative int (0 for 0)."""
    out = torch.zeros_like(v)
    for k in range(1, 31):
        out = out + (v >= (1 << k)).to(v.dtype)
    return out


def relation_to_idx(x):
    """Amplitude ratio -> gain level index (transient_detector.cpp:141-149)."""
    lo = 4 + _first_set_bit(
        torch.trunc(1.0 / torch.clamp(x, min=0.00048828125)).to(torch.int32))
    hi = 4 - _first_set_bit(
        torch.trunc(torch.clamp(x, max=16.0)).to(torch.int32))
    return torch.where(x <= 0.5, lo, hi).to(torch.int32)


def _median3(x):
    """3-point median with the reference's 2-element edge windows
    (MedianFilter<1>, transient_detector.cpp:152-166)."""
    left = torch.cat([x[..., :1], x[..., :-1]], dim=-1)
    right = torch.cat([x[..., 1:], x[..., -1:]], dim=-1)
    mid = torch.maximum(torch.minimum(left, x),
                        torch.minimum(torch.maximum(left, x), right))
    lo_edge = torch.maximum(x[..., :1], x[..., 1:2])
    hi_edge = torch.maximum(x[..., -2:-1], x[..., -1:])
    return torch.cat([lo_edge, mid[..., 1:-1], hi_edge], dim=-1)


def _find_plateau(g):
    """FindPlateau (transient_detector.cpp:178-238) over [..., 32] lanes.
    Returns (level, max_raw, release_at_end)."""
    n = 32
    max_raw = torch.amax(g, dim=-1)
    f = _median3(g)
    win = torch.stack([f[..., j:j + n - 2] for j in range(3)], dim=-1)
    minv = torch.amin(win, dim=-1)                          # [..., 30]
    level = torch.amax(minv, dim=-1)
    j0 = torch.argmax(minv, dim=-1)                         # first max
    best_end = j0 + _MIN_PLATEAU_LEN - 1

    idx = torch.arange(n, device=g.device)
    above = f >= level[..., None]
    drop = (~above) & (idx > best_end[..., None])
    first_drop = torch.amin(torch.where(drop, idx, n), dim=-1)
    best_end = first_drop - 1

    found = level >= 1e-6
    tail = g[..., -1]
    hard = tail < level * 0.1
    after = idx > best_end[..., None]
    any_high_after = torch.any(after & (g >= (level * 0.7)[..., None]), dim=-1)
    soft = ~any_high_after & (tail < level * 0.5)
    release = (best_end < n - 1) & (hard | soft)
    level = torch.where(found, level, 0.0)
    release = release & found
    return level, max_raw, release


def _boundary_scores(f):
    """BoundaryTransientScore for every loc in [1, 32)
    (transient_detector.cpp:276-297); [..., 33] with slot 0 unused."""
    eps = 1e-9
    w = _TRANSIENT_WINDOW
    pad = torch.nn.functional.pad(f, (w, w), value=-np.inf)
    lwin = torch.stack([pad[..., 1 + k: 32 + k] for k in range(w)], dim=-1)
    rwin = torch.stack([pad[..., 1 + w + k: 32 + w + k] for k in range(w)],
                       dim=-1)
    lmax = torch.clamp(torch.amax(lwin, dim=-1), min=0.0)
    rmax = torch.clamp(torch.amax(rwin, dim=-1), min=0.0)
    attack = (rmax + eps) / (lmax + eps)
    release = (lmax + eps) / (rmax + eps)
    score = torch.maximum(attack, release)
    return torch.cat([torch.ones_like(f[..., :1]), score], dim=-1)


def calc_curve(gain, lo, hi, saved_last_level, saved_last_target, min_score):
    """CalcCurve (transient_detector.cpp:299-482) over [...] lanes.

    Returns (levels [..., 32], keep [..., 32], target, last_level,
    last_target); keep[sf] marks a curve point at loc = sf+1."""
    plateau, max_raw, release = _find_plateau(gain)
    use_plateau = (plateau > 1e-6) & ~release \
        & (plateau >= max_raw * _MIN_PLATEAU_FRACTION)
    target = torch.where(use_plateau, plateau, gain[..., -1])
    new_last_level = gain[..., -1]
    new_last_target = target

    emit = (target >= 1e-6) & (saved_last_level >= 1e-6)
    f = _median3(gain)
    max_gain = torch.amax(gain, dim=-1)

    intra = max_gain / torch.clamp(target, min=1e-9)
    hi_t = torch.maximum(saved_last_target, target)
    lo_t = torch.minimum(saved_last_target, target)
    inter = torch.where(saved_last_target > 1e-6,
                        hi_t / torch.clamp(lo_t, min=1e-9), 1.0)
    sticky = (intra <= _STICKY_MAX_INTRA) & (inter <= _STICKY_MAX_INTER)

    # per-subframe levels with sticky +-1 suppression (sequential in sf)
    t_safe = torch.clamp(target, min=1e-20)[..., None]
    center = relation_to_idx(f / t_safe)
    r_lo = lo / t_safe
    r_hi = hi / t_safe
    i_lo = relation_to_idx(torch.minimum(r_lo, r_hi))
    i_hi = relation_to_idx(torch.maximum(r_lo, r_hi))
    min_idx = torch.minimum(i_lo, i_hi)
    max_idx = torch.maximum(i_lo, i_hi)

    prev = center[..., 0]
    levels = [prev]
    for sf in range(1, 32):
        lvl, mn, mx = center[..., sf], min_idx[..., sf], max_idx[..., sf]
        hold = sticky & ((mx - mn) <= 1) & (torch.abs(lvl - prev) == 1) \
            & (prev >= mn) & (prev <= mx)
        prev = torch.where(hold, prev, lvl)
        levels.append(prev)
    sf_level = torch.stack(levels, dim=-1)

    # targetSf: one past the last non-neutral subframe among sf in [0, 31)
    sf_idx = torch.arange(32, device=gain.device)
    nonneutral = (sf_level != 4) & (sf_idx < 31)
    target_sf = torch.amax(torch.where(nonneutral, sf_idx + 1, 0), dim=-1)

    score = _boundary_scores(f)                               # [..., 33]

    # leftward transition scan from targetSf-1 (transient_detector.cpp:401-437)
    prev = torch.full_like(sf_level[..., 0], 4)
    keeps = [None] * 31
    deltas = [None] * 31
    for sf in range(30, -1, -1):
        lvl = sf_level[..., sf]
        loc = sf + 1
        change = (loc <= target_sf) & (lvl != prev)
        delta = torch.abs(lvl - prev)
        keep = change & ((loc == target_sf) | (delta >= 2)
                         | (score[..., loc] >= min_score))
        prev = torch.where(keep, lvl, prev)
        keeps[sf], deltas[sf] = keep, delta
    keep = torch.stack(keeps + [torch.zeros_like(keeps[0])], dim=-1)
    delta = torch.stack(deltas + [torch.zeros_like(deltas[0])], dim=-1)

    # trim to 6 points: priority = (delta desc, loc desc)
    d_i = delta[..., :, None]
    d_j = delta[..., None, :]
    l_i = sf_idx[:, None]
    l_j = sf_idx[None, :]
    outranks = keep[..., None, :] & ((d_j > d_i) | ((d_j == d_i) & (l_j > l_i)))
    rank = torch.sum(outranks, dim=-1)
    keep = keep & (rank < _MAX_CURVE_POINTS) & emit[..., None]
    return sf_level, keep, target, new_last_level, new_last_target


def _subframe_divisors(levels, locs, npoints):
    """BuildSubframeDivisors (atrac3denc.cpp:228-255)."""
    div = gain_divisors(levels, locs, npoints)
    return torch.mean(div.reshape(div.shape[:-1] + (32, 8)), dim=-1)


def _early_mismatch_score(gain, target, levels, locs, npoints):
    """CalcCurveEarlyMismatchScore (atrac3denc.cpp:259-297)."""
    eps = 1e-9
    div = _subframe_divisors(levels, locs, npoints)
    slot = torch.arange(levels.shape[-1], device=gain.device)
    max_loc = torch.amax(torch.where(slot < npoints[..., None], locs, 0), dim=-1)
    eval_sf = torch.clamp(max_loc + 3, min=3, max=32)
    sf = torch.arange(32, device=gain.device)
    active = sf < eval_sf[..., None]

    mod = gain / torch.clamp(div, min=eps)
    e = torch.log2(torch.clamp(mod, min=eps)
                   / torch.clamp(target, min=eps)[..., None])
    fit = torch.sum(torch.where(active, e * e, 0.0), dim=-1) / eval_sf

    a = torch.log2(torch.clamp(div, min=eps))
    d = a[..., 1:] - a[..., :-1]
    w = 0.5 * (gain[..., :-1] + gain[..., 1:])
    pair_active = (sf[:-1] + 1) < eval_sf[..., None]
    leak = torch.sum(torch.where(pair_active, d * d * w, 0.0), dim=-1)
    wsum = torch.sum(torch.where(pair_active, w, 0.0), dim=-1)
    leak = torch.where(wsum > eps, leak / wsum, leak)
    return torch.where(target > 1e-9, fit + 0.25 * leak, 0.0)


def _keep_to_points(sf_level, keep):
    """Transition planes -> (levels [..., 8], locs [..., 8], npoints [...]),
    the r-th kept subframe in slot r (ascending loc)."""
    n = torch.sum(keep, dim=-1)
    rank = torch.cumsum(keep.to(torch.int32), dim=-1) - 1
    slot = torch.arange(8, device=keep.device)
    oh = (keep[..., None] & (rank[..., None] == slot)).to(torch.int32)
    lev_sorted = torch.sum(sf_level[..., None] * oh, dim=-2)
    locs = (torch.arange(32, device=keep.device, dtype=torch.int32) + 1)
    loc_sorted = torch.sum(locs[:, None] * oh, dim=-2)
    valid = slot < n[..., None]
    return (torch.where(valid, lev_sorted, 0).to(torch.int32),
            torch.where(valid, loc_sorted, 0).to(torch.int32),
            n.to(torch.int32))


def init_ctx(c, dev):
    """Fresh cross-frame gain context (CurveCtx zeros + the band tail)."""
    z = torch.zeros((c, 4), dtype=torch.float32, device=dev)
    return {"last_level": z, "last_target": z.clone(), "last_hpf": z.clone(),
            "prev_tail": torch.zeros((c, 4, 128), dtype=torch.float32,
                                     device=dev)}


def assemble_up_in(bands, ctx, next_head=None):
    """Upsampler windows [C, F, 4, 512] = (prev 128 | frame 256 | next 128),
    with the chunk-carry tail from `ctx` and the lookahead `next_head`
    ([C, 4, 128], zeros at track end)."""
    c, f, nb, _ = bands.shape
    if next_head is None:
        next_head = torch.zeros((c, nb, 128), dtype=bands.dtype,
                                device=bands.device)
    stream = bands.transpose(1, 2).reshape(c, nb, f * 256)
    prev128 = torch.cat([ctx["prev_tail"], stream[..., :-128]], dim=-1)
    next128 = torch.cat([stream[..., 256:], next_head,
                         torch.zeros_like(stream[..., :128])], dim=-1)
    up_in = torch.cat([prev128.reshape(c, nb, f, 256)[..., :128],
                       stream.reshape(c, nb, f, 256),
                       next128.reshape(c, nb, f, 256)[..., :128]], dim=-1)
    return up_in.transpose(1, 2)                          # [C, F, 4, 512]


def gain_control(bands, ctx=None, next_head=None):
    """Gain-curve construction for a whole track (or one exact chunk).

    bands [C, F, 4, 256]; ctx the carried context (init_ctx at track
    start); next_head [C, 4, 128] the lookahead (zeros at track end).
    Returns (levels [C, F, 4, 8], locs [C, F, 4, 8], npoints [C, F, 4],
    ctx_out)."""
    c, f, nb, _ = bands.shape
    dev = bands.device
    if ctx is None:
        ctx = init_ctx(c, dev)
    gl = _consts(dev)["level"]
    up_in = assemble_up_in(bands, ctx, next_head)

    region, hfr = upsample_region(up_in)
    gain, lo, hi = analyze_gain(region)
    valid = hfr >= HIGH_FREQ_THRESHOLD                    # CalcCurve ran here

    # cross-frame context (shift / hold-last-valid over the frame axis)
    cur_hpf = torch.mean(gain, dim=-1)
    fidx = torch.arange(f, device=dev)[None, :, None]
    last_valid = torch.cummax(torch.where(valid, fidx, -1), dim=1).values
    prev_valid = torch.cat([torch.full_like(last_valid[:, :1], -1),
                            last_valid[:, :-1]], dim=1)

    def hold(x, default):
        g = torch.gather(x, 1, torch.clamp(prev_valid, min=0))
        return torch.where(prev_valid >= 0, g, default)

    prev_hpf = hold(cur_hpf, ctx["last_hpf"][:, None])
    hpf_overlap = torch.where((cur_hpf > 1e-9) & (prev_hpf > 1e-9),
                              prev_hpf / cur_hpf, 1.0)
    dyn_min_score = _MIN_SCORE * torch.clamp(hpf_overlap, 1.0, 1.5)

    # LastLevel is set on every frame: 0 when hfr-skipped, else gain[31]
    last_level_f = torch.where(valid, gain[..., -1], 0.0)
    saved_last_level = torch.cat([ctx["last_level"][:, None],
                                  last_level_f[:, :-1]], dim=1)

    # the target depends only on the plateau analysis, so the LastTarget
    # hold chain resolves before the full curve construction
    plateau, max_raw_p, release = _find_plateau(gain)
    use_plateau = (plateau > 1e-6) & ~release \
        & (plateau >= max_raw_p * _MIN_PLATEAU_FRACTION)
    tgt = torch.where(use_plateau, plateau, gain[..., -1])
    saved_last_target = hold(torch.where(valid, tgt, 0.0),
                             ctx["last_target"][:, None])
    sf_level, keep, tgt, _, _ = calc_curve(
        gain, lo, hi, saved_last_level, saved_last_target, dyn_min_score)
    keep = keep & valid[..., None]
    # an empty CalcCurve result skips the whole band, point0 included
    had_curve = torch.any(keep, dim=-1)

    # --- CreateSubbandInfo post-processing (atrac3denc.cpp:410-562) ---
    max_gain = torch.amax(gain, dim=-1)
    band_idx = torch.arange(4, device=dev)[None, None, :]
    clear = (max_gain < _MIN_SIGNAL) | (hfr < _MIN_HFR_FOR_AMPLIFY) \
        | (band_idx >= 3)
    keep = keep & ~clear[..., None]

    levels, locs, npts = _keep_to_points(sf_level, keep)

    # explicit point0 (bands < 3 only)
    prev_target = saved_last_target
    loc0 = locs[..., 0]
    lev0 = levels[..., 0]
    has_pts = npts > 0
    n_before = torch.where(has_pts, loc0, 0)
    sf = torch.arange(32, device=dev)
    pre_sum = torch.sum(torch.where(sf < n_before[..., None], gain, 0.0), dim=-1)
    pre_mean = pre_sum / torch.clamp(n_before, min=1)
    rms_next_mod = torch.where(
        has_pts & (loc0 > 0), pre_mean / gl[lev0.long()],
        torch.where(~has_pts, torch.mean(gain, dim=-1), 0.0))
    rms_valid = (~has_pts) | (loc0 > 0)

    can_p0 = valid & had_curve & (band_idx < 3) & rms_valid \
        & (prev_target > 1e-6) & (rms_next_mod > 1e-6)
    p0_level = relation_to_idx(
        prev_target / torch.clamp(rms_next_mod, min=1e-20))
    insert = can_p0 & ((p0_level != 4) | has_pts)

    # candidate curve with point0 prepended
    lev_p0 = torch.cat([p0_level[..., None], levels[..., :-1]], dim=-1)
    loc_p0 = torch.cat([torch.zeros_like(loc0)[..., None], locs[..., :-1]],
                       dim=-1)
    np_p0 = torch.clamp(npts + 1, max=8)

    # guard (atrac3denc.cpp:509-553)
    score_before = _early_mismatch_score(gain, tgt, levels, locs, npts)
    score_after = _early_mismatch_score(gain, tgt, lev_p0, loc_p0, np_p0)
    desired = torch.clamp(prev_target / torch.clamp(rms_next_mod, min=1e-20),
                          float(T.GAIN_LEVEL[15]), float(T.GAIN_LEVEL[0]))
    first_lev_before = torch.where(has_pts, lev0, 4)
    err_before = torch.abs(torch.log2(
        torch.clamp(gl[first_lev_before.long()], min=1e-9)
        / torch.clamp(desired, min=1e-9)))
    err_after = torch.abs(torch.log2(
        torch.clamp(gl[p0_level.long()], min=1e-9)
        / torch.clamp(desired, min=1e-9)))
    keep_by_boundary = (err_after + 0.20) < err_before
    revert = ~keep_by_boundary & (score_after > score_before * 1.02)
    use_p0 = insert & ~revert

    levels = torch.where(use_p0[..., None], lev_p0, levels)
    locs = torch.where(use_p0[..., None], loc_p0, locs)
    npts = torch.where(use_p0, np_p0, npts)

    # drop a redundant point0 (same level as the next point, :556-562)
    redundant = (npts >= 2) & (locs[..., 0] == 0) \
        & (levels[..., 0] == levels[..., 1])
    lev_drop = torch.cat([levels[..., 1:], torch.zeros_like(levels[..., :1])],
                         dim=-1)
    loc_drop = torch.cat([locs[..., 1:], torch.zeros_like(locs[..., :1])],
                         dim=-1)
    levels = torch.where(redundant[..., None], lev_drop, levels)
    locs = torch.where(redundant[..., None], loc_drop, locs)
    npts = torch.where(redundant, npts - 1, npts)

    slot_valid = torch.arange(8, device=dev) < npts[..., None]

    # carried context after the last frame of this chunk
    lv = last_valid[:, -1]                                # [C, 4]

    def at_last(x, default):
        g = torch.gather(x, 1, torch.clamp(lv, min=0)[:, None])[:, 0]
        return torch.where(lv >= 0, g, default)

    ctx_out = {
        "last_level": last_level_f[:, -1],
        "last_target": at_last(torch.where(valid, tgt, 0.0),
                               ctx["last_target"]),
        "last_hpf": at_last(cur_hpf, ctx["last_hpf"]),
        "prev_tail": bands[:, -1, :, 128:],
    }
    return (torch.where(slot_valid, levels, 0),
            torch.where(slot_valid, locs, 0), npts, ctx_out)


def safe_energy_scale(orig, mod):
    """SafeEnergyScale (atrac3denc.cpp:143-152)."""
    bad = (orig <= 1e-20) | (mod <= 1e-20) \
        | ~torch.isfinite(orig) | ~torch.isfinite(mod)
    s = orig / mod
    return torch.where(bad | ~torch.isfinite(s) | (s <= 0), 1.0, s)


def energy_scale(bands, div, scale, prev_half=None, prev_overlap_init=None):
    """CalcGainEnergyScale.Frame per band frame (atrac3denc.cpp:175-224).

    bands [C, F, 4, 256], div the per-frame divisor curves, scale the
    per-frame first gain level; prev_half / prev_overlap_init carry the
    stored MDCT half and NextOverlapScale across chunks.  Returns
    (gs_frame [C, F, 4], (stored_last [C, 4, 256], next_overlap_last
    [C, 4]))."""
    enc_win = _consts(bands.device)["enc_win"]
    stored = enc_win * (bands / div)
    if prev_half is None:
        prev_half = torch.zeros_like(stored[:, 0])
    prev_stored = torch.cat([prev_half[:, None], stored[:, :-1]], dim=1)
    prev_stored_e = torch.sum(prev_stored * prev_stored, dim=-1)

    mod = bands / div
    w_cur = torch.flip(enc_win, [0])
    def energy(x, w):
        y = x * w
        return torch.sum(y * y, dim=-1)

    cur_orig = energy(bands, w_cur)
    cur_mod = energy(mod, w_cur)
    next_orig = energy(bands, enc_win)
    next_mod = energy(mod, enc_win)

    next_overlap = safe_energy_scale(next_orig, next_mod)
    init = (torch.ones_like(next_overlap[:, :1]) if prev_overlap_init is None
            else prev_overlap_init[:, None])
    prev_overlap_scale = torch.cat([init, next_overlap[:, :-1]], dim=1)
    prev_overlap_scale = torch.where(
        torch.isfinite(prev_overlap_scale) & (prev_overlap_scale > 0),
        prev_overlap_scale, 1.0)

    prev_orig = prev_stored_e * prev_overlap_scale
    prev_mod = prev_stored_e / (scale * scale)
    gs = safe_energy_scale(prev_orig + cur_orig, prev_mod + cur_mod)
    return gs, (stored[:, -1], next_overlap[:, -1])
