"""Helpers for holding the port against the JAX package on the CPU.

The tests feed the same numpy arrays to a JAX function and to its port and
compare the results as numpy arrays.  This module imports no JAX: JAX
results arrive here as arrays that ``np.asarray`` accepts.
"""
import numpy as np
import torch

from atracdenc_tpu_torch import runtime

# Float intermediates differ by reduction order only (XLA and torch sum in
# different orders); integer and decision planes must be equal.
RTOL, ATOL = 1e-5, 1e-7


def cpu_setup():
    """One intra-op thread: the tier-1 run has several pytest workers."""
    torch.set_num_threads(1)
    return torch.device("cpu")


def roll_jax_scans(monkeypatch, lax):
    """Make the JAX reference compile every ``lax.scan`` rolled (unroll=1).

    The JAX package unrolls the EA greedy scan fully on the CPU
    (atracdenc_tpu/ops/quant.py:151), so each XLA:CPU compile of its quant
    memo takes ~40 s and of its encoder ~70 s.  ``unroll`` changes how the
    loop is compiled, not its ops or their order: the rolled and unrolled
    JAX encoders give bit-identical planes on at3_default_golden's pcm_in
    (default and no-gain modes), and compile in ~2-8 s.  Pass pytest's
    ``monkeypatch`` and ``jax.lax``."""
    scan = lax.scan
    monkeypatch.setattr(lax, "scan",
                        lambda *a, **kw: scan(*a, **{**kw, "unroll": 1}))


def t(a):
    """numpy / JAX array -> CPU tensor with JAX's canonical dtypes."""
    return runtime.to_torch(np.asarray(a), "cpu")


def n(x):
    return runtime.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_equal(ref, got, name=""):
    ref, got = n(ref), n(got)
    assert ref.shape == got.shape, f"{name}: shape {ref.shape} vs {got.shape}"
    assert ref.dtype == got.dtype, f"{name}: dtype {ref.dtype} vs {got.dtype}"
    assert np.array_equal(ref, got), \
        f"{name}: {int((ref != got).sum())} of {ref.size} values differ"


def assert_close(ref, got, name="", rtol=RTOL, atol=ATOL, peak=None):
    """Within rtol / atol; ``peak`` adds an absolute tolerance of
    peak * max|ref| for sums with cancellation (matmul outputs), where an
    element's error scales with its terms, not with its value."""
    ref, got = n(ref), n(got)
    if peak is not None:
        atol = max(atol, peak * float(np.abs(ref).max()))
    assert ref.shape == got.shape, f"{name}: shape {ref.shape} vs {got.shape}"
    assert ref.dtype == got.dtype, f"{name}: dtype {ref.dtype} vs {got.dtype}"
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def deposit_case(seed, total_bytes, f=6, k=256):
    """Fields for ``deposit_fields`` (values uint32, widths int32, offsets
    int32 [f, k] numpy) with the layouts its routes could get wrong, and the
    rows whose fields all fit in ``total_bytes`` (the ones a sequential
    packer can take).

    Each row's fields lie back to back from bit 0, widths 0 to 32, in a
    shuffled column order; width-0 fields carry stray values and offsets.
    Row 0 starts with a 31-bit and a 32-bit field (the second straddles
    words 0 and 1 from bit 31) and stops at the frame's last bit or before;
    row 1 ends exactly on it with a field as wide as fits; row 2 has a
    field across the end and fields past it; row 3 lies wholly past the
    end (past the sink word too); the other rows run on past the end."""
    rng = np.random.default_rng(seed)
    bits = 8 * total_bytes
    widths = np.zeros((f, k), np.int64)
    for r in range(f):
        limit = bits if r < 2 else bits + 200
        row = [31, 32] if r == 0 else []
        while len(row) < k and sum(row) < limit:
            row.append(int(rng.integers(0, 33)) if rng.random() > 0.2 else 0)
        while sum(row) > limit or (r < 2 and sum(row) > bits):
            row.pop()
        if r == 1 and len(row) < k and sum(row) < bits:
            row.append(min(32, bits - sum(row)))
        widths[r, :len(row)] = row
    offsets = np.zeros((f, k), np.int64)
    np.cumsum(widths[:, :-1], axis=1, out=offsets[:, 1:])
    offsets[3:4] += 40 * (bits + 64)
    values = rng.integers(0, 1 << 32, (f, k), dtype=np.uint64)
    gone = widths == 0
    values[~gone] &= (np.uint64(1) << widths[~gone].astype(np.uint64)) \
        - np.uint64(1)
    offsets[gone] = rng.integers(0, 4 * bits + 64, int(gone.sum()))
    perm = rng.permutation(k)
    fits = (np.where(gone, 0, offsets + widths).max(axis=1) <= bits)
    return (values[:, perm].astype(np.uint32), widths[:, perm].astype(np.int32),
            offsets[:, perm].astype(np.int32), np.flatnonzero(fits))


def spectrum_case(seed, f=64):
    """Inputs of ATRAC3+'s ``spectrum_fields`` (mant [f, 32, 128], spec_tab
    [f, 32], num_qu [f] int32 numpy) that reach every branch of its routes.

    Frame i codes QU q with family (i + q) % 8, so every (wordlen, family)
    table comes up in each 8 frames, and keeps (7 i) % 32 + 1 QUs, every
    count from 1 to 32 in 32 frames.  A QU's mantissas lie in the
    encoder's range for its wordlen, |m| <= round(0.99999 * INV_MANT_TAB[wl])
    (1, 2, 3, 5, 7, 14, 28: scaled values stay inside +-0.99999, and every
    group of them has a codeword in all 8 tables), drawn by frame and QU:
    uniform, at the range's two ends, all zero, or sparse (a quarter
    nonzero).  Lines past a QU's length hold stray values that no route
    may read."""
    from atracdenc_tpu_torch.models.atrac3p import tables as T
    rng = np.random.default_rng(seed)
    mant = rng.integers(-999, 1000, (f, 32, 128)).astype(np.int32)
    spec_tab = ((np.arange(f)[:, None] + np.arange(32)[None, :]) % 8).astype(np.int32)
    num_qu = ((7 * np.arange(f)) % 32 + 1).astype(np.int32)
    for q in range(32):
        wl, ln = int(T.FIXED_WORDLEN[q]), int(T.SPECS_PER_BLOCK[q])
        hi = int(np.round(np.float32(0.99999) * T.INV_MANT_TAB[wl]))
        lo = -hi
        for i in range(f):
            mode = (i + q // 8) % 4
            if mode == 0:
                m = rng.integers(lo, hi + 1, ln)
            elif mode == 1:
                m = np.where(rng.random(ln) < 0.5, lo, hi)
            elif mode == 2:
                m = np.zeros(ln, np.int64)
            else:
                m = np.where(rng.random(ln) < 0.25,
                             rng.integers(lo, hi + 1, ln), 0)
            mant[i, q, :ln] = m
    return mant, spec_tab, num_qu


def gha_lanes(seed, lanes=4096):
    """Inputs for the ATRAC3+ GHA greedy (``gha.greedy``): x [L, 128] f32
    of 0 to 4 tones a lane (anywhere on the 2048-point grid and between its
    bins, band-sample amplitudes 10 to 3,000) over Gaussian noise (5 to 500
    rms), with every lane's fit length 128, max_keep 8, its subband's ATH
    (lane l is subband l % 8) and every lane active; numpy arrays."""
    from atracdenc_tpu_torch.models.atrac3p.gha import _SUBBAND_ATH
    rng = np.random.default_rng(seed)
    n = np.arange(128, dtype=np.float64)
    x = rng.standard_normal((lanes, 128)) * rng.uniform(5, 500, (lanes, 1))
    tones = rng.integers(0, 5, lanes)
    for j in range(4):
        on = (tones > j)[:, None]
        f = rng.uniform(1, 1023, (lanes, 1))
        amp = np.exp(rng.uniform(np.log(10), np.log(3000), (lanes, 1)))
        phase = rng.uniform(0, 2 * np.pi, (lanes, 1))
        x += np.where(on, amp * np.sin(2 * np.pi * f * n / 2048 + phase), 0)
    return {"x": x.astype(np.float32),
            "fit_len": np.full(lanes, 128, np.int32),
            "max_keep": np.full(lanes, 8, np.int32),
            "sb_ath": _SUBBAND_ATH[np.arange(lanes) % 8],
            "active": np.ones(lanes, bool)}


def gha_edge_lanes(seed):
    """``gha_lanes``' format, lanes at the greedy's edges: all zeros; one
    tone cut to fit lengths 1, 17 and 127; max_keep 0 and 8; eight tones on
    the grid 100 bins apart and 2^(-1/4) apart in amplitude, which the
    greedy accepts all 8 rounds of; two inactive lanes; then 56 lanes of
    ``gha_lanes`` with random fit lengths (1 to 128), max_keep (0 to 8) and
    activity."""
    edge = gha_lanes(seed, 64)
    rng = np.random.default_rng(seed + 1)
    n = np.arange(128)
    tone = (900.0 * np.sin(2 * np.pi * 137 * n / 2048 + 0.3)).astype(np.float32)
    eight = sum(2.0 ** ((40 - j) / 4) * np.sin(
        2 * np.pi * (50 + 100 * j) * n / 2048 + np.pi * j / 16)
        for j in range(8)).astype(np.float32)
    rows = [(np.zeros(128, np.float32), 128, 8, True), (tone, 1, 8, True),
            (tone, 17, 8, True), (tone, 127, 8, True), (tone, 128, 0, True),
            (tone, 128, 8, True), (eight, 128, 8, True), (tone, 128, 8, False),
            (eight, 128, 8, False)]
    for i, (x, fit, keep, on) in enumerate(rows):
        edge["x"][i], edge["fit_len"][i] = x, fit
        edge["max_keep"][i], edge["active"][i] = keep, on
    rest = slice(len(rows), None)
    m = 64 - len(rows)
    edge["fit_len"][rest] = rng.integers(1, 129, m)
    edge["max_keep"][rest] = rng.integers(0, 9, m)
    edge["active"][rest] = rng.random(m) < 0.7
    return edge


def gha_round(x, fit, n_fit, freq, valid, max_amp, sb_ath):
    """One round of ``gha._greedy``'s arithmetic on every lane: the same
    tensor ops in the same order on the same shapes, so the same floats.
    -> {b, sf, ph, amp, resid [L, 128], gates (all but ``k < max_keep``),
    and each decision's two sides: top1, top2 (mag2's two largest), e_new,
    e_cut (0.9 e_old), amp2 (amp^2), ath, amp_cut (max_amp / 10), and the
    quantisers' inputs sf_in (4 log2 amp + 3) and ph_in (phi_steps / 64)}."""
    from atracdenc_tpu_torch.models.atrac3p import gha
    re, im = gha._lane_spectrum(x)
    mag2 = torch.where(torch.arange(1024, device=x.device) >= 1,
                       re * re + im * im, 0.0)
    b = torch.argmax(mag2, dim=-1).to(torch.int32)
    bl = b.long()[:, None]
    re_b, im_b = re.gather(1, bl)[:, 0], im.gather(1, bl)[:, 0]
    amp = 2.0 * torch.sqrt(re_b * re_b + im_b * im_b) / n_fit
    phi = torch.atan2(im_b, re_b) + np.pi / 2.0
    phi_steps = torch.remainder(phi * (2048.0 / (2.0 * np.pi)), 2048.0)
    sf, amp_q, ph = gha._quantize_wave(amp, phi_steps, b.to(torch.float32))
    pos = ((ph[:, None] << 6)
           + torch.arange(128, device=x.device, dtype=torch.int32)
           * b[:, None]) & 2047
    tone = torch.where(fit, amp_q[:, None] * torch.sin(
        2.0 * np.pi * pos.to(torch.float32) / 2048.0), 0.0)
    e_old = torch.sum(x * x, dim=-1)
    resid = x - tone
    e_new = torch.sum(resid * resid, dim=-1)
    dist = torch.where(valid, torch.abs(freq - b[:, None]), 1 << 20)
    e_cut, amp_cut = e_old * 0.9, max_amp / 10.0
    gates = ((e_new < e_cut) & (amp * amp > sb_ath) & (amp > amp_cut)
             & (torch.amin(dist, dim=-1) >= gha.MIN_FREQ_DIST))
    top = torch.topk(mag2, 2, dim=-1).values
    return {"b": b, "sf": sf, "ph": ph, "amp": amp, "resid": resid,
            "gates": gates, "top1": top[:, 0], "top2": top[:, 1],
            "e_new": e_new, "e_cut": e_cut, "amp2": amp * amp, "ath": sb_ath,
            "amp_cut": amp_cut,
            "sf_in": 4.0 * torch.log2(torch.clamp(amp, min=1e-20)) + 3.0,
            "ph_in": phi_steps / 64.0}


def gha_replay(x, fit_len, max_keep, sb_ath, active=None, seed=0):
    """Kernel H's control flow with ``gha_round``'s arithmetic: round 0
    lists the active lanes (every lane for None) with max_keep > 0; a round
    decides for the listed lanes only, writes each result at the lane's own
    index, and lists, in an order shuffled by ``seed``, the lanes that
    accepted with another round left under max_keep.
    -> (freq, sf, ph, valid, lane-rounds computed, [each round's
    ``gha_round`` dict with its listed lanes under "listed"])."""
    from atracdenc_tpu_torch.models.atrac3p import gha
    lanes, dev, w = x.shape[0], x.device, gha.MAX_WAVES
    rng = np.random.default_rng(seed)
    fit = torch.arange(128, device=dev) < fit_len[:, None]
    work = torch.where(fit, x, 0.0)
    n_fit = torch.clamp(fit.sum(-1), min=1).to(torch.float32)
    freq, sf, ph = (torch.zeros((lanes, w), dtype=torch.int32, device=dev)
                    for _ in range(3))
    valid = torch.zeros((lanes, w), dtype=torch.bool, device=dev)
    max_amp = torch.zeros(lanes, device=dev)
    on = max_keep > 0
    if active is not None:
        on = on & active
    listed = torch.nonzero(on)[:, 0]
    rounds, n = [], 0
    for k in range(w):
        if not len(listed):
            break
        n += len(listed)
        r = gha_round(work, fit, n_fit, freq, valid, max_amp, sb_ath)
        rounds.append(dict(r, listed=listed))
        acc = listed[r["gates"][listed]]
        work[acc] = r["resid"][acc]
        freq[acc, k], sf[acc, k], ph[acc, k] = r["b"][acc], r["sf"][acc], \
            r["ph"][acc]
        valid[acc, k] = True
        max_amp[acc] = torch.maximum(max_amp[acc], r["amp"][acc])
        nxt = acc[(k + 1 < w) & (k + 1 < max_keep[acc])]
        listed = nxt[torch.from_numpy(rng.permutation(len(nxt))).to(dev)]
    return freq, sf, ph, valid, n, rounds


def gha_rounds_of(valid, max_keep, active):
    """Lane-rounds that H computes, from its planes: one round a kept wave
    and the round that stopped the lane, under min(max_keep, 8), on the
    active lanes."""
    cap = torch.clamp(max_keep, 0, valid.shape[-1])
    n = valid.sum(-1)
    return int(torch.where(active, torch.minimum(n + 1, cap), 0).sum())


def gain_case(seed, c=3, f=5):
    """Inputs of ATRAC3's ``gain.gain_analysis``: bands [c, f, 4, 256],
    prev_tail and next_head [c, 4, 128] f32 numpy.  Each (channel, band)
    draws a kind, kept over its frames and tails: noise, a sine under or
    over the high-pass cut (800 Hz of the band's 11,025 Hz), bursts of
    noise in one quarter of a frame (transients) or decaying noise; each
    band-frame a level from -80 to 0 dB or, one in eight, digital
    silence."""
    rng = np.random.default_rng(seed)
    n = np.arange(256 * (f + 1))
    bands = np.zeros((c, 4, 256 * (f + 1)))
    for ch, b in np.ndindex(c, 4):
        kind = rng.integers(0, 5)
        if kind == 0:
            x = rng.standard_normal(n.size)
        elif kind in (1, 2):
            hz = rng.uniform(50, 700) if kind == 1 else rng.uniform(900, 5000)
            x = np.sin(2 * np.pi * hz * n / 11025.0 + rng.uniform(0, 6.3))
        elif kind == 3:
            x = 0.01 * rng.standard_normal(n.size)
            for fr in range(f + 1):
                q = 256 * fr + 64 * rng.integers(0, 4)
                x[q:q + 64] += rng.standard_normal(64)
        else:
            x = rng.standard_normal(n.size) * np.exp(-(n % 256)
                                                     / rng.uniform(10, 200))
        level = 10.0 ** rng.uniform(-4, 0, f + 1)
        level[rng.random(f + 1) < 0.125] = 0.0
        bands[ch, b] = x * np.repeat(level, 256)
    frames = bands[..., 128:128 + 256 * f].reshape(c, 4, f, 256)
    return (frames.transpose(0, 2, 1, 3).astype(np.float32),
            bands[..., :128].astype(np.float32),
            bands[..., 128 + 256 * f:].astype(np.float32))


def gain_windows(bands, prev_tail, next_head=None):
    """Kernel J's window gather (``csrc/at3_gain.cu`` load_windows) in
    numpy: [C * F * 4, 512], each 16-byte chunk of window w read from the
    flat array and offset the kernel computes."""
    c, f = bands.shape[:2]
    flat_b, flat_p = bands.reshape(-1), prev_tail.reshape(-1)
    flat_n = None if next_head is None else next_head.reshape(-1)
    out = np.zeros((c * f * 4, 512), np.float32)
    for w in range(c * f * 4):
        cf, b = w >> 2, w & 3
        fr, ch = cf % f, cf // f
        for k in range(0, 512, 4):
            if k < 128:
                src, o = (flat_b, ((cf - 1) * 4 + b) * 256 + 128 + k) if fr > 0 \
                    else (flat_p, (ch * 4 + b) * 128 + k)
            elif k < 384:
                src, o = flat_b, (cf * 4 + b) * 256 + (k - 128)
            elif fr < f - 1:
                src, o = flat_b, ((cf + 1) * 4 + b) * 256 + (k - 384)
            elif flat_n is not None:
                src, o = flat_n, (ch * 4 + b) * 128 + (k - 384)
            else:
                continue
            out[w, k:k + 4] = src[o:o + 4]
    return out


def gain_kernel_model(windows, tiles, hcol):
    """Kernel J's arithmetic on the CPU, as its threads hold it: the ten
    packed N-tiles ``tiles`` [10, 512, 256] times the windows [W, 512]
    (torch), thread t of an N-tile taking positions 4t..4t+3 and
    128+4t..128+4t+3 as its columns 8t..8t+7; a micro-chunk's squares
    summed in order, a subframe's RMS from its 8 micro sums, the sorting
    network's ranks 2 and 6, and hfr from the spectrum tiles' squares with
    h.  -> (region [W, 2048], sp [W, 512], gain, lo, hi [W, 32], hfr [W])."""
    from atracdenc_tpu_torch.models.atrac3.gain import _NET8
    t = np.arange(32)[:, None]
    pos = np.concatenate([4 * t + np.arange(4), 128 + 4 * t + np.arange(4)],
                         axis=1).ravel()          # column 8t + j at pos[8t + j]
    prod = torch.einsum("wk,nkp->nwp", windows, tiles)[..., pos]
    region = prod[:8].permute(1, 0, 2).reshape(-1, 2048)
    sp = prod[8:].permute(1, 0, 2).reshape(-1, 512)
    sq = (region * region).reshape(-1, 32, 8, 8)
    micro = sq[..., 0]
    for j in range(1, 8):
        micro = micro + sq[..., j]
    total = micro[..., 0]
    for i in range(1, 8):
        total = total + micro[..., i]
    gain = torch.sqrt(total / 64.0)
    xs = [torch.sqrt(micro[..., i] / 8.0) for i in range(8)]
    for a, b in _NET8:
        xs[a], xs[b] = torch.minimum(xs[a], xs[b]), torch.maximum(xs[a], xs[b])
    filt = sp * hcol
    tot = torch.sum(sp * sp, dim=-1)
    fil = torch.sum(filt * filt, dim=-1)
    hfr = torch.where(tot > 0, fil / tot, 0.0)
    return region, sp, gain, xs[2], xs[6], hfr


# Kernel J: the largest gap a plane may show from the plain route, over the
# window's input RMS (hfr: as it is), from f32 sums of 512 products taken in
# another order (``gain_gaps``).  On one atrac3-lp2.batch call's 262,144
# windows of music the H100 measured at most 1.55e-6 (hi) and 4.8e-7 (hfr);
# a misplaced column or window reads ~1.
GAIN_TOL = {"gain": 2e-5, "lo": 2e-5, "hi": 2e-5, "hfr": 5e-6}


def gain_cell_call(dev, seed=2500000123, streams=64, frames=512):
    """The windows' inputs of ``gain.gain_analysis`` in one ATRAC3 call at
    the ``atrac3-lp2.batch`` cell's shape: ``streams`` ``portbench.music``
    tracks x ``frames`` frames, a track's first chunk with its lookahead,
    as ``gain_control`` passes them.  -> (bands, prev_tail, next_head)."""
    from atracdenc_tpu_torch.models.atrac3 import encoder, gain
    from atracdenc_tpu_torch.trace_encode import capture
    from portbench import music
    pcm = music.tracks(streams, 1024 * (frames + 1), seed, dev)
    pcm = pcm.to(torch.float32) / 32768.0
    cur = pcm[..., :1024 * frames].contiguous()
    nxt = pcm[..., 1024 * frames:].contiguous()
    del pcm
    (a, kw), = capture([(gain, "gain_control", "J")],
                       lambda: encoder.encode_frames_chunk(
                           cur, None, nxt, no_gain_control=False,
                           no_tonal=False))["J"]
    return a[0], kw["ctx"]["prev_tail"], kw["next_head"]


def gain_gaps(got, want, bands, prev_tail, next_head=None):
    """Gaps of kernel J's planes (gain, lo, hi, hfr) from the plain route's,
    as two numbers a plane: the largest |got - want| over the window's input
    RMS (a sum of 512 products errs with its terms, not its value), and the
    largest relative gap where want is over 1e-3 of that RMS.  The window's
    input RMS comes from ``gain.assemble_up_in``."""
    from atracdenc_tpu_torch.models.atrac3 import gain
    x = gain.assemble_up_in(bands, prev_tail, next_head)
    rms = torch.sqrt(torch.mean(x * x, dim=-1))           # [C, F, 4]
    gaps = {}
    for name, g, w in zip(("gain", "lo", "hi", "hfr"), got, want):
        d = (g - w).abs()
        if name == "hfr":            # a ratio in [0, 1]: its gap as it is
            gaps[name] = (float(d.max()),) * 2
            continue
        s = rms[..., None]
        scaled = torch.where(s > 0, d / s, torch.where(d > 0, np.inf, 0.0))
        big = w.abs() > 1e-3 * s
        rel = torch.where(big, d / w.abs().clamp(min=1e-30), 0.0)
        gaps[name] = (float(scaled.max()), float(rel.max()))
    return gaps
