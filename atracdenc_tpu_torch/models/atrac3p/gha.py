"""ATRAC3+ GHA tonal model: sinusoid extraction, envelopes, stereo sharing.

Port of ``atracdenc_tpu/models/atrac3p/gha.py`` (reference
src/atrac/at3p/at3p_gha.cpp), with the same wire model and the same
decisions:

  * extraction: per (channel, frame, subband) greedy rounds on the
    zero-padded 2048-point spectrum (one [128, 1024] cos / sin matmul pair,
    whose bins are the 10-bit FreqIndex grid), amplitudes quantised to the
    6-bit 2^((sf-3)/4) ladder and phases to 5 bits, gated by the subband ATH,
    the 23 dB-below-max cutoff and the 20-bin minimum tone distance;
  * envelopes: the longest run of 4-sample blocks where the fit lowers the
    energy, a refit on the truncated window, and the next-frame continuation
    check that decides whether a full-length tone carries a stop point;
  * stereo: the follower shares the leader's tones in a subband when all its
    frequencies are in the leader's set;
  * synthesis as the ffmpeg decoder does it (ff_atrac3p_generate_tones,
    atrac3plusdsp.c:77-204, amplitude mode 1), so the residual handed to the
    MDCT subtracts exactly what a decoder adds back.

The JAX ``fori_loop`` rounds are Python loops here (``_greedy``, the plain
version); on the card the greedy rounds are kernel H (``greedy``,
``csrc/gha_greedy.cu``), which runs only the lanes still searching.  Sorts
are stable, as ``jnp.argsort`` is, and ``argmax`` takes the first maximum.

Wire planes produced by ``extract`` (a leading stream axis S is optional
on every function: bands [S, C, F, 16, 128] give planes with S in front):
  freq/amp_sf/phase/valid : [C, F, 8, MAX_WAVES]
  env_start, env_stop     : [C, F, 8] int32, -1 = point absent
  sharing                 : [F, 8] bool  (C == 2 only; else all False)
  leader                  : [F] int32    (0 or 1)
Planes are wire-effective: shared subbands carry the leader's waves in both
channels' slots, so subtract() / synthesize() see what a decoder sees.
"""
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from atracdenc_tpu_torch import kernels, trace
from atracdenc_tpu_torch import runtime  # noqa: F401  (f32 policy)
from atracdenc_tpu_torch.ops.psy import calc_ath

NUM_TONE_SUBBANDS = 8       # the reference analyzes subbands 0..7
MAX_WAVES = 8               # greedy rounds per subband (wire allows 15)
MIN_FREQ_DIST = 20          # DoRound's minFreqDistanse
MAX_TOTAL_TONES = 48        # ApplyFilter aborts above this (at3p_gha.cpp:629)
_ACCEPT_RATIO = 0.9         # keep a tone only if it removes >=10% of energy
_WAVE_KEYS = ("freq", "amp_sf", "phase", "valid")
_ENV_KEYS = ("env_start", "env_stop")


def _subband_ath() -> np.ndarray:
    """[8] power thresholds at the 0dB=32768 level (FillSubbandAth,
    at3p_gha.cpp:453-465)."""
    ath = calc_ath(16 * 1024, 44100)
    m = ath.reshape(16, 1024).min(axis=1)[:NUM_TONE_SUBBANDS]
    return np.power(10.0, 0.1 * (m + 90.0)).astype(np.float32)


_SUBBAND_ATH = _subband_ath()


@lru_cache(maxsize=None)
def _const(name, dev):
    """Host tables on ``dev``, built once per device."""
    if name == "ath":
        a = _SUBBAND_ATH
    elif name in ("dft_c", "dft_s"):
        a = _dft_mats()[name == "dft_s"]
    elif name == "pqf":
        from .pqf import _analysis_kernel
        return torch.as_tensor(_analysis_kernel().T, device=dev).to(
            torch.complex64)
    elif name == "tone_sin":                # _greedy's sin at each pos
        pos = torch.arange(2048, device=dev)
        return torch.sin(2.0 * np.pi * pos.to(torch.float32) / 2048.0)
    elif name == "ladder":                  # _amp_ladder at each sf
        return _amp_ladder(torch.arange(64, dtype=torch.int32, device=dev))
    else:                                   # ("cos" | "sin", length)
        kind, length = name
        a = _wave_tables(length)[kind == "sin"]
    return torch.as_tensor(a, device=dev)


def _amp_ladder(sf):
    """2^((sf - 3) / 4) in f32, as the JAX package computes it."""
    return torch.pow(2.0, (sf.to(torch.float32) - 3.0) / 4.0)


def _quantize_wave(amp, phi_steps, freq):
    """Quantize (amplitude, phase-in-steps-at-frame-start, freq bin); the
    phase is that at the content frame's own sample 0 (see the JAX
    package's docstring for the decoder alignment)."""
    sf = torch.clamp(torch.floor(4.0 * torch.log2(torch.clamp(amp, min=1e-20))
                                 + 3.0), 0, 63).to(torch.int32)
    amp_q = _amp_ladder(sf)
    ph = torch.round(phi_steps / 64.0).to(torch.int32) & 31
    return sf, amp_q, ph


@lru_cache(maxsize=None)
def _wave_tables(length):
    """cos/sin of 2*pi*f*i/2048 on the 10-bit FreqIndex grid: [1024, length]."""
    f = np.arange(1024, dtype=np.int64)[:, None]
    i = np.arange(length, dtype=np.int64)[None, :]
    ang = 2.0 * np.pi * ((f * i) % 2048) / 2048.0
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _wave_sum(freq, ph, amp, i_offset, length=128):
    """Sum of waves over samples [0, length): pos = (ph<<6) + (i+i_offset)*f.
    freq/ph/amp: [..., W]; returns [..., length].

    sin(alpha_w + 2*pi*f_w*i/2048) expands into two fixed [1024, length]
    tables contracted with per-wave coefficients on the 1024-bin grid.  The
    JAX package builds those coefficients as a one-hot sum over the waves;
    here they are added with ``scatter_add_``.  The sums are equal: the valid
    frequencies of a lane are distinct (the 20-bin guard) and every other
    slot adds an exact zero."""
    dev = freq.device
    base = torch.remainder((ph << 6) + i_offset * freq, 2048)
    alpha = (2.0 * np.pi / 2048.0) * base.to(torch.float32)
    a = amp * torch.sin(alpha)                        # pairs with cos_t
    b = amp * torch.cos(alpha)                        # pairs with sin_t
    lead = freq.shape[:-1]
    idx = freq.reshape(-1, freq.shape[-1]).long()
    coef = torch.zeros((2, idx.shape[0], 1024), dtype=amp.dtype, device=dev)
    coef[0].scatter_add_(1, idx, a.reshape(idx.shape))
    coef[1].scatter_add_(1, idx, b.reshape(idx.shape))
    out = (torch.matmul(coef[0], _const(("cos", length), dev))
           + torch.matmul(coef[1], _const(("sin", length), dev)))
    return out.reshape(lead + (length,))


def _amp_of(planes):
    return torch.where(planes["valid"], _amp_ladder(planes["amp_sf"]), 0.0)


def _synth_own(freq, ph, sf, valid, length=128):
    amp = torch.where(valid, _amp_ladder(sf), 0.0)
    return _wave_sum(freq, ph, amp, 0, length)


@lru_cache(maxsize=None)
def _dft_mats():
    """[128, 1024] cos/sin DFT matrices for the zero-padded 2048-point
    spectrum on the 10-bit FreqIndex grid (bins 0..1023)."""
    n = np.arange(128)[:, None]
    k = np.arange(1024)[None, :]
    ang = 2.0 * np.pi * n * k / 2048.0
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def _lane_spectrum(x):
    """x [L, 128] -> (re, im) [L, 1024]: X[k] = sum_n x[n] e^{-2pi i nk/2048}
    for k = 0..1023 (plain f32 matmuls)."""
    re = torch.matmul(x, _const("dft_c", x.device))
    im = -torch.matmul(x, _const("dft_s", x.device))
    return re, im


def _greedy(x, fit_mask, max_keep, sb_ath):
    """Greedy per-lane sinusoid extraction, MAX_WAVES rounds.

    x: [L, 128] lane signals; fit_mask: [L, 128] bool fit window;
    max_keep: [L] int32 cap on accepted waves; sb_ath: [L] power gates.
    Returns freq, sf, ph [L, MAX_WAVES] int32 and valid [L, MAX_WAVES]."""
    lanes = x.shape[0]
    dev = x.device
    x = torch.where(fit_mask, x, 0.0)
    n_fit = torch.clamp(fit_mask.sum(-1), min=1).to(torch.float32)
    bins_mask = torch.arange(1024, device=dev) >= 1   # DC out; 1024 not computed
    i128 = torch.arange(128, device=dev, dtype=torch.int32)
    freq = torch.zeros((lanes, MAX_WAVES), dtype=torch.int32, device=dev)
    sf = torch.zeros_like(freq)
    ph = torch.zeros_like(freq)
    valid = torch.zeros((lanes, MAX_WAVES), dtype=torch.bool, device=dev)
    done = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    max_amp = torch.zeros((lanes,), dtype=torch.float32, device=dev)

    for k in range(MAX_WAVES):
        trace.count("gha_round")
        re, im = _lane_spectrum(x)                   # [L, 1024]
        mag2 = torch.where(bins_mask, re * re + im * im, 0.0)
        b = torch.argmax(mag2, dim=-1).to(torch.int32)
        bl = b.long()[:, None]
        re_b = re.gather(1, bl)[:, 0]
        im_b = im.gather(1, bl)[:, 0]
        amp = 2.0 * torch.sqrt(re_b * re_b + im_b * im_b) / n_fit
        # x ~ A sin(w i + phi): phi = angle(X) + pi/2
        phi = torch.atan2(im_b, re_b) + np.pi / 2.0
        phi_steps = torch.remainder(phi * (2048.0 / (2.0 * np.pi)), 2048.0)

        sf_k, amp_q, ph_k = _quantize_wave(amp, phi_steps,
                                           b.to(torch.float32))
        pos = ((ph_k[:, None] << 6) + i128 * b[:, None]) & 2047
        tone = torch.where(fit_mask, amp_q[:, None] * torch.sin(
            2.0 * np.pi * pos.to(torch.float32) / 2048.0), 0.0)

        e_old = torch.sum(x * x, dim=-1)
        resid = x - tone
        e_new = torch.sum(resid * resid, dim=-1)

        # distance to already-accepted tones (DoRound's 20-bin guard)
        dist = torch.where(valid, torch.abs(freq - b[:, None]), 1 << 20)
        far_enough = torch.amin(dist, dim=-1) >= MIN_FREQ_DIST
        gates = ((e_new < e_old * _ACCEPT_RATIO)
                 & (amp * amp > sb_ath)              # PsyPreCheck: ATH
                 & (amp > max_amp / 10.0)            # PsyPreCheck: -23 dB
                 & far_enough
                 & (k < max_keep))
        accept = ~done & gates
        done = done | ~gates                         # any failure stops lane

        x = torch.where(accept[:, None], resid, x)
        freq[:, k] = torch.where(accept, b, 0)
        sf[:, k] = torch.where(accept, sf_k, 0)
        ph[:, k] = torch.where(accept, ph_k, 0)
        valid[:, k] = accept
        max_amp = torch.where(accept, torch.maximum(max_amp, amp), max_amp)
    return freq, sf, ph, valid


def greedy(x, fit_len, max_keep, sb_ath, active=None):
    """``_greedy`` over the fit window ``arange(128) < fit_len``, on the
    lanes ``active`` (None: every lane); an inactive lane comes back as
    zeros and not valid, as if every round had rejected.

    x [L, 128] f32; fit_len, max_keep [L] int32; sb_ath [L] f32; active [L]
    bool or None.  A CPU tensor takes the plain ``_greedy`` on every lane
    and masks afterwards; a CUDA tensor launches kernel H
    (``csrc/gha_greedy.cu``: the seed kernel, then one launch a round over
    the lanes still searching), or raises."""
    with trace.span("gha_greedy"):
        trace.count("gha.lane_rounds_offered", x.shape[0] * MAX_WAVES)
        if x.device.type == "cpu":
            fit = torch.arange(128, device=x.device) < fit_len[:, None]
            out = _greedy(x, fit, max_keep, sb_ath)
            if active is None:
                return out
            return tuple(torch.where(active[:, None], o, torch.zeros_like(o))
                         for o in out)
        return _greedy_cuda(x, fit_len, max_keep, sb_ath, active)


def _greedy_cuda(x, fit_len, max_keep, sb_ath, active):
    """Kernel H's launch: the planes come back zeroed by its seed kernel
    but where a round accepted; ``max_amp``, ``x_work`` (a lane's residual
    after its last accepted round), the two lane lists and the rounds'
    counts are its scratch."""
    lanes = x.shape[0]
    dev = x.device
    f32, i32 = torch.float32, torch.int32
    if x.dtype != f32 or x.dim() != 2 or x.shape[1] != 128 \
            or fit_len.dtype != i32 or max_keep.dtype != i32 \
            or sb_ath.dtype != f32 \
            or any(t.shape != (lanes,) for t in (fit_len, max_keep, sb_ath)) \
            or (active is not None and (active.dtype != torch.bool
                                        or active.shape != (lanes,))):
        raise ValueError("gha greedy: need x [L, 128] f32, fit_len and "
                         "max_keep [L] int32, sb_ath [L] f32 and active [L] "
                         "bool or None")
    lib = kernels.library()
    planes = torch.empty((3, lanes, MAX_WAVES), dtype=i32, device=dev)
    valid = torch.empty((lanes, MAX_WAVES), dtype=torch.bool, device=dev)
    max_amp = torch.empty(lanes, dtype=f32, device=dev)
    x_work = torch.empty_like(x)
    lists = torch.empty((2, lanes), dtype=i32, device=dev)
    counts = torch.zeros(MAX_WAVES + 1, dtype=i32, device=dev)
    tables = [_const(n, dev) for n in ("dft_c", "dft_s", "tone_sin", "ladder")]
    ins = [x, fit_len, max_keep, sb_ath] + ([] if active is None else [active])
    kernels.require_cuda("gha greedy", *ins, *tables, planes, valid, max_amp,
                         x_work, lists, counts)
    lane_rounds = trace.device_counter("gha.lane_rounds", dev)
    kernels.check(lib.gha_greedy(
        x.data_ptr(), fit_len.data_ptr(), max_keep.data_ptr(),
        sb_ath.data_ptr(), None if active is None else active.data_ptr(),
        *(t.data_ptr() for t in tables), planes[0].data_ptr(),
        planes[1].data_ptr(), planes[2].data_ptr(), valid.data_ptr(),
        max_amp.data_ptr(), x_work.data_ptr(), lists.data_ptr(),
        counts.data_ptr(), None if lane_rounds is None
        else lane_rounds.data_ptr(), lanes, kernels.stream_ptr(x)),
        "gha greedy")
    trace.count("gha_round", MAX_WAVES)
    trace.count("launch.gha_greedy", MAX_WAVES)
    return planes[0], planes[1], planes[2], valid


def _detect_run(x, resid):
    """Longest run of 4-sample blocks where rms_in >= rms_out
    (CheckResuidalAndApply, at3p_gha.cpp:510-538).  [L,128] -> start, end in
    samples (end exclusive); empty run -> (0, 0).

    The JAX package scans the 32 blocks; here the run ending at block i has
    length i - (the last failing block before it), and the first longest
    run wins, as the scan's strict ``>`` keeps it."""
    ei = torch.sqrt(torch.mean(x.reshape(-1, 32, 4) ** 2, dim=-1))
    eo = torch.sqrt(torch.mean(resid.reshape(-1, 32, 4) ** 2, dim=-1))
    ok = ei >= eo                                    # [L, 32]
    idx = torch.arange(32, dtype=torch.int32, device=x.device)
    last_fail = torch.cummax(torch.where(ok, -1, idx), dim=-1).values
    cur_len = torch.where(ok, idx - last_fail, 0)
    blen = torch.amax(cur_len, dim=-1)
    best_end = torch.argmax(cur_len, dim=-1).to(torch.int32)   # first max
    bstart = torch.where(blen > 0, best_end - blen + 1, 0)
    return bstart * 4, (bstart + blen) * 4


def _lead(bands):
    """Bands with a stream axis in front: ([S, C, F, 16, 128], had_one)."""
    return (bands, True) if bands.dim() == 5 else (bands[None], False)


def _unlead(planes, had):
    return planes if had else {k: v[0] for k, v in planes.items()}


def _ath_lanes(lanes, dev):
    return _const("ath", dev).repeat(lanes // NUM_TONE_SUBBANDS)


def extract(bands):
    """Full GHA analysis, subband strategy (TSubbandGhaProcessor): greedy
    per-subband tones + envelopes + stereo merge.

    bands: [C, F, 16, 128] (or [S, C, F, 16, 128]) PQF band samples.
    Returns wire-effective planes (see module docstring)."""
    bands, had = _lead(bands)
    x = bands[..., :NUM_TONE_SUBBANDS, :].reshape(-1, 128)    # [L, 128]
    lanes = x.shape[0]
    sb_ath = _ath_lanes(lanes, x.device)

    full = torch.full((lanes,), 128, dtype=torch.int32, device=x.device)
    cap = torch.full((lanes,), MAX_WAVES, dtype=torch.int32, device=x.device)
    freq, sf, ph, valid = greedy(x, full, cap, sb_ath)

    def refit(e1, truncate, n1):
        return greedy(x, torch.where(truncate, e1, full),
                      torch.where(truncate, n1, cap), sb_ath, active=truncate)

    return _unlead(_finish(bands, x, freq, sf, ph, valid, refit), had)


def _finish(bands, x, freq, sf, ph, valid, refit=None):
    """Shared analysis tail: 48-tone budget, envelope detection (with an
    optional truncated-window refit), next-frame continuation, wire envelope
    encoding, stereo merge.  bands [S, C, F, 16, 128]; lanes in its order."""
    s, c, f = bands.shape[:3]
    dev = x.device
    nw = NUM_TONE_SUBBANDS * MAX_WAVES

    # global tone budget per frame (ApplyFilter's 48-tone wire limit):
    # keep the strongest waves across channels/subbands
    amp_all = torch.where(valid, _amp_ladder(sf), 0.0)
    amp_fr = amp_all.reshape(s, c, f, nw).transpose(1, 2).reshape(s, f, c * nw)
    order = torch.argsort(-amp_fr, dim=-1, stable=True)
    ranks = torch.zeros_like(order).scatter_(
        -1, order, torch.arange(c * nw, device=dev).expand_as(order))
    keep = (ranks < MAX_TOTAL_TONES).reshape(s, f, c, nw).transpose(1, 2)
    valid = valid & keep.reshape(-1, MAX_WAVES)

    # envelope pass 1: run-detect on the fit residual
    resid1 = x - _synth_own(freq, ph, sf, valid)
    s1, e1 = _detect_run(x, resid1)
    has = valid.any(-1)
    reject1 = has & (e1 - s1 < 16)                   # len < 4 blocks: Error
    truncate = has & ~reject1 & (e1 < 128)

    if refit is not None:
        # envelope pass 2: refit on the truncated window (FrameSz=end
        # Repeat, CheckResuidalAndApply at3p_gha.cpp:548-552), kept only
        # where ``truncate``
        n1 = valid.sum(-1).to(torch.int32)
        freq2, sf2, ph2, valid2 = refit(e1, truncate, n1)
        t = truncate[:, None]
        freq = torch.where(t, freq2, freq)
        sf = torch.where(t, sf2, sf)
        ph = torch.where(t, ph2, ph)
        valid = torch.where(t, valid2, valid)
        resid2 = x - _synth_own(freq, ph, sf, valid)
        s2, e2 = _detect_run(x, resid2)
        has2 = valid.any(-1)
        reject = (has2 & truncate & (e2 - s2 < 16)) | (reject1 & ~truncate)
        start = torch.where(truncate, s2, s1)
        end = torch.where(truncate, e2, 128)
    else:
        reject = reject1
        start, end = s1, torch.where(truncate, e1, 128)
    valid = valid & ~reject[:, None]
    has = valid.any(-1)

    # continuation into the next frame (CheckNextFrame): tone set extended
    # over the next frame's first 64 samples must reduce its energy
    amp_q = torch.where(valid, _amp_ladder(sf), 0.0)
    ext = _wave_sum(freq, ph, amp_q, 128, length=64)  # continues past frame
    tone_bands = bands[..., :NUM_TONE_SUBBANDS, :]
    x_next = F.pad(tone_bands[:, :, 1:], (0, 0, 0, 0, 0, 1)).reshape(-1, 128)
    nxt = x_next[:, :64]
    e_before = torch.sum(nxt * nxt, dim=-1)
    diff = nxt - ext
    e_after = torch.sum(diff * diff, dim=-1)
    cont = e_after < e_before

    # wire envelope (AdjustEnvelope, at3p_gha.cpp:1499-1521): stop point
    # absent for gapless full-length tones, else (end-1)/4; start point
    # absent only when the run starts at 0 AND the previous frame's wire
    # envelope had no stop point
    sh = (s, c, f, NUM_TONE_SUBBANDS)
    gapless = has & (end == 128) & cont
    env_stop = torch.where(has & ~gapless, end // 4 - 1, -1).reshape(sh)
    prev_stop = F.pad((env_stop >= 0)[:, :, :-1], (0, 0, 1, 0))
    start_sh = start.reshape(sh)
    start_present = has.reshape(sh) & ((start_sh > 0) | prev_stop)
    env_start = torch.where(start_present, start_sh // 4, -1)

    out_shape = sh + (MAX_WAVES,)
    planes = {"freq": freq.reshape(out_shape),
              "amp_sf": sf.reshape(out_shape),
              "phase": ph.reshape(out_shape),
              "valid": valid.reshape(out_shape),
              "env_start": env_start.to(torch.int32),
              "env_stop": env_stop.to(torch.int32)}
    return _merge_stereo(planes)


WB_ROUNDS = 12              # matching-pursuit extraction rounds per frame
WB_PROJECT_GATE = 0.02      # -34 dB relative to the home subband's response
WB_DECAY_STOP = 1.0 / 32.0  # stop once tones decay ~30 dB below the peak


def _pqf_response(omega):
    """Complex response of the analysis PQF per subband at raw-domain
    frequency ``omega`` [L] (rad/sample): H[sb](w) = sum_p K[sb,p] e^{iwp},
    in closed form from the [16, 384] analysis kernel.  Returns [L, 16]
    complex64."""
    p = torch.arange(384, device=omega.device)
    e = torch.exp(1j * omega[:, None].to(torch.complex64) * p)
    return torch.matmul(e, _const("pqf", omega.device))


def _wb_band_params(omega, amp, phi, h):
    """Project a raw-domain tone (omega, amp, phase-at-frame-start) through
    one subband's complex response h.  Returns (freq_index, band_amp,
    band_phase_steps) on the wire grid; the band signal is
    amp*|h| * sin(16w n + phi - 368w + arg h), reflected into [0, pi) when
    16w aliases."""
    band_amp = amp * torch.abs(h)
    psi = phi - 368.0 * omega + torch.angle(h)
    big_omega = torch.remainder(16.0 * omega, 2.0 * np.pi)
    refl = big_omega > np.pi
    omega_f = torch.where(refl, 2.0 * np.pi - big_omega, big_omega)
    psi = torch.where(refl, np.pi - psi, psi)
    f_idx = torch.clamp(torch.round(omega_f * (2048.0 / (2.0 * np.pi))),
                        0, 1023).to(torch.int32)
    phi_steps = torch.remainder(psi * (2048.0 / (2.0 * np.pi)), 2048.0)
    return f_idx, band_amp, phi_steps


def extract_wideband(bands, raw, refine_raw=False):
    """Wideband GHA strategy (TWidebandGhaProcessor, at3p_gha.cpp:975-1497):
    matching pursuit on the raw 2048-sample frames, analytic projection of
    each tone into its home subband +-1 through the PQF response, then the
    shared envelope/merge tail.

    raw: [C, F, 2048] (or [S, C, F, 2048]) raw PCM frames, the PQF input's
    scale; refine_raw: True keeps the projected amplitude/phase (--advanced
    ghawbrefine=1 "raw"); False re-estimates them from the subband signal
    (ghawbrefine=0 "subband", the default)."""
    bands, had = _lead(bands)
    raw = raw if had else raw[None]
    dev = bands.device
    lanes = bands.shape[0] * bands.shape[1] * bands.shape[2]
    # raw stays in input scale: the PQF kernel's own gain is part of the
    # projected response H, so band_amp = amp_raw * |H| lands in the band
    # domain directly
    x = raw.reshape(lanes, 2048)
    tgrid = torch.arange(2048, device=dev)
    nbin = torch.arange(2049, device=dev)
    bin_mask = (nbin >= 2) & (nbin <= 2046)
    ath8 = _const("ath", dev)

    ncand = WB_ROUNDS * 3
    cand_sb = torch.full((lanes, ncand), -1, dtype=torch.int32, device=dev)
    cand_freq = torch.zeros((lanes, ncand), dtype=torch.int32, device=dev)
    cand_amp = torch.zeros((lanes, ncand), dtype=torch.float32, device=dev)
    cand_phs = torch.zeros((lanes, ncand), dtype=torch.float32, device=dev)
    max_amp = torch.zeros((lanes,), dtype=torch.float32, device=dev)

    def take(a, i):
        """a[l, i[l]]; a negative index counts from the end, as JAX's
        take_along_axis does (bin b - 1 of a silent frame, where b = 0)."""
        return a.gather(1, torch.remainder(i.long(), a.shape[1])[:, None])[:, 0]

    for k in range(WB_ROUNDS):
        spec = torch.fft.rfft(x, n=4096)
        mag = torch.where(bin_mask, torch.abs(spec), 0.0)
        b = torch.argmax(mag, dim=-1)
        a0, a1, a2 = (torch.log(take(mag, b + o) + 1e-30) for o in (-1, 0, 1))
        denom = a0 - 2.0 * a1 + a2
        delta = torch.clamp(torch.where(torch.abs(denom) > 1e-9,
                                        0.5 * (a0 - a2) / denom, 0.0),
                            -0.5, 0.5)
        omega = (b.to(torch.float32) + delta) * (2.0 * np.pi / 4096.0)

        # exact complex projection at the refined frequency
        e = torch.exp(-1j * omega[:, None].to(torch.complex64) * tgrid)
        proj = torch.sum(x.to(torch.complex64) * e, dim=-1)
        amp = 2.0 * torch.abs(proj) / 2048.0
        phi = torch.angle(proj) + np.pi / 2.0

        home = torch.clamp((omega * (16.0 / np.pi)).to(torch.int32), 0, 15)
        in_range = omega < (np.pi / 2.0)          # 11025 Hz: subbands 0..7
        alive = in_range & (amp > max_amp * WB_DECAY_STOP)
        max_amp = torch.maximum(max_amp, torch.where(alive, amp, 0.0))

        h_all = _pqf_response(omega)              # [L, 16]
        h_home = take(torch.abs(h_all), home)
        for slot, off in enumerate((-1, 0, 1)):
            sb = home + off
            ok_sb = (sb >= 0) & (sb < NUM_TONE_SUBBANDS)
            h = take(h_all, torch.clamp(sb, 0, 15))
            f_idx, b_amp, ph_steps = _wb_band_params(omega, amp, phi, h)
            gate = (alive & ok_sb
                    & (torch.abs(h) >= WB_PROJECT_GATE * h_home)
                    & (b_amp * b_amp > ath8[torch.clamp(sb, 0, 7).long()]))
            j = k * 3 + slot
            cand_sb[:, j] = torch.where(gate, sb, -1)
            cand_freq[:, j] = f_idx
            cand_amp[:, j] = torch.where(gate, b_amp, 0.0)
            cand_phs[:, j] = ph_steps

        # remove the fitted tone from the pursuit scratch
        tone = amp[:, None] * torch.sin(omega[:, None] * tgrid + phi[:, None])
        x = torch.where(alive[:, None], x - tone, x)

    # bucket candidates into per-subband wave slots (strongest first, with
    # the 20-bin minimum distance guard)
    sb_axis = torch.arange(NUM_TONE_SUBBANDS, device=dev)
    in_sb = cand_sb[:, None, :] == sb_axis[None, :, None]    # [L, 8, NC]
    amp_sb = torch.where(in_sb, cand_amp[:, None, :], 0.0)
    order = torch.argsort(-amp_sb, dim=-1, stable=True)      # [L, 8, NC]
    freq_s = cand_freq[:, None, :].expand(amp_sb.shape).gather(-1, order)
    phs_s = cand_phs[:, None, :].expand(amp_sb.shape).gather(-1, order)
    amp_s = amp_sb.gather(-1, order)
    valid_s = amp_s > 0.0
    # distance guard against every stronger candidate
    d = torch.abs(freq_s[..., :, None] - freq_s[..., None, :])
    ci = torch.arange(ncand, device=dev)
    earlier = ci[None, :] < ci[:, None]
    clash = (d < MIN_FREQ_DIST) & earlier & valid_s[..., None, :]
    valid_s = valid_s & ~clash.any(-1)
    # compact to the first MAX_WAVES surviving slots
    pos = torch.cumsum(valid_s.to(torch.int32), dim=-1) - 1
    sel = torch.where(valid_s, pos, ncand)
    w = torch.arange(MAX_WAVES, device=dev)
    hit = sel[..., None, :] == w[:, None]                     # [L,8,W,NC]

    def pick(a):
        return torch.where(hit, a[..., None, :], 0).sum(-1)

    freq_w = pick(freq_s).to(torch.int32)
    amp_w = pick(amp_s)
    phs_w = pick(phs_s)
    valid_w = hit.any(-1)

    band_x = bands[..., :NUM_TONE_SUBBANDS, :].reshape(-1, 128)
    if not refine_raw:
        # "subband" refine: re-estimate amplitude/phase from the band signal
        # at the quantized frequency (the reference's default Newton refine
        # in the subband domain, at3p_gha.cpp:1206-1288)
        m = torch.arange(128, device=dev)
        lw = freq_w.reshape(lanes * NUM_TONE_SUBBANDS, MAX_WAVES)
        bx = band_x[:, None, :]                               # [L8, 1, 128]
        ang = lw[..., None].to(torch.float32) * m * (2.0 * np.pi / 2048.0)
        proj = torch.sum(bx * torch.exp(-1j * ang.to(torch.complex64)), -1)
        amp_r = 2.0 * torch.abs(proj) / 128.0
        phs_r = torch.remainder((torch.angle(proj) + np.pi / 2.0)
                                * (2048.0 / (2.0 * np.pi)), 2048.0)
        amp_w = amp_r.reshape(amp_w.shape)
        phs_w = phs_r.reshape(phs_w.shape)

    sf_w, _, ph_w = _quantize_wave(amp_w, phs_w, freq_w.to(torch.float32))
    shape = (lanes * NUM_TONE_SUBBANDS, MAX_WAVES)
    freq_w = freq_w.reshape(shape)
    sf_w = sf_w.reshape(shape)
    ph_w = ph_w.reshape(shape)
    valid_w = valid_w.reshape(shape)
    # ATH/psy gate after refine, against the quantized amplitude
    amp_q = _amp_ladder(sf_w)
    ath = ath8.repeat(lanes)[:, None]
    valid_w = valid_w & (amp_q * amp_q > ath)

    return _unlead(_finish(bands, band_x, freq_w, sf_w, ph_w, valid_w,
                           refit=None), had)


def _merge_stereo(planes):
    """Leader/follower + tone sharing (FillResultBuf / FillFolowerRes).

    planes [S, C, F, ...].  Makes them wire-effective: for shared subbands
    the follower channel's slots are replaced by the leader's waves AND
    envelope (ApplyFilter copies tones_info wholesale,
    at3p_gha.cpp:655-658); follower waves in subbands >= the leader's
    NumToneBands are dropped (never written)."""
    s, c, f = planes["valid"].shape[:3]
    dev = planes["valid"].device
    sb_idx = torch.arange(NUM_TONE_SUBBANDS, device=dev)
    any_sb = planes["valid"].any(-1)                       # [S, C, F, 8]
    nb_used = torch.amax(torch.where(any_sb, sb_idx + 1, 0), dim=-1)
    if c == 1:
        planes["sharing"] = torch.zeros((s, f, NUM_TONE_SUBBANDS),
                                        dtype=torch.bool, device=dev)
        planes["leader"] = torch.zeros((s, f), dtype=torch.int32, device=dev)
        return planes

    leader = (nb_used[:, 1] > nb_used[:, 0]).to(torch.int32)   # [S, F]
    is1 = leader == 1
    nb = torch.where(is1, nb_used[:, 1], nb_used[:, 0])         # [S, F]

    # drop waves above the leader's band range
    in_range = sb_idx < nb[..., None]                           # [S, F, 8]
    planes["valid"] = planes["valid"] & in_range[:, None, :, :, None]

    def pick(x, first):
        """x [S, 2, F, ...] -> per-frame channel: leader (first) or follower."""
        sel = (is1 if first else ~is1).reshape((s, f) + (1,) * (x.dim() - 3))
        return torch.where(sel, x[:, 1], x[:, 0])

    keys = _WAVE_KEYS + _ENV_KEYS
    lead = {k: pick(planes[k], True) for k in keys}
    fol = {k: pick(planes[k], False) for k in keys}

    # sharing: every follower wave's freq exists in the leader's set
    fol_freq = torch.where(fol["valid"], fol["freq"], -1)       # [S, F, 8, W]
    match = (fol_freq[..., :, None]
             == torch.where(lead["valid"], lead["freq"], -2)[..., None, :])
    covered = torch.all(match.any(-1) | ~fol["valid"], dim=-1)  # [S, F, 8]
    sharing = covered & fol["valid"].any(-1) & lead["valid"].any(-1)

    # wire-effective follower = leader's data on shared subbands
    new_fol = {k: torch.where(sharing[..., None] if fol[k].dim() == 4
                              else sharing, lead[k], fol[k]) for k in fol}

    # scatter leader/follower back to physical channel slots
    out = {}
    for k in keys:
        l_, fo = lead[k], new_fol[k]
        ld = leader.reshape((s, f) + (1,) * (l_.dim() - 2))
        out[k] = torch.stack([torch.where(ld == ch, l_, fo) for ch in (0, 1)],
                             dim=1)
    out["sharing"] = sharing
    out["leader"] = leader
    return out


# --- decoder-faithful synthesis (ff_atrac3p_generate_tones) -----------------

def _curr_env(planes):
    """Reconstruct the full two-frame envelope for each wave block
    (generate_tones, atrac3plusdsp.c:148-171).  Positions are 4-sample units
    spanning [0,32) = the block's region-2 frame, [32,64) = its region-1
    frame.  Returns has_start, start, has_stop, stop: [..., C, F, 8]."""
    sp = planes["env_start"] >= 0
    sv = torch.where(sp, planes["env_start"], -1)
    tp = planes["env_stop"] >= 0
    tv = torch.where(tp, planes["env_stop"], 32)

    def prev(a, fill):
        return F.pad(a[..., :-1, :], (0, 0, 1, 0), value=fill)

    sp_p, sv_p = prev(sp, False), prev(sv, -1)
    tp_p, tv_p = prev(tp, False), prev(tv, 32)

    r1 = sp & (sv < tv)
    has_start = r1 | sp_p
    start = torch.where(r1, sv + 32, torch.where(sp_p, sv_p, 0))

    r2 = tp_p & (tv_p >= start)
    has_stop = r2 | tp
    stop = torch.where(r2, tv_p, torch.where(tp, tv + 32, 64))
    return has_start, start, has_stop, stop


_HANN = (1.0 - np.cos(2.0 * np.pi * np.arange(256) / 256.0)) * 0.5
_HQ = _HANN[[0, 32, 64, 96]].astype(np.float32)             # rising quarter


def _env_mask(has_start, start, has_stop, stop, reg_offset):
    """waves_synth's fade-in/out multiplicative mask over 128 samples
    (atrac3plusdsp.c:109-135).  All args [...] ints; returns [..., 128]."""
    i = torch.arange(128, device=start.device)

    def hq_at(j):
        return torch.where(j <= 0, float(_HQ[0]),
                           torch.where(j == 1, float(_HQ[1]),
                                       torch.where(j == 2, float(_HQ[2]),
                                                   float(_HQ[3]))))

    pos = (start << 2) - reg_offset
    fade_in = has_start & (pos > 0) & (pos <= 128)
    edge = ~(has_stop & (start == stop))
    j = i - pos[..., None]
    m_in = torch.where(fade_in[..., None],
                       torch.where(j < 0, 0.0,
                                   torch.where(edge[..., None] & (j < 4),
                                               hq_at(j), 1.0)),
                       1.0)

    pos2 = ((stop + 1) << 2) - reg_offset
    fade_out = has_stop & (pos2 > 0) & (pos2 <= 128)
    k = i - (pos2[..., None] - 4)
    m_out = torch.where(fade_out[..., None],
                        torch.where(k < 0, 1.0,
                                    torch.where(k < 4, hq_at(3 - k), 0.0)),
                        1.0)
    return m_in * m_out


def synthesize(planes):
    """The decoder's tone signal in content-frame alignment: content frame c
    receives the enveloped falling half of its own waves (region 1) plus the
    enveloped rising half of frame c+1's (region 2), with generate_tones'
    crossfade-suppression rules.  Planes [..., C, F, ...] -> [..., C, F, 8,
    128]."""
    dev = planes["valid"].device
    hann = (1.0 - torch.cos(2.0 * np.pi * torch.arange(256, device=dev)
                            / 256.0)) * 0.5
    rise, fall = hann[:128], hann[128:]

    amp = _amp_of(planes)
    reg1_raw = _wave_sum(planes["freq"], planes["phase"], amp, 0)
    reg2_raw = _wave_sum(planes["freq"], planes["phase"], amp, -128)

    has_start, start, has_stop, stop = _curr_env(planes)
    reg1 = reg1_raw * _env_mask(has_start, start, has_stop, stop, 128)
    reg2 = reg2_raw * _env_mask(has_start, start, has_stop, stop, 0)

    nw = planes["valid"].any(-1)
    reg1_nz = nw & ~(stop < 32)                      # visible in own frame
    reg2_nz = nw & ~(start >= 32)                    # visible in prev frame

    def nxt(a, fd=-2, fill=False):
        """The next frame's value along dim ``fd`` (the F axis), ``fill``
        past the last frame."""
        pad = [0, 0] * (-fd - 1) + [0, 1]
        return F.pad(a.narrow(fd, 1, a.shape[fd] - 1), pad, value=fill)

    # crossfade rules (atrac3plusdsp.c:190-200) at content frame c:
    # region 1 = block c, region 2 = block c+1
    both = reg1_nz & nxt(reg2_nz)
    r1_hann = both | (nw & ~has_stop)
    r2_hann_own = nw & ~has_start                    # for block c+1's reg2
    r1 = torch.where(reg1_nz[..., None],
                     torch.where(r1_hann[..., None], reg1 * fall, reg1), 0.0)
    r2_all = torch.where(reg2_nz[..., None], reg2, 0.0)
    r2_next = nxt(r2_all, -3, 0.0)
    r2_scaled = torch.where((both | nxt(r2_hann_own))[..., None],
                            r2_next * rise, r2_next)
    return r1 + r2_scaled


def subtract(bands, planes):
    """Residual = bands minus the decoder's tone synthesis.

    bands [..., C, F, 16, 128]; planes from extract() (wire-effective)."""
    synth = synthesize(planes)
    res_tone_bands = bands[..., :NUM_TONE_SUBBANDS, :] - synth
    return torch.cat([res_tone_bands, bands[..., NUM_TONE_SUBBANDS:, :]],
                     dim=-2)
