"""Bit-exact ATRAC3 gain control (reference float32 semantics).

Replicates the reference's gain-analysis chain operation for operation:

  * kiss_fftr / kiss_fftri real FFT wrappers
    (lib/fft/kissfft_impl/tools/kiss_fftr.c)
  * TSpectralUpsampler: Planck window, 8x spectral upsampling, HPF,
    high-frequency ratio (src/transient_spectral_upsampler.cpp)
  * AnalyzeGain with within-subframe quantiles
    (src/transient_detector.cpp:64-120)
  * FindPlateau / BoundaryTransientScore / CalcCurve with sticky
    quantization and transition pruning (src/transient_detector.cpp:136-482)
  * CreateSubbandInfo: HFR gates, dynamic min-score, point0 insertion and
    guards (src/atrac3denc.cpp:299-578)
  * gain modulators, sample divisors and energy scales
    (src/gain_processor.h:87-122, src/atrac3denc.cpp:138-298)

State per (channel, band): CurveCtx {LastLevel, LastTarget, LastHpfEnergy}
and PrevOverlapGainScale.
"""
import ctypes

import numpy as np

from portbench.reference.upstream.atrac1.exact_synth import _KissFFT, _libm, f32

_libm.expf.restype = ctypes.c_float
_libm.expf.argtypes = [ctypes.c_float]
_libm.log2f.restype = ctypes.c_float
_libm.log2f.argtypes = [ctypes.c_float]
_libm.cosf.restype = ctypes.c_float
_libm.cosf.argtypes = [ctypes.c_float]
_libm.cos.restype = ctypes.c_double
_libm.cos.argtypes = [ctypes.c_double]
_libm.sin.restype = ctypes.c_double
_libm.sin.argtypes = [ctypes.c_double]

# GainLevel[i] = pow(2, 4 - i); GainInterpolation[i] = pow(2, -(i-15)/8)
# (atrac3.h:192-197, double pow -> float)
GAIN_LEVEL = np.asarray([2.0 ** (4 - i) for i in range(16)], np.float64
                        ).astype(f32)
GAIN_INTERP = np.asarray([2.0 ** (-1.0 / 8 * (i - 15)) for i in range(31)],
                         np.float64).astype(f32)
_EXP_OFFSET = 4
_LOC_SCALE = 3
_LOC_SZ = 8
_INTERP_SHIFT = 15


class _KissFFTR:
    """kiss_fftr / kiss_fftri (kiss_fftr.c), batched over leading dims."""

    def __init__(self, nfft, inverse):
        self.n = nfft
        self.ncfft = nfft // 2
        self.inverse = inverse
        self.sub = _KissFFT(self.ncfft, inverse=inverse)
        i = np.arange(self.ncfft // 2, dtype=np.float64)
        phase = -np.pi * ((i + 1) / self.ncfft + 0.5)
        if inverse:
            phase = -phase
        from portbench.reference.upstream.atrac1.exact_synth import (_libm_cos,
                                                             _libm_sin)
        self.str_ = _libm_cos(phase).astype(f32)
        self.sti = _libm_sin(phase).astype(f32)

    def forward(self, x):
        """x [..., n] real -> (re, im) each [..., ncfft+1]."""
        assert not self.inverse
        nc = self.ncfft
        xr = x[..., 0::2]
        xi = x[..., 1::2]
        tr, ti = self.sub(xr, xi)
        out_r = np.empty(x.shape[:-1] + (nc + 1,), f32)
        out_i = np.zeros(x.shape[:-1] + (nc + 1,), f32)
        out_r[..., 0] = tr[..., 0] + ti[..., 0]
        out_r[..., nc] = tr[..., 0] - ti[..., 0]
        k = np.arange(1, nc // 2 + 1)
        fpk_r, fpk_i = tr[..., k], ti[..., k]
        fpnk_r, fpnk_i = tr[..., nc - k], -ti[..., nc - k]
        f1r = fpk_r + fpnk_r
        f1i = fpk_i + fpnk_i
        f2r = fpk_r - fpnk_r
        f2i = fpk_i - fpnk_i
        twr = f2r * self.str_[k - 1] - f2i * self.sti[k - 1]
        twi = f2r * self.sti[k - 1] + f2i * self.str_[k - 1]
        out_r[..., k] = (f1r + twr) * f32(0.5)
        out_i[..., k] = (f1i + twi) * f32(0.5)
        out_r[..., nc - k] = (f1r - twr) * f32(0.5)
        out_i[..., nc - k] = (twi - f1i) * f32(0.5)
        return out_r, out_i

    def inverse_(self, fr, fi):
        """(re, im) [..., ncfft+1] -> x [..., n] real (unnormalized:
        kiss_fftri returns n/2 * IFFT as kiss does)."""
        assert self.inverse
        nc = self.ncfft
        tr = np.empty(fr.shape[:-1] + (nc,), f32)
        ti = np.empty(fr.shape[:-1] + (nc,), f32)
        tr[..., 0] = fr[..., 0] + fr[..., nc]
        ti[..., 0] = fr[..., 0] - fr[..., nc]
        k = np.arange(1, nc // 2 + 1)
        fk_r, fk_i = fr[..., k], fi[..., k]
        fnkc_r, fnkc_i = fr[..., nc - k], -fi[..., nc - k]
        fek_r = fk_r + fnkc_r
        fek_i = fk_i + fnkc_i
        tmp_r = fk_r - fnkc_r
        tmp_i = fk_i - fnkc_i
        fok_r = tmp_r * self.str_[k - 1] - tmp_i * self.sti[k - 1]
        fok_i = tmp_r * self.sti[k - 1] + tmp_i * self.str_[k - 1]
        tr[..., k] = fek_r + fok_r
        ti[..., k] = fek_i + fok_i
        tr[..., nc - k] = fek_r - fok_r
        ti[..., nc - k] = -(fek_i - fok_i)
        yr, yi = self.sub(tr, ti)
        out = np.empty(fr.shape[:-1] + (self.n,), f32)
        out[..., 0::2] = yr
        out[..., 1::2] = yi
        return out


_FWD512 = _KissFFTR(512, inverse=False)
_INV4096 = _KissFFTR(4096, inverse=True)

_IN_N = 512
_UP = 8
_OUT_N = 4096
_HFR_THRESHOLD = f32(0.05)
# LowCutBin = ceil(800 * 512 / 11025) (upsampler ctor args 11025, 800)
_LOW_CUT_BIN = int(np.ceil(800.0 * _IN_N / 11025.0))


def _planck_window():
    """Planck-taper (transient_spectral_upsampler.cpp:39-67), float math
    with std::exp(float) -> expf."""
    eps = 0.15                 # kDefaultEps (transient_spectral_upsampler.h)
    eN = f32(f32(eps) * f32(float(_IN_N)))
    fN = f32(float(_IN_N))
    win = np.empty(_IN_N, f32)
    for n in range(_IN_N):
        fn = f32(float(n))
        if n == 0:
            win[n] = 0.0
        elif fn < eN:
            zp = f32(eN * f32(f32(f32(1.0) / fn)
                              + f32(f32(1.0) / f32(fn - eN))))
            win[n] = f32(f32(1.0) / f32(f32(1.0) + _libm.expf(float(zp))))
        elif fn <= f32(fN - eN):
            win[n] = 1.0
        else:
            m = f32(fN - fn)
            zp = f32(eN * f32(f32(f32(1.0) / m)
                              + f32(f32(1.0) / f32(m - eN))))
            win[n] = f32(f32(1.0) / f32(f32(1.0) + _libm.expf(float(zp))))
    return win


_PLANCK = _planck_window()


def upsampler_process(x512):
    """TSpectralUpsampler::Process -> (signal [4096] f32, hfr f32)."""
    windowed = (x512 * _PLANCK).astype(f32)
    fr, fi = _FWD512.forward(windowed)
    # high-frequency ratio (double accumulation)
    total_e = 0.0
    filt_e = 0.0
    for k in range(_IN_N // 2 + 1):
        e = float(fr[k]) * float(fr[k]) + float(fi[k]) * float(fi[k])
        total_e += e
        if k >= _LOW_CUT_BIN + 2:
            h = 1.0
        elif k >= _LOW_CUT_BIN:
            i = k - _LOW_CUT_BIN + 1
            h = float(f32(0.5) * f32(f32(1.0)
                                     - _libm.cosf(float(np.pi) * i / 2.0)))
        else:
            h = 0.0
        filt_e += e * h * h
    hfr = f32(filt_e / total_e) if total_e > 0.0 else f32(0.0)

    inv_r = np.zeros(_OUT_N // 2 + 1, f32)
    inv_i = np.zeros(_OUT_N // 2 + 1, f32)
    scale = f32(float(_UP))
    pb_start = _LOW_CUT_BIN + 2
    k = np.arange(pb_start, _IN_N // 2)
    inv_r[k] = fr[k] * scale
    inv_i[k] = fi[k] * scale
    for i in range(1, 3):
        kk = _LOW_CUT_BIN - 1 + i
        if kk >= _IN_N // 2:
            continue
        w = f32(0.5) * f32(f32(1.0) - _libm.cosf(float(np.pi) * i / 2.0))
        inv_r[kk] = f32(f32(fr[kk] * scale) * w)
        inv_i[kk] = f32(f32(fi[kk] * scale) * w)
    if _LOW_CUT_BIN + 2 <= _IN_N // 2:
        inv_r[_IN_N // 2] = f32(f32(fr[_IN_N // 2] * scale) * f32(0.5))
    out = _INV4096.inverse_(inv_r, inv_i)
    norm = f32(np.float64(1.0) / np.float64(f32(float(_OUT_N))))
    return (out * norm).astype(f32), hfr


def _rms(x):
    s = f32(0.0)
    for v in x:
        s = f32(s + f32(v * v))
    s = f32(s / f32(len(x)))
    return f32(np.sqrt(s))


def analyze_gain(sig, max_points, want_quantiles):
    """AnalyzeGain(useRms=true) (transient_detector.cpp:64-120)."""
    ln = len(sig)
    step = ln // max_points
    res = np.empty(max_points, f32)
    low = np.empty(max_points, f32) if want_quantiles else None
    high = np.empty(max_points, f32) if want_quantiles else None
    idx = 0
    for pos in range(0, ln, step):
        res[idx] = _rms(sig[pos: pos + step])
        if want_quantiles:
            chunk = max(1, step // 8)
            micro = [_rms(sig[pos + off: pos + min(off + chunk, step)])
                     for off in range(0, step, chunk)]
            micro.sort()
            low[idx] = micro[len(micro) // 4]
            high[idx] = micro[(len(micro) * 3) // 4]
        idx += 1
    return res, low, high


def _first_set_bit(x):
    return x.bit_length() - 1 if x else 0


def relation_to_idx(x):
    """RelationToIdx (transient_detector.cpp:122-131)."""
    x = f32(x)
    if x <= f32(0.5):
        x = f32(f32(1.0) / max(x, f32(0.00048828125)))
        return 4 + _first_set_bit(int(x))
    x = min(x, f32(16.0))
    return 4 - _first_set_bit(int(x))


def _median3(arr):
    n = len(arr)
    out = np.empty(n, f32)
    for i in range(n):
        lo = max(0, i - 1)
        hi = min(n - 1, i + 1)
        w = sorted(arr[lo: hi + 1])
        out[i] = w[len(w) // 2]
    return out


def _find_plateau(vals, min_contig=3):
    n = len(vals)
    max_raw = f32(0.0)
    for v in vals:
        max_raw = max(max_raw, v)
    if n < min_contig:
        return f32(0.0), max_raw, False
    filt = _median3(vals)
    best_level = f32(0.0)
    best_end = -1
    for j in range(n - min_contig + 1):
        mv = filt[j]
        for k in range(1, min_contig):
            mv = min(mv, filt[j + k])
        if mv > best_level:
            best_level = mv
            best_end = j + min_contig - 1
    if best_level < 1e-6:
        return f32(0.0), max_raw, False
    while best_end + 1 < n and filt[best_end + 1] >= best_level:
        best_end += 1
    release = False
    if best_end < n - 1:
        if vals[n - 1] < f32(best_level * f32(0.1)):
            release = True
        else:
            any_high = any(vals[i] >= f32(best_level * f32(0.7))
                           for i in range(best_end + 1, n))
            release = (not any_high
                       and vals[n - 1] < f32(best_level * f32(0.5)))
    return best_level, max_raw, release


def _boundary_score(env, loc, win=3):
    n = len(env)
    left = env[max(0, loc - win): loc]
    right = env[loc: min(n, loc + win)]
    lm = f32(0.0)
    for v in left:
        lm = max(lm, v)
    rm = f32(0.0)
    for v in right:
        rm = max(rm, v)
    eps = f32(1e-9)
    attack = f32(f32(rm + eps) / f32(lm + eps))
    release = f32(f32(lm + eps) / f32(rm + eps))
    return max(attack, release)


class CurveCtx:
    def __init__(self):
        self.last_level = f32(0.0)
        self.last_target = f32(0.0)
        self.last_hpf_energy = f32(0.0)


def calc_curve(vals, ctx, min_score, low, high):
    """CalcCurve (transient_detector.cpp:276-482).  vals/low/high: [32]
    f32; mutates ctx; returns [(level, loc)]."""
    curve = []
    if not len(vals):
        return curve
    plateau_level, max_raw, release = _find_plateau(vals)
    use_plateau = (plateau_level > 1e-6 and not release
                   and plateau_level >= f32(max_raw * f32(0.4)))
    target = plateau_level if use_plateau else vals[-1]

    saved_last_level = ctx.last_level
    saved_last_target = ctx.last_target
    ctx.last_level = vals[-1]
    ctx.last_target = target

    if target < 1e-6:
        return curve
    if saved_last_level < 1e-6:
        return curve

    n = len(vals)
    filt = _median3(vals)
    max_gain = f32(0.0)
    for v in vals:
        max_gain = max(max_gain, v)

    intra = f32(max_gain / max(target, f32(1e-9)))
    inter = f32(1.0)
    if saved_last_target > 1e-6:
        hi = max(saved_last_target, target)
        lo = min(saved_last_target, target)
        inter = f32(hi / max(lo, f32(1e-9)))
    sticky = (low is not None and high is not None
              and len(low) == n and len(high) == n
              and intra <= f32(7.0) and inter <= f32(10.0))

    sf_level = np.zeros(n, np.int64)
    for i in range(n):
        ratio = f32(filt[i] / target)
        level = relation_to_idx(ratio)
        if i > 0 and sticky:
            rlo = f32(low[i] / target)
            rhi = f32(high[i] / target)
            if rlo > rhi:
                rlo, rhi = rhi, rlo
            ilo = relation_to_idx(rlo)
            ihi = relation_to_idx(rhi)
            mn, mx = min(ilo, ihi), max(ilo, ihi)
            prev = sf_level[i - 1]
            if (mx - mn <= 1 and abs(level - prev) == 1
                    and mn <= prev <= mx):
                level = prev
        sf_level[i] = level

    target_sf = 0
    for sf in range(n - 2, -1, -1):
        if sf_level[sf] != 4:
            target_sf = sf + 1
            break
    if target_sf == 0:
        return curve

    bscore = np.ones(n + 1, f32)
    for loc in range(1, target_sf + 1):
        bscore[loc] = _boundary_score(filt, loc)

    trans = []
    prev = 4
    for sf in range(target_sf - 1, -1, -1):
        lev = int(sf_level[sf])
        if lev != prev:
            loc = sf + 1
            delta = abs(lev - prev)
            keep = (loc == target_sf) or (delta >= 2) \
                or (bscore[loc] >= min_score)
            if keep:
                trans.append((loc, lev, delta))
                prev = lev
    trans.reverse()
    if not trans:
        return curve

    if len(trans) > 6:
        # stable_sort by (delta desc, loc desc), trim, re-sort by loc
        order = sorted(range(len(trans)),
                       key=lambda i: (-trans[i][2], -trans[i][0]))
        trans = sorted([trans[i] for i in order[:6]], key=lambda t: t[0])
    return [(lev, loc) for loc, lev, _ in trans]


def build_sample_divisors(pts):
    """BuildSampleDivisors (atrac3denc.cpp:154-174)."""
    div = np.ones(256, f32)
    pos = 0
    for i, (level_idx, loc) in enumerate(pts):
        last_pos = loc << _LOC_SCALE
        level = GAIN_LEVEL[level_idx]
        nxt = pts[i + 1][0] if i + 1 < len(pts) else _EXP_OFFSET
        inc = GAIN_INTERP[nxt - level_idx + _INTERP_SHIFT]
        while pos < last_pos and pos < 256:
            div[pos] = level
            pos += 1
        while pos < last_pos + _LOC_SZ and pos < 256:
            div[pos] = level
            level = f32(level * inc)
            pos += 1
    return div


def modulate(buf_cur, buf_next, pts):
    """TGainProcessor::Modulate in place (gain_processor.h:87-122):
    buf_cur [256] /= GainLevel[pts[0].Level]; buf_next per-sample curve."""
    if not pts:
        return
    scale = GAIN_LEVEL[pts[0][0]]
    pos = 0
    for i, (level_idx, loc) in enumerate(pts):
        last_pos = loc << _LOC_SCALE
        level = GAIN_LEVEL[level_idx]
        nxt = pts[i + 1][0] if i + 1 < len(pts) else _EXP_OFFSET
        inc = GAIN_INTERP[nxt - level_idx + _INTERP_SHIFT]
        while pos < last_pos:
            buf_cur[pos] = f32(buf_cur[pos] / scale)
            buf_next[pos] = f32(buf_next[pos] / level)
            pos += 1
        while pos < last_pos + _LOC_SZ:
            buf_cur[pos] = f32(buf_cur[pos] / scale)
            buf_next[pos] = f32(buf_next[pos] / level)
            level = f32(level * inc)
            pos += 1
    while pos < 256:
        buf_cur[pos] = f32(buf_cur[pos] / scale)
        pos += 1


def _safe_energy_scale(orig, mod):
    eps = 1.0e-20
    if (orig <= eps or mod <= eps or not np.isfinite(orig)
            or not np.isfinite(mod)):
        return f32(1.0)
    scale = f32(orig / mod)
    return scale if np.isfinite(scale) and scale > 0.0 else f32(1.0)


def calc_gain_energy_scale(prev_overlap, cur_input, pts, prev_scale, enc_win):
    """CalcGainEnergyScale (atrac3denc.cpp:176-225) -> (prev_half,
    cur_half, frame, next_overlap_scale)."""
    if not np.isfinite(prev_scale) or prev_scale <= 0.0:
        prev_scale = f32(1.0)
    prev_div = GAIN_LEVEL[pts[0][0]] if pts else f32(1.0)
    pse = f32(0.0)
    for v in prev_overlap:
        pse = f32(pse + f32(v * v))
    prev_orig = f32(pse * prev_scale)
    prev_mod = f32(pse / f32(prev_div * prev_div))
    div = build_sample_divisors(pts)
    cur_o = f32(0.0)
    cur_m = f32(0.0)
    nxt_o = f32(0.0)
    nxt_m = f32(0.0)
    for i in range(256):
        cur = cur_input[i]
        mod = f32(cur / div[i])
        wc = enc_win[255 - i]
        wn = enc_win[i]
        cw = f32(cur * wc)
        mcw = f32(mod * wc)
        nw = f32(cur * wn)
        mnw = f32(mod * wn)
        cur_o = f32(cur_o + f32(cw * cw))
        cur_m = f32(cur_m + f32(mcw * mcw))
        nxt_o = f32(nxt_o + f32(nw * nw))
        nxt_m = f32(nxt_m + f32(mnw * mnw))
    return (_safe_energy_scale(prev_orig, prev_mod),
            _safe_energy_scale(cur_o, cur_m),
            _safe_energy_scale(f32(prev_orig + cur_o), f32(prev_mod + cur_m)),
            _safe_energy_scale(nxt_o, nxt_m))


def _build_subframe_divisors(pts):
    div = build_sample_divisors(pts)
    out = np.empty(32, f32)
    for sf in range(32):
        s = f32(0.0)
        for i in range(8):
            s = f32(s + div[sf * 8 + i])
        out[sf] = f32(s / f32(8.0))
    return out


def _early_mismatch_score(gain, target, pts):
    """CalcCurveEarlyMismatchScore (atrac3denc.cpp:259-298)."""
    if len(gain) != 32 or target <= 1e-9:
        return f32(0.0)
    div = _build_subframe_divisors(pts)
    max_loc = max((loc for _, loc in pts), default=0)
    eval_sf = min(32, max(3, max_loc + 3))
    eps = f32(1e-9)
    fit = f32(0.0)
    for sf in range(eval_sf):
        mod = f32(gain[sf] / max(div[sf], eps))
        e = f32(_libm.log2f(float(f32(max(mod, eps) / max(target, eps)))))
        fit = f32(fit + f32(e * e))
    fit = f32(fit / f32(float(eval_sf)))
    leak = f32(0.0)
    wsum = f32(0.0)
    for sf in range(eval_sf - 1):
        a = f32(_libm.log2f(float(max(div[sf], eps))))
        b = f32(_libm.log2f(float(max(div[sf + 1], eps))))
        d = f32(b - a)
        w = f32(f32(0.5) * f32(gain[sf] + gain[sf + 1]))
        leak = f32(leak + f32(f32(d * d) * w))
        wsum = f32(wsum + w)
    if wsum > eps:
        leak = f32(leak / wsum)
    return f32(fit + f32(f32(0.25) * leak))


def _limit_rel(x):
    return min(max(f32(x), GAIN_LEVEL[15]), GAIN_LEVEL[0])


def create_subband_info(up_inputs, curve_ctx):
    """CreateSubbandInfo for one channel-frame (atrac3denc.cpp:299-578).

    up_inputs [4][512] (prev128|cur256|next128 per band, already /4 input
    domain); curve_ctx: list of 4 CurveCtx.  Returns curves: list of 4
    [(level, loc)] lists."""
    curves = [[] for _ in range(4)]
    for band in range(4):
        sig, hfr = upsampler_process(np.asarray(up_inputs[band], f32))
        if hfr < _HFR_THRESHOLD:
            curve_ctx[band].last_level = f32(0.0)
            continue
        gain, glow, ghigh = analyze_gain(sig[1024:3072], 32, True)

        cur_hpf = f32(0.0)
        for v in gain:
            cur_hpf = f32(cur_hpf + v)
        cur_hpf = f32(cur_hpf / f32(float(len(gain))))
        prev_hpf = curve_ctx[band].last_hpf_energy
        curve_ctx[band].last_hpf_energy = cur_hpf
        hpf_overlap = (f32(prev_hpf / cur_hpf)
                       if cur_hpf > 1e-9 and prev_hpf > 1e-9 else f32(1.0))

        overlap_factor = min(f32(1.5), max(f32(1.0), hpf_overlap))
        dyn_min_score = f32(f32(1.9) * overlap_factor)

        prev_target = curve_ctx[band].last_target
        pts = calc_curve(gain, curve_ctx[band], dyn_min_score,
                         glow, ghigh)
        cur_target = curve_ctx[band].last_target
        if not pts:
            continue

        max_gain = f32(0.0)
        for g in gain:
            max_gain = max(max_gain, g)
        if max_gain < f32(1e-4):
            pts = []
        if hfr < f32(0.3):
            pts = []
        if band >= 3:
            pts = []

        if band < 3:
            before = list(pts)
            changed = False
            if pts and pts[0][1] > 0:
                n_before = pts[0][1]
                divisor = GAIN_LEVEL[pts[0][0]]
                s = f32(0.0)
                for sf in range(n_before):
                    s = f32(s + gain[sf])
                hrnm = f32(f32(s / f32(float(n_before))) / divisor)
                valid = True
            elif not pts:
                s = f32(0.0)
                for v in gain:
                    s = f32(s + v)
                hrnm = f32(s / f32(float(len(gain))))
                valid = True
            else:
                hrnm = f32(0.0)
                valid = False

            if valid and prev_target > 1e-6 and hrnm > 1e-6:
                p0 = relation_to_idx(f32(prev_target / hrnm))
                at0 = next((i for i, p in enumerate(pts) if p[1] == 0), None)
                if at0 is not None:
                    if pts[at0][0] != p0:
                        pts[at0] = (p0, 0)
                        changed = True
                elif p0 != 4 or pts:
                    pts.insert(0, (p0, 0))
                    changed = True

            if changed:
                sb = _early_mismatch_score(gain, cur_target, before)
                sa = _early_mismatch_score(gain, cur_target, pts)
                keep_boundary = False
                if valid and prev_target > 1e-6 and hrnm > 1e-6:
                    def first_level(p):
                        return p[0][0] if p else _EXP_OFFSET
                    desired = _limit_rel(f32(prev_target / hrnm))
                    s_b = GAIN_LEVEL[first_level(before)]
                    s_a = GAIN_LEVEL[first_level(pts)]
                    eps = f32(1e-9)
                    eb = abs(f32(_libm.log2f(
                        float(f32(max(s_b, eps) / max(desired, eps))))))
                    ea = abs(f32(_libm.log2f(
                        float(f32(max(s_a, eps) / max(desired, eps))))))
                    keep_boundary = f32(ea + f32(0.20)) < eb
                if not keep_boundary and sa > f32(sb * f32(1.02)):
                    pts = before

        if (len(pts) >= 2 and pts[0][1] == 0 and pts[0][0] == pts[1][0]):
            pts = pts[1:]

        curves[band] = pts
    return curves
