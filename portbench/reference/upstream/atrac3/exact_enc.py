"""Bit-exact ATRAC3 encoder (reference float32 semantics) — QA path.

Replicates the reference encoder's float decision chain operation for
operation so the produced frames are byte-identical to the reference
binary's.  Currently covers the PLAIN mode (--nogaincontrol --notonal);
the gain-control and tonal layers hook in where marked.

Reference anchors:
  * input scaling and framing      (src/atrac3denc.cpp:694-712)
  * QMF tree                       (src/atrac/at3/atrac3_qmf.h:25-42)
  * forward MDCT + window chain    (src/atrac3denc.cpp:33-58)
  * scaler                         (src/atrac/atrac_scale.cpp:139-190)
  * loudness                       (src/atrac3denc.cpp:817-827,
                                    atrac_psy_common.h:46-55)
  * spread / initial NumBfu        (atrac_psy_common.cpp:85-105,
                                    atrac3_bitstream.cpp:567-585)
  * lambda bisection               (lib/bs_encode/encode.cpp:57-98)
  * CalcBitsAllocation             (atrac3_bitstream.cpp:272-336)
  * QuantMantisas (EA rounding)    (atrac_scale.cpp:40-130)
  * CLC/VLC costing                (atrac3_bitstream.cpp:93-150)
  * ConsiderEnergyErr / CheckBfus  (atrac3_bitstream.cpp:233-258)
  * per-channel bit budgets        (atrac3_bitstream.cpp:759-846)

Shares the float-exact machinery of the ATRAC1 QA paths: the builds are
-O2 scalar SSE2 (one rounding per op, no FMA) and unqualified C++
cos/sin/log10 on float arguments resolve to the f-suffix forms.
"""
import numpy as np

from portbench.reference.upstream.atrac1.exact_enc import (_TMDCT,
                                                   _qmf_analysis_stream)
from portbench.reference.upstream.atrac1.exact_synth import _libm, f32
from . import tables as T

__all__ = ["encode_track_exact"]

_MDCT512 = _TMDCT(512, 1.0)                          # atrac3denc.h:58,64

_SCALE_TABLE = np.asarray(T.SCALE_TABLE, f32)
_MAXQ = np.asarray(T.MAX_QUANT, f32)
_CLC_LEN = np.asarray(T.CLC_LENGTH_TAB, np.int64)
_VLC_BITS = np.asarray(T.VLC_BITS, np.int64)         # [7, 63] symbol lengths
_BLOCK_TAB = np.asarray(T.BLOCK_SIZE_TAB, np.int64)  # [33]
_SPECS = np.asarray(T.SPECS_PER_BLOCK, np.int64)
_FIX = np.asarray([6, 6, 5, 4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3, 3,
                   2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 0, 0, 0], np.int64)
_LOSY_NAQ_START = 18                                 # EAQ config
_BOOST_NAQ_END = 10


# double-precision glibc sin for the window table
# (float EncodeWindow[256] = sin(((i+0.5)/256 - 0.5)*pi) + 1.0,
#  atrac3.h:184-186: double trig, float storage)
import ctypes
_libm.sin.restype = ctypes.c_double
_libm.sin.argtypes = [ctypes.c_double]
_libm.log2f.restype = ctypes.c_float
_libm.log2f.argtypes = [ctypes.c_float]
_ENC_WINDOW = np.asarray(
    [_libm.sin(((i + 0.5) / 256.0 - 0.5) * np.pi) + 1.0 for i in range(256)],
    np.float64).astype(f32)


def _loudness_curve_1024():
    """CreateLoudnessCurve(1024) — see atrac1.exact_enc._loudness_curve."""
    _libm.log10f.restype = ctypes.c_float
    _libm.log10f.argtypes = [ctypes.c_float]
    res = np.empty(1024, f32)
    for i in range(1024):
        fq = f32(f32(f32(f32(i + 3) * f32(0.5)) * f32(44100.0)) / f32(1024.0))
        t = f32(np.float64(_libm.log10f(float(fq))) - 3.5)
        t = f32(f32(f32(-10 * t) * t) + f32(3)) - f32(fq / f32(3000.0))
        res[i] = f32(10.0 ** np.float64(0.1 * np.float64(t)))
    return res


_LOUD_CURVE = _loudness_curve_1024()


def _at3_ath():
    """TAtrac3BitStreamWriter ctor ATH (atrac3_bitstream.cpp:706-720):
    CalcATH(1024, 44100) with the Frank table re-implemented locally."""
    mf = f32(44100.0 / 2000.0)
    spec = np.empty(1024, f32)
    tab = np.asarray([
        9669, 9669, 9626, 9512, 9353, 9113, 8882, 8676,
        8469, 8243, 7997, 7748, 7492, 7239, 7000, 6762,
        6529, 6302, 6084, 5900, 5717, 5534, 5351, 5167,
        5004, 4812, 4638, 4466, 4310, 4173, 4050, 3922,
        3723, 3577, 3451, 3281, 3132, 3036, 2902, 2760,
        2658, 2591, 2441, 2301, 2212, 2125, 2018, 1900,
        1770, 1682, 1594, 1512, 1430, 1341, 1260, 1198,
        1136, 1057, 998, 943, 887, 846, 744, 712,
        693, 668, 637, 606, 580, 555, 529, 502,
        475, 448, 422, 398, 375, 351, 327, 322,
        312, 301, 291, 268, 246, 215, 182, 146,
        107, 61, 13, -35, -96, -156, -179, -235,
        -295, -350, -401, -421, -446, -499, -532, -535,
        -513, -476, -431, -313, -179, 8, 203, 403,
        580, 736, 881, 1022, 1154, 1251, 1348, 1421,
        1479, 1399, 1285, 1193, 1287, 1519, 1914, 2369,
        3352, 4352, 5352, 6352, 7352, 8352, 9352, 9999,
        9999, 9999, 9999, 9999], np.float64)

    def frank(freq):
        freq = min(max(freq, 10.0), 29853.0)
        fl = 40.0 * np.log10(0.1 * freq)
        idx = int(fl)
        return 0.01 * (tab[idx] * (1 + idx - fl) + tab[idx + 1] * (fl - idx))

    for i in range(1024):
        fq = f32(f32(i + 1) * mf / f32(1024.0))
        trh = f32(frank(1.0e3 * np.float64(fq)) - 100.0)
        spec[i] = trh - f32(fq * fq) * f32(0.015)
    ath = np.empty(32, f32)
    for b in range(32):
        start = int(_BLOCK_TAB[b])
        x = f32(999.0)
        for line in range(start, start + int(_SPECS[b])):
            x = min(x, spec[line])
        # pow(10, 0.1f * x): float product, double pow
        ath[b] = f32(10.0 ** np.float64(f32(f32(0.1) * x)))
    return ath


_ATH = _at3_ath()


# ---------------------------------------------------------------------------
# QuantMantisas — exact EA rounding (atrac_scale.cpp:40-130)
# ---------------------------------------------------------------------------

def _err_div(e1, e2):
    with np.errstate(divide="ignore"):
        return f32(e1 / e2)


def quant_mantissas_exact(vals, mul, ea):
    """vals [L] f32 (scaled block values) -> (mant int64[L], err f32).

    e1/e2 with e2 == 0 yields inf on purpose — the reference computes the
    same float division (atrac_scale.cpp QuantMantisas) and the inf err is
    part of the decision chain the goldens pin.
    """
    L = len(vals)
    mant = np.zeros(L, np.int64)
    e1 = f32(0.0)
    e2 = f32(0.0)
    inv2 = f32(np.float64(1.0) / np.float64(f32(mul * mul)))
    t_all = (vals * mul).astype(f32)
    if not ea:
        for j in range(L):
            e1 = f32(e1 + f32(vals[j] * vals[j]))
            mant[j] = int(np.rint(t_all[j]))
            e2 = f32(e2 + f32(f32(mant[j] * mant[j]) * inv2))
        return mant, _err_div(e1, e2)

    candidates = []
    for j in range(L):
        t = t_all[j]
        e1 = f32(e1 + f32(vals[j] * vals[j]))
        mant[j] = int(np.rint(t))
        e2 = f32(e2 + f32(f32(mant[j] * mant[j]) * inv2))
        delta = f32(t - f32(np.trunc(t) + f32(0.5)))
        if abs(delta) < 0.25:
            candidates.append((abs(delta), j))
    if not candidates:
        return mant, _err_div(e1, e2)
    # std::sort by |delta| (ties: unspecified order; libstdc++ keeps
    # insertion order for the sizes seen here — pinned by the golden tests)
    candidates.sort(key=lambda p: p[0])
    if e2 < e1:
        for _, j in candidates:
            t = t_all[j]
            if f32(abs(mant[j])) < abs(t) and f32(abs(mant[j])) < f32(mul - 1.0):
                m = mant[j]
                if m > 0:
                    m += 1
                if m < 0:
                    m -= 1
                if m == 0:
                    m = 1 if t > 0 else -1
                ex = f32(f32(e2 - f32(f32(mant[j] * mant[j]) * inv2))
                         + f32(f32(m * m) * inv2))
                if abs(f32(ex - e1)) < abs(f32(e2 - e1)):
                    mant[j] = m
                    e2 = ex
    elif e2 > e1:
        for _, j in candidates:
            t = t_all[j]
            if f32(abs(mant[j])) > abs(t):
                m = mant[j]
                if m > 0:
                    m -= 1
                if m < 0:
                    m += 1
                ex = f32(f32(e2 - f32(f32(mant[j] * mant[j]) * inv2))
                         + f32(f32(m * m) * inv2))
                if abs(f32(ex - e1)) < abs(f32(e2 - e1)):
                    mant[j] = m
                    e2 = ex
    return mant, _err_div(e1, e2)


def _clc_bits(wl, block_size):
    nb = int(_CLC_LEN[wl])
    return nb * block_size if wl > 1 else nb * block_size // 2


def _vlc_bits(wl, mant):
    sel = wl
    if sel > 1:
        tab = _VLC_BITS[sel - 1]
        bits = 0
        for m in mant:
            h = ((-m) << 1 | 1) if m < 0 else (m << 1)
            if h:
                h -= 1
            bits += int(tab[h])
        return bits
    # selector 1: pair codebook (MantissasToVlcIndex)
    tab = _VLC_BITS[0]
    rtab = np.asarray(T.VLC_PAIR_RTAB, np.int64)
    bits = 0
    for i in range(len(mant) // 2):
        key = 3 * (mant[2 * i] + 1) + (mant[2 * i + 1] + 1)
        bits += int(tab[rtab[key]])
    return bits


# ---------------------------------------------------------------------------
# per-channel allocation (TConfigure + TAlloc, atrac3_bitstream.cpp:587-685)
# ---------------------------------------------------------------------------

class _QuantCache:
    """TEncCache keyed on (bfu, wordlen); reset per channel."""

    def __init__(self, scaled_vals):
        self.vals = scaled_vals                      # [32] list of arrays
        self.map = {}

    def get(self, bfu, wl):
        key = (bfu, wl)
        if key not in self.map:
            block = self.vals[bfu]
            mul = _MAXQ[min(wl, 7)]
            mant, err = quant_mantissas_exact(block, mul,
                                              bfu > _LOSY_NAQ_START)
            self.map[key] = (mant, err, _clc_bits(wl, len(block)),
                             _vlc_bits(wl, mant))
        return self.map[key]


def _spread(sfi_used):
    """AnalizeScaleFactorSpread (atrac_psy_common.cpp:85-105)."""
    n = len(sfi_used)
    s = f32(0.0)
    for v in sfi_used:
        s = f32(s + f32(v))
    s = f32(s / f32(n))
    sigma = f32(0.0)
    for v in sfi_used:
        t = f32(f32(v) - s)
        t = f32(t * t)
        sigma = f32(sigma + t)
    sigma = f32(sigma / f32(n))
    sigma = f32(np.sqrt(sigma))
    if sigma > 14.0:
        sigma = f32(14.0)
    return f32(sigma / f32(14.0))


def _x_of(i):
    if i < 3:
        return f32(2.8)
    if i < 10:
        return f32(2.6)
    if i < 15:
        return f32(3.3)
    if i <= 20:
        return f32(3.6)
    if i <= 28:
        return f32(4.2)
    return f32(6.0)


def _calc_bits_allocation(sfi, energy, num_bfu, spread, shift, loudness,
                          gain_frame_scale, tonal_bfus):
    bits = np.zeros(num_bfu, np.int64)
    b2b = np.asarray(T.BFU_TO_BAND)
    for i in range(num_bfu):
        gs = gain_frame_scale[b2b[i]]                # sanitized by caller
        corrected = f32(energy[i] * gs)
        ath = f32(_ATH[i] * loudness)
        if corrected < ath:
            bits[i] = 0
            continue
        fix = _FIX[i]
        x = _x_of(i)
        # EnergyScaleToScaleFactorOffset: 1.5f * log2(float) -> log2f;
        # plain mode gs == 1.0 -> exactly 0
        off = f32(f32(1.5) * f32(_libm.log2f(float(gs))))
        csfi = max(f32(0.0), min(f32(63.0), f32(f32(sfi[i]) + off)))
        tmp_f = f32(f32(spread * f32(csfi / x))
                    + f32(f32(f32(1.0) - spread) * f32(fix)))
        tmp = int(f32(tmp_f - shift))                # C int cast: trunc
        if tmp > 7:
            bits[i] = 7
        elif tmp < 0:
            bits[i] = 0
        elif tmp == 0:
            bits[i] = 1
        else:
            bits[i] = tmp
    for bfu in tonal_bfus:
        if bfu < num_bfu and bits[bfu] > 2:
            bits[bfu] -= 1
    return bits


def _consider_energy_err(err, bits):
    """atrac3_bitstream.cpp:245-258 (BOOST_NAQ_END = 10)."""
    adjusted = False
    lim = min(_BOOST_NAQ_END, len(bits))
    for i in range(lim):
        e = err[i]
        if ((e > 0 and e < 0.7) or e > 1.2) and bits[i] < 7:
            bits[i] += 1
            adjusted = True
    return adjusted


def _allocate_channel(sfi, vals, energy, target_bits, loudness,
                      gain_frame_scale, tonal_bfus=(), tonal_cost_fn=None,
                      bfu_idx_const=0):
    """Full TConfigure+TAlloc flow.  Returns (num_bfu, coding_mode,
    wordlens [32], mantissas list per bfu)."""
    cache = _QuantCache(vals)
    spread = _spread(sfi)
    num_bfu = bfu_idx_const if bfu_idx_const else 32
    if target_bits < 101:
        lim = max(1, (target_bits - 5) // 3) if target_bits > 5 else 1
        num_bfu = min(num_bfu, lim)
    num_bfu = max(1, num_bfu)
    if tonal_cost_fn is None:
        tonal_cost_fn = lambda alloc: 5              # empty tonal header

    while True:                                      # BFU-shrink restarts
        min_l, max_l = f32(-8.0), f32(20.0)
        last_l = f32(20.0)
        while True:                                  # lambda bisection
            if max_l <= min_l:
                shift = last_l
                final = True
            else:
                shift = f32(f32(max_l + min_l) / f32(2.0))
                final = False
            alloc = _calc_bits_allocation(sfi, energy, num_bfu, spread,
                                          shift, loudness, gain_frame_scale,
                                          tonal_bfus)
            while True:                              # energy-boost loop
                err = np.zeros(num_bfu, f32)
                clc_sum = vlc_sum = 0
                used = num_bfu * 3
                for i in range(num_bfu):
                    if alloc[i] == 0:
                        continue
                    used += 6
                    _, e, cb, vb = cache.get(i, int(alloc[i]))
                    err[i] = e
                    clc_sum += cb
                    vlc_sum += vb
                mode = 1 if clc_sum <= vlc_sum else 0
                bits_used = used + (clc_sum if mode else vlc_sum)
                if not _consider_energy_err(err, alloc):
                    break
            total = bits_used + tonal_cost_fn(alloc)
            if final:
                break
            if total < target_bits:
                last_l = shift
                max_l = f32(shift - f32(0.01))
            elif total > target_bits:
                min_l = f32(shift + f32(0.01))
            else:
                break
        if bfu_idx_const == 0 and num_bfu > 1 and alloc[num_bfu - 1] == 0:
            num_bfu -= 1
            continue
        mants = [cache.get(i, int(alloc[i]))[0] if alloc[i] else
                 np.zeros(int(_SPECS[i]), np.int64) for i in range(num_bfu)]
        wl = np.zeros(32, np.int64)
        wl[:num_bfu] = alloc
        return num_bfu, mode, wl, mants


# ---------------------------------------------------------------------------
# tonal components (atrac3denc.cpp:581-663, atrac3_bitstream.cpp:338-555)
# ---------------------------------------------------------------------------

def _flatness_per_bfu(energy_spec):
    """CalcSpectralFlatnessPerBfu (atrac_psy_common.cpp:139-180): double
    arithmetic over the float energies, float flatness out."""
    floor = float(f32(1e-12))
    flat = np.ones(32, f32)
    for b in range(32):
        start = int(_BLOCK_TAB[b])
        ln = int(_SPECS[b])
        am = 0.0
        ml = 0.0
        for i in range(start, start + ln):
            e = float(max(f32(0.0), energy_spec[i]))
            am += e
            ml += np.log(max(e, floor))
        am /= ln
        ml /= ln
        if am <= floor:
            continue
        flat[b] = f32(min(1.0, max(0.0, np.exp(ml) / am)))
    return flat


def _extract_tonal(spec, flat):
    """ExtractTonalComponents: mutates spec in place, returns
    [(pos, bfu)] component list (values read back from the caller's copy)."""
    comps = []
    for b in range(8, 29):
        if not (flat[b] < f32(0.01)):
            continue
        start = int(_BLOCK_TAB[b])
        ln = int(_SPECS[b])
        end = start + ln
        max_len = min(5, ln)
        best_score = f32(-1.0)
        best_start, best_len = start, 1
        for s in range(start, end):
            mls = min(max_len, end - s)
            score = f32(0.0)
            for L in range(1, mls + 1):
                score = f32(score + abs(spec[s + L - 1]))
                if score > best_score:
                    best_score = score
                    best_start, best_len = s, L
        if not (best_score > 0.0):
            continue
        for nn in range(best_len):
            pos = best_start + nn
            comps.append((pos, float(spec[pos]), b))
            spec[pos] = f32(0.0)
    return comps


def _scale_block(vals):
    """TScaler::Scale for one short run (atrac_scale.cpp:139-173)."""
    mx = f32(0.0)
    for v in np.abs(np.asarray(vals, f32)):
        if v > mx:
            mx = v
    if mx > f32(1.0):
        mx = f32(1.0)
    idx = int(np.searchsorted(_SCALE_TABLE, mx, side="left"))
    sf = _SCALE_TABLE[idx]
    out = np.empty(len(vals), f32)
    for i, v in enumerate(np.asarray(vals, f32)):
        sv = f32(v / sf)
        if abs(sv) >= 1.0:
            sv = f32(0.99999) if sv > 0 else f32(-0.99999)
        out[i] = sv
    return idx, out


def _map_tonal(comps):
    """MapTonalComponents: join pos-consecutive components into blocks of
    <= 7, scale each block.  Returns [{bfu, pos, sfi, values}]."""
    blocks = []
    i = 0
    while i < len(comps):
        start = i
        while True:
            cur_pos = comps[i][0]
            i += 1
            if not (i < len(comps) and comps[i][0] == cur_pos + 1
                    and i - start < 7):
                break
        vals = [comps[j][1] for j in range(start, i)]
        sfi, scaled = _scale_block(vals)
        blocks.append({"bfu": comps[start][2], "pos": comps[start][0],
                       "sfi": sfi, "values": scaled})
    return blocks


def _tonal_subgroups(blocks, alloc):
    """GroupTonalComponents: bucket by (quant, len), split on the 64-line
    window limiter walk.  Returns [(bucket_idx, members)] and the final
    per-block quant (None for blocks skipped by NumBfu trimming)."""
    buckets = [[] for _ in range(64)]
    quants = {}
    for bi, blk in enumerate(blocks):
        if blk["bfu"] >= len(alloc):
            continue
        quant = max(2, min(int(alloc[blk["bfu"]]) + 4, 7))
        quants[bi] = quant
        buckets[quant * 8 + len(blk["values"])].append(blk)
    subgroups = []
    for i in range(64):
        ptr = buckets[i]
        cur = 0
        while cur < len(ptr):
            start = cur
            anchor = cur
            limiter = 0
            while True:
                cur += 1
                if cur == len(ptr):
                    break
                if ptr[cur]["pos"] - (ptr[anchor]["pos"] & ~63) < 64:
                    limiter += 1
                else:
                    limiter = 0
                    anchor = cur
                if limiter >= 7:
                    break
            subgroups.append((i, ptr[start:cur]))
    return subgroups, quants


def _tonal_bits(blocks, alloc):
    """EncodeTonalComponents bit count (bitStream == nullptr path)."""
    subgroups, _ = _tonal_subgroups(blocks, alloc)
    bits = 5
    if not subgroups:
        return bits
    bits += 2                                       # coding mode (VLC)
    for i, members in subgroups:
        quant = i >> 3
        mul = _MAXQ[min(quant, 7)]
        counts = [0] * 16
        for m in members:
            counts[m["pos"] >> 6] += 1
        band_any = [any(counts[4 * b: 4 * b + 4]) for b in range(4)]
        bits += 4 + 3 + 3
        for j in range(16):
            if not band_any[j >> 2]:
                continue
            bits += 3
            for m in members:
                if m["pos"] >> 6 != j:
                    continue
                bits += 6 + 6
                mant = [int(np.rint(f32(v * mul))) for v in m["values"]]
                bits += _vlc_bits(quant, mant)
    return bits


# ---------------------------------------------------------------------------
# frontend: QMF tree, MDCT, scaler, loudness
# ---------------------------------------------------------------------------

def _analysis_tree(pcm4):
    """pcm4 [C, F*1024] (already /4) -> bands [C, F, 4, 256]."""
    c, total = pcm4.shape
    lo1, up1 = _qmf_analysis_stream(pcm4)            # [C, total/2]
    s0, s1 = _qmf_analysis_stream(lo1)               # subs[0], subs[1]
    s3, s2 = _qmf_analysis_stream(up1)               # subs[3], subs[2]
    f = total // 1024
    bands = np.stack([s0.reshape(c, f, 256), s1.reshape(c, f, 256),
                      s2.reshape(c, f, 256), s3.reshape(c, f, 256)], axis=2)
    return bands


def _mdct_frames(bands):
    """bands [C, F, 4, 256] -> specs [C, F, 1024] (plain mode: no gain
    modulation; atrac3denc.cpp:33-58)."""
    c, nf = bands.shape[:2]
    specs = np.empty((c, nf, 1024), f32)
    prev_win = np.zeros((c, 4, 256), f32)            # PcmBuffer first halves
    w = _ENC_WINDOW
    for fi in range(nf):
        for band in range(4):
            cur = bands[:, fi, band]                 # [C, 256]
            tmp = np.empty((c, 512), f32)
            tmp[:, :256] = prev_win[:, band]
            first = w[:256] * cur                    # srcBuff[i] stored
            tmp[:, 256:] = w[255::-1] * cur          # W[255-i] * cur[i]
            prev_win[:, band] = first
            sp = _MDCT512(tmp)
            if band & 1:
                sp = sp[:, ::-1]
            specs[:, fi, band * 256: (band + 1) * 256] = sp
    return specs


def _gain_mdct(bands_ext, nf):
    """Gain-controlled frontend over the whole track (atrac3denc.cpp
    GetLambda channel loop): per (frame, channel) CreateSubbandInfo,
    CalcGainEnergyScale, gain-modulated MDCT with windowed-overlap chain.

    bands_ext [C, F+1, 4, 256] (the +1 row is the drain-call lookahead).
    Returns (specs [C, F, 1024], frame_scales [C, F, 4],
    curves_all [C][F][4] point lists)."""
    from . import exact_gain as G

    c = bands_ext.shape[0]
    specs = np.empty((c, nf, 1024), f32)
    frame_scales = np.ones((c, nf, 4), f32)
    curves_all = [[None] * nf for _ in range(c)]
    prev_win = np.zeros((c, 4, 256), f32)            # stored windowed halves
    prev_scale = np.ones((c, 4), f32)                # PrevOverlapGainScale
    ctxs = [[G.CurveCtx() for _ in range(4)] for _ in range(c)]
    w = _ENC_WINDOW

    for fi in range(nf):
        for ci in range(c):
            # LookAheadBuf window per band: [prev128 | cur256 | next128]
            ups = []
            for band in range(4):
                prev_tail = (bands_ext[ci, fi - 1, band, 128:] if fi > 0
                             else np.zeros(128, f32))
                nxt = bands_ext[ci, fi + 1, band, :128]
                ups.append(np.concatenate(
                    [prev_tail, bands_ext[ci, fi, band], nxt]))
            curves = G.create_subband_info(ups, ctxs[ci])
            curves_all[ci][fi] = curves

            spec_frame = np.empty(1024, f32)
            for band in range(4):
                pts = curves[band]
                cur = bands_ext[ci, fi, band].copy()
                # energy scales BEFORE modulation (atrac3denc.cpp:795-801)
                ps, cs, fs, ns = G.calc_gain_energy_scale(
                    prev_win[ci, band], cur, pts, prev_scale[ci, band], w)
                frame_scales[ci, fi, band] = fs
                prev_scale[ci, band] = ns
                # MDCT with in-place modulation (atrac3denc.cpp:33-58)
                tmp = np.empty(512, f32)
                tmp[:256] = prev_win[ci, band]
                if pts:
                    G.modulate(tmp[:256], cur, pts)
                first = (w[:256] * cur).astype(f32)
                tmp[256:] = (w[255::-1] * cur).astype(f32)
                prev_win[ci, band] = first
                sp = _MDCT512(tmp)
                if band & 1:
                    sp = sp[::-1]
                spec_frame[band * 256: (band + 1) * 256] = sp
            specs[ci, fi] = spec_frame
    return specs, frame_scales, curves_all


def _scale_frame(spec):
    """spec [1024] -> (sfi [32], vals list, energy [32]) — TScaler::Scale
    per BFU (long windows only on AT3)."""
    sfi = np.zeros(32, np.int32)
    vals = []
    energy = np.zeros(32, f32)
    for b in range(32):
        start = int(_BLOCK_TAB[b])
        ns = int(_SPECS[b])
        blk = spec[start: start + ns]
        mx = f32(0.0)
        for v in np.abs(blk):
            if v > mx:
                mx = v
        if mx > f32(1.0):
            mx = f32(1.0)
        idx = int(np.searchsorted(_SCALE_TABLE, mx, side="left"))
        sf = _SCALE_TABLE[idx]
        e = f32(0.0)
        out = np.empty(ns, f32)
        for i, v in enumerate(blk):
            sv = f32(v / sf)
            e = f32(e + f32(v * v))
            if abs(sv) >= 1.0:
                sv = f32(0.99999) if sv > 0 else f32(-0.99999)
            out[i] = sv
        sfi[b] = idx
        vals.append(out)
        energy[b] = e
    return sfi, vals, energy


def encode_track_exact(pcm, frame_bytes=384, bfu_idx_const=0,
                       no_tonal=True, no_gain=True, js=False):
    """[C, T] PCM -> AT3 planes, byte-exact to the reference when packed
    by frame.pack.  no_gain=False enables the gain-control layer
    (exact_gain.py); js enables joint stereo (M/S band matrixing +
    byte-budget shift, atrac3denc.cpp:665-677, atrac3_bitstream.cpp
    CalcMSBytesShift)."""
    pcm = np.atleast_2d(np.asarray(pcm, f32))
    c, t = pcm.shape
    pad = (-t) % 1024
    if pad:
        pcm = np.pad(pcm, ((0, 0), (0, pad)))
    nf = pcm.shape[1] // 1024
    pcm4 = (pcm / f32(4.0)).astype(f32)
    js_stereo = js and c == 2

    if no_gain:
        bands = _analysis_tree(pcm4)
        if js_stereo:
            bands = np.stack([((bands[0] + bands[1]) * f32(0.5)),
                              ((bands[0] - bands[1]) * f32(0.5))])
        specs = _mdct_frames(bands)
        frame_scales = np.ones((c, nf, 4), f32)
        curves_all = [[[[] for _ in range(4)] for _ in range(nf)]
                      for _ in range(c)]
    else:
        # The reference engine's drain call re-runs the QMF on the STALE
        # first buffer step (pcmengin.h:152-190 with a 4096-sample buffer
        # and TRawFloatReader returning false at EOF): the LAST frame's
        # lookahead input is input frame F-4 (F % 4 == 0 corpora), pushed
        # through the live filter state after frame F-1.
        if nf % 4 == 0 and nf >= 4:
            stale = pcm4[:, (nf - 4) * 1024: (nf - 3) * 1024]
        else:
            stale = np.zeros((c, 1024), f32)
        ext = np.concatenate([pcm4, stale], axis=1)
        bands_ext = _analysis_tree(ext)              # [C, F+1, 4, 256]
        if js_stereo:
            # Matrixing at band level (atrac3denc.cpp:665-677); the gain
            # analysis windows use the same M/S samples (jsGainInput)
            bands_ext = np.stack(
                [((bands_ext[0] + bands_ext[1]) * f32(0.5)),
                 ((bands_ext[0] - bands_ext[1]) * f32(0.5))])
        specs, frame_scales, curves_all = _gain_mdct(bands_ext, nf)

    # loudness with the per-band Frame gain scale (atrac3denc.cpp:817-827)
    loud_frames = np.zeros((c, nf), f32)
    for i in range(1024):
        e = specs[:, :, i] * specs[:, :, i]
        loud_frames = loud_frames + ((e * frame_scales[:, :, i // 256])
                                     * _LOUD_CURVE[i])

    half = frame_bytes // 2

    num_bfu = np.zeros((c, nf), np.int32)
    mode_out = np.zeros((c, nf), bool)
    wordlen = np.zeros((c, nf, 32), np.int32)
    sfi_out = np.zeros((c, nf, 32), np.int32)
    mant_out = np.zeros((c, nf, 32, 128), np.int32)
    t_act = np.zeros((c, nf, 32), bool)
    t_start = np.zeros((c, nf, 32), np.int32)
    t_len = np.zeros((c, nf, 32), np.int32)
    t_sfi = np.zeros((c, nf, 32), np.int32)
    t_quant = np.zeros((c, nf, 32), np.int32)
    t_mant = np.zeros((c, nf, 32, 8), np.int32)
    gain_npoints_out = np.zeros((c, nf, 4), np.int32)
    gain_levels_out = np.zeros((c, nf, 4, 8), np.int32)
    gain_locs_out = np.zeros((c, nf, 4, 8), np.int32)
    loudness_state = f32(0.006)                      # TAtrac3Data::LoudFactor
    loud_out = np.zeros((nf,), f32)

    ms_shift_out = np.zeros((nf,), np.int32)
    for fi in range(nf):
        if c == 2 and not js:
            s = f32(loud_frames[0, fi] + loud_frames[1, fi])
            loudness_state = f32(0.98 * np.float64(loudness_state)
                                 + 0.01 * np.float64(s))
        else:
            # 1 channel, or JS (side channel not used; atrac3denc.cpp:832)
            loudness_state = f32(0.98 * np.float64(loudness_state)
                                 + 0.02 * np.float64(loud_frames[0, fi]))
        loud = f32(loudness_state / f32(0.006))
        loud_out[fi] = loud

        if js:
            # per-channel budgets with the M/S byte shift
            # (atrac3_bitstream.cpp:759-812, CalcMSBytesShift)
            h = []
            for ci in range(2):
                if ci < c:
                    curves = curves_all[ci][fi]
                    gain_bits = sum(3 + 9 * len(curves[b]) for b in range(4))
                else:
                    gain_bits = 3                    # 1 empty band list
                ident = 14 if ci == 1 else 6        # WriteJsParams + 2 | 0x28
                # + 2 = the 2-bit numQmfBand field
                h.append(ident + 2 + gain_bits)
            total_used = 12 + h[0] + h[1]
            max_shift = half - (total_used + 7) // 8
            if c == 1:
                shift = max_shift
            else:
                m_l, s_l = loud_frames[0, fi], loud_frames[1, fi]
                total = f32(s_l + m_l)
                ratio = (f32(np.float64(f32(m_l / total)) - 0.5)
                         if total > 0 else f32(0.0))
                shift = int(np.rint(f32(frame_bytes * ratio)))
                shift = max(min(shift, max_shift), -max_shift)
            ms_shift_out[fi] = shift
            targets = [max(1, -6 - h[0] + 8 * (half + shift)),
                       max(1, -6 - h[1] + 8 * (half - shift))]
        for ci in range(c):
            spec = specs[ci, fi].copy()
            if no_tonal:
                blocks = []
                tonal_bfus = ()
                cost_fn = None
            else:
                energy_spec = (spec * spec).astype(f32)
                flat = _flatness_per_bfu(energy_spec)
                comps = _extract_tonal(spec, flat)   # mutates spec
                blocks = _map_tonal(comps)
                tonal_bfus = [blk["bfu"] for blk in blocks]
                cost_fn = lambda alloc: _tonal_bits(blocks, alloc)
            sfi, vals, energy = _scale_frame(spec)
            # per-channel bit budget: 6 (id) + 2 (numQmfBand) + gain lists
            # (atrac3_bitstream.cpp:768-810)
            curves = curves_all[ci][fi]
            if js:
                target = targets[ci]
            else:
                header = (6 + 2
                          + sum(3 + 9 * len(curves[b]) for b in range(4)))
                target = 8 * half - 6 - header
            nb, mode, wl, mants = _allocate_channel(
                sfi, vals, energy, target, loud, frame_scales[ci, fi],
                tonal_bfus=tonal_bfus, tonal_cost_fn=cost_fn,
                bfu_idx_const=bfu_idx_const)
            for band in range(4):
                for p, (lev, loc) in enumerate(curves[band]):
                    gain_levels_out[ci, fi, band, p] = lev
                    gain_locs_out[ci, fi, band, p] = loc
                gain_npoints_out[ci, fi, band] = len(curves[band])
            num_bfu[ci, fi] = nb
            mode_out[ci, fi] = bool(mode)
            wordlen[ci, fi] = wl
            sfi_out[ci, fi, :nb] = sfi[:nb]
            for b in range(nb):
                if wl[b]:
                    ns = int(_SPECS[b])
                    mant_out[ci, fi, b, :ns] = mants[b]
            if blocks:
                _, quants = _tonal_subgroups(blocks, wl[:nb])
                for bi, blk in enumerate(blocks):
                    if bi not in quants:
                        continue
                    q = quants[bi]
                    mul = _MAXQ[min(q, 7)]
                    bfu = blk["bfu"]
                    t_act[ci, fi, bfu] = True
                    t_start[ci, fi, bfu] = blk["pos"]
                    t_len[ci, fi, bfu] = len(blk["values"])
                    t_sfi[ci, fi, bfu] = blk["sfi"]
                    t_quant[ci, fi, bfu] = q
                    for z, v in enumerate(blk["values"]):
                        t_mant[ci, fi, bfu, z] = int(np.rint(f32(v * mul)))

    out = {
        "num_bfu": num_bfu.astype(np.int8),
        "coding_mode": mode_out,
        "wordlen": wordlen.astype(np.int8),
        "sfi": sfi_out.astype(np.int8),
        "mant": mant_out.astype(np.int8),
        "gain_npoints": gain_npoints_out.astype(np.int8),
        "gain_levels": gain_levels_out.astype(np.int8),
        "gain_locs": gain_locs_out.astype(np.int8),
        "loudness": loud_out,
        "ms_shift": ms_shift_out,
    }
    if not no_tonal:
        out.update({
            "tonal_active": t_act,
            "tonal_start": t_start.astype(np.int16),
            "tonal_len": t_len.astype(np.int8),
            "tonal_sfi": t_sfi.astype(np.int8),
            "tonal_quant": t_quant.astype(np.int8),
            "tonal_mant": t_mant.astype(np.int8),
        })
    return out
