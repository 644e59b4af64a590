"""Bit-exact ATRAC1 encoder (reference float32 semantics) — QA path.

Replicates, operation-for-operation in IEEE float32, the reference
encoder's whole decision chain, so the produced AEA frames are
byte-identical to the reference binary's:

  * QMF analysis tree + 39-sample hi delay (src/qmf/qmf.h:46-64,
    src/atrac/at1/atrac1_qmf.h:25-44)
  * transient detection: 21-tap HPF + 19*log10f RMS ladder with the
    LastEnergy carry (src/transient_detector.cpp:36-87)
  * forward MDCT with in-place sine windowing and 32-sample stored tails
    (src/atrac1denc.cpp:69-99, lib/mdct/mdct.h:42-105; cos(float)->cosf
    overload resolution in the twiddle tables, mdct.cpp:25-37)
  * scaler with map::lower_bound semantics and sequential energy sums
    (src/atrac/atrac_scale.cpp:139-173)
  * loudness tracking (src/atrac/atrac_psy_common.h:46-55,
    atrac_psy_common.cpp:142-158; src/atrac1denc.cpp:236-247)
  * the lambda bisection + BFU-shrink + TBitsBooster allocation
    (src/atrac/at1/atrac1_bitalloc.cpp, lib/bs_encode/encode.cpp:57-98)

It is the ATRAC1 half of the benchmark's reference: what the program's
sound units are held against.
Like exact_synth.py it leans on the facts that the oracle builds at -O2
without -march (scalar SSE2: one rounding per op, no FMA) and that
unqualified C++ cos/sin/log10 on float arguments resolve to the f suffix
forms.
"""
import numpy as np

from . import tables as T
from .exact_synth import (_KissFFT, _libm, _libm_cosf, _libm_sinf,
                          _QMF_WINDOW, _SINE_WINDOW, f32)

import ctypes

_libm.log10f.restype = ctypes.c_float
_libm.log10f.argtypes = [ctypes.c_float]

__all__ = ["encode_track_exact"]


# ---------------------------------------------------------------------------
# TMDCT<N> forward (mdct.h:42-105); decoder instances: Mdct512(1),
# Mdct256(0.5), Mdct64(0.5) (atrac1denc.h:49-51)
# ---------------------------------------------------------------------------

class _TMDCT:
    def __init__(self, N, scale):
        # TMDCT passes its scale straight to TMDCTBase (mdct.h:46-49);
        # only TMIDCT halves it
        self.N = N
        base_scale = scale
        alpha = f32(2.0 * np.pi / (8.0 * N))
        omiga = f32(2.0 * np.pi / N)
        sf = f32(np.sqrt(base_scale / N))
        args = omiga * np.arange(N // 4, dtype=np.int64).astype(f32) + alpha
        self.cos = sf * _libm_cosf(args)
        self.sin = sf * _libm_sinf(args)
        self.fft = _KissFFT(N // 4)

    def __call__(self, x):
        """x [..., N] -> spectrum [..., N/2] (mdct.h:51-104)."""
        N = self.N
        n2, n4 = N // 2, N // 4
        n34, n54 = 3 * n4, 5 * n4
        k = np.arange(n4)
        n = 2 * k
        c, s = self.cos, self.sin
        ka = k[: n4 // 2]
        na = 2 * ka
        r0a = x[..., n34 - 1 - na] + x[..., n34 + na]
        i0a = x[..., n4 + na] - x[..., n4 - 1 - na]
        kb = k[n4 // 2:]
        nb = 2 * kb
        r0b = x[..., n34 - 1 - nb] - x[..., nb - n4]
        i0b = x[..., n4 + nb] + x[..., n54 - 1 - nb]
        r0 = np.concatenate([r0a, r0b], axis=-1)
        i0 = np.concatenate([i0a, i0b], axis=-1)
        xr = r0 * c + i0 * s
        xi = i0 * c - r0 * s
        yr, yi = self.fft(xr, xi)
        out = np.empty(x.shape[:-1] + (n2,), f32)
        out[..., n] = -yr * c - yi * s
        out[..., n2 - 1 - n] = -yr * s + yi * c
        return out


_MDCT64 = _TMDCT(64, 0.5)
_MDCT256 = _TMDCT(256, 0.5)
_MDCT512 = _TMDCT(512, 1.0)


# ---------------------------------------------------------------------------
# QMF analysis tree (qmf.h:46-64, atrac1_qmf.h:25-44)
# ---------------------------------------------------------------------------

def _qmf_analysis_stream(stream):
    """TQmf::Analysis over a whole track: stream [C, total] ->
    (lower, upper) [C, total/2] with the 46-sample FIR history implicit in
    a zero prefix; per-output tap accumulation order preserved."""
    c, total = stream.shape
    half = total // 2
    S = np.concatenate([np.zeros((c, 46), f32), stream], axis=1)
    w = _QMF_WINDOW
    lo = np.zeros((c, half), f32)
    up = np.zeros((c, half), f32)
    kpos = 2 * np.arange(half)
    for i in range(24):
        lo = lo + w[2 * i] * S[:, 47 + kpos - 2 * i]
        up = up + w[2 * i + 1] * S[:, 46 + kpos - 2 * i]
    # butterfly (qmf.h:60-63): temp=up; up = lo - up; lo = lo + temp
    return lo + up, lo - up


def _analysis_tree(pcm):
    """[C, F*512] -> low, mid [C, F, 128], hi [C, F, 256]."""
    c, total = pcm.shape
    st1_lo, st1_up = _qmf_analysis_stream(pcm)       # [C, total/2]
    low_s, mid_s = _qmf_analysis_stream(st1_lo)      # [C, total/4]
    hi_s = np.concatenate([np.zeros((c, 39), f32),
                           st1_up[:, :-39]], axis=1)  # 39-sample delay
    f = total // 512
    return (low_s.reshape(c, f, 128), mid_s.reshape(c, f, 128),
            hi_s.reshape(c, f, 256))


# ---------------------------------------------------------------------------
# Transient detection (transient_detector.cpp:36-87)
# ---------------------------------------------------------------------------

_FIRCOEF = np.asarray([
    -8.65163e-18 * 2.0, -0.00851586 * 2.0, -6.74764e-18 * 2.0,
    0.0209036 * 2.0, -3.36639e-17 * 2.0, -0.0438162 * 2.0,
    -1.54175e-17 * 2.0, 0.0931738 * 2.0, -5.52212e-17 * 2.0,
    -0.313819 * 2.0], np.float64).astype(f32)


def _hpf_stream(band, block_sz):
    """HPFilter over a whole band stream [C, total] (20-sample history =
    leading zeros; out[t] exactly as transient_detector.cpp:46-61).

    The C buffer is BlockSz+21 floats with the input copied to [20:20+B]:
    slot B+20 is never written, so the j==0 tap's inBuf[i+21] reads a
    PERMANENT ZERO at each block's last sample instead of the next block's
    first — replicated via the phantom mask below."""
    c, total = band.shape
    S = np.concatenate([np.zeros((c, 20), f32), band,
                        np.zeros((c, 1), f32)], axis=1)
    t = np.arange(total)
    s = S[:, t + 10].copy()
    s2 = np.zeros((c, total), f32)
    phantom = (t % block_sz) == (block_sz - 1)
    for j in range(0, 9, 2):
        right = S[:, t + 21 - j]
        if j == 0:
            right = np.where(phantom[None, :], f32(0.0), right)
        s = s + _FIRCOEF[j] * (S[:, t + j] + right)
        s2 = s2 + _FIRCOEF[j + 1] * (S[:, t + j + 1] + S[:, t + 21 - j - 1])
    return (s + s2) / f32(2.0)


def _detect_band(band_frames):
    """band_frames [C, F, B] -> transient flags [C, F] (Detect())."""
    c, f, B = band_frames.shape
    filt = _hpf_stream(band_frames.reshape(c, -1), B)
    nshort = B // 16
    blocks = filt.reshape(c, f * nshort, 16)
    # calculateRMS: sequential f32 sum, /n, sqrtf
    acc = np.zeros((c, f * nshort), f32)
    for i in range(16):
        acc = acc + blocks[:, :, i] * blocks[:, :, i]
    rms = np.sqrt(acc / f32(16.0))
    db = np.empty(rms.shape, f32)
    for ci in range(c):
        db[ci] = [f32(19.0 * np.float64(_libm.log10f(float(v))))
                  for v in rms[ci]]
    db = db.reshape(c, f, nshort)
    flags = np.zeros((c, f), bool)
    last = np.zeros((c,), f32)
    # -inf dB blocks (silence) produce NaN differences, whose comparisons
    # are false — the same decisions the reference's floats make
    with np.errstate(invalid="ignore"):
        for fi in range(f):
            prev = last
            tr = np.zeros((c,), bool)
            for i in range(nshort):
                cur = db[:, fi, i]
                tr |= (cur - prev > 16) | (prev - cur > 20)
                prev = cur
            flags[:, fi] = tr
            last = db[:, fi, nshort - 1]
    return flags


# ---------------------------------------------------------------------------
# Forward MDCT with windowing chain (atrac1denc.cpp:69-99)
# ---------------------------------------------------------------------------

def _mdct_band(band, short_flags, band_idx):
    """band [C, F, W] -> specs [C, F, W] in reference order for this band's
    slice of Specs[512] (the caller places them at the band offset)."""
    c, nf, W = band.shape
    buf_sz = 256 if band_idx == 2 else 128
    nshort = 8 if band_idx == 2 else 4
    mdct_long = _MDCT512 if band_idx == 2 else _MDCT256
    win_start = (112 if band_idx == 2 else 48)
    sw = _SINE_WINDOW
    out = np.empty((c, nf, W), f32)
    tail = np.zeros((c, 32), f32)                    # srcBuf[bufSz:bufSz+32]
    for fi in range(nf):
        cur = band[:, fi].copy()                     # srcBuf[0:bufSz]
        shrt = short_flags[:, fi]
        spec_l = np.zeros((c, W), f32)
        spec_s = np.zeros((c, W), f32)
        new_tail = np.empty((c, 32), f32)
        if (~shrt).any():
            tmp = np.zeros((c, 512), f32)
            tmp[:, win_start: win_start + 32] = tail
            curl = cur.copy()
            nt = sw[:32] * curl[:, buf_sz - 32:]
            curl[:, buf_sz - 32:] = sw[31::-1] * curl[:, buf_sz - 32:]
            tmp[:, win_start + 32: win_start + 32 + buf_sz] = curl
            sp = mdct_long(tmp[:, :2 * buf_sz])      # Mdct256/512 reads N
            if band_idx:
                sp = sp[:, ::-1]
            m = ~shrt
            spec_l[m] = sp[m]
            new_tail[m] = nt[m]
        if shrt.any():
            curs = cur.copy()
            prev = tail.copy()
            sps = np.empty((c, W), f32)
            for blk in range(nshort):
                bpos = 32 * blk
                tmp = np.zeros((c, 64), f32)
                tmp[:, :32] = prev
                nt = sw[:32] * curs[:, bpos: bpos + 32]
                curs[:, bpos: bpos + 32] = (sw[31::-1]
                                            * curs[:, bpos: bpos + 32])
                tmp[:, 32:] = curs[:, bpos: bpos + 32]
                sp = _MDCT64(tmp)
                if band_idx == 2:
                    # short-window level compensation (atrac1denc.cpp:78)
                    sp = sp * f32(2.0)
                if band_idx:
                    sp = sp[:, ::-1]
                sps[:, bpos: bpos + 32] = sp
                prev = nt
            m = shrt
            spec_s[m] = sps[m]
            new_tail[m] = nt[m]
        out[:, fi] = np.where(shrt[:, None], spec_s, spec_l)
        tail = new_tail
    return out


# ---------------------------------------------------------------------------
# Scaler (atrac_scale.cpp:139-173) + psy (atrac_psy_common.*)
# ---------------------------------------------------------------------------

_SCALE_TABLE = np.asarray(T.SCALE_TABLE, f32)        # pow(2, i/3 - 21)


def _scale_frame(specs, short_mask):
    """specs [C, 512] -> (sfi [C,52] int, values [C,52,20] f32,
    energy [C,52] f32).  Map::lower_bound = first table key >= maxAbs."""
    c = specs.shape[0]
    sfi = np.zeros((c, 52), np.int32)
    vals = np.zeros((c, 52, 20), f32)
    energy = np.zeros((c, 52), f32)
    b2b = np.asarray(T.BFU_TO_BAND)
    for b in range(52):
        ns = int(T.SPECS_PER_BLOCK[b])
        for ci in range(c):
            start = int(T.SPECS_START_SHORT[b] if short_mask[ci, b2b[b]]
                        else T.SPECS_START_LONG[b])
            blk = specs[ci, start: start + ns]
            mx = f32(0.0)
            for v in np.abs(blk):
                if v > mx:
                    mx = v
            if mx > f32(1.0):
                mx = f32(1.0)
            idx = int(np.searchsorted(_SCALE_TABLE, mx, side="left"))
            sf = _SCALE_TABLE[idx]
            e = f32(0.0)
            for i, v in enumerate(blk):
                sv = f32(v / sf)
                e = f32(e + f32(v * v))
                if abs(sv) >= 1.0:
                    sv = f32(0.99999) if sv > 0 else f32(-0.99999)
                vals[ci, b, i] = sv
            sfi[ci, b] = idx
            energy[ci, b] = e
    return sfi, vals, energy


def _loudness_curve(sz=512):
    """CreateLoudnessCurve (atrac_psy_common.cpp:142-158): log10(float) ->
    log10f, pow in double."""
    res = np.empty(sz, f32)
    for i in range(sz):
        fq = f32(f32(i + 3) * f32(0.5 * 44100.0 / sz))
        # the C expression is float f = (i+3) * 0.5 * 44100 / sz — all
        # float-promoted arithmetic left to right
        fq = f32(f32(f32(f32(i + 3) * f32(0.5)) * f32(44100.0)) / f32(sz))
        t = np.float64(_libm.log10f(float(fq))) - 3.5
        t = f32(t)
        t = f32(f32(f32(-10 * t) * t) + f32(3)) - f32(fq / f32(3000.0))
        res[i] = f32(10.0 ** np.float64(0.1 * np.float64(f32(t))))
    return res


_LOUD_CURVE = _loudness_curve()


def _at1_ath():
    """CalcAt1ATH (atrac1_bitalloc.cpp:118-135) over CalcATH
    (atrac_psy_common.cpp:120-139, Frank formula in double)."""
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

    mf = f32(44100.0 / 2000.0)
    spec = np.empty(512, f32)
    for i in range(512):
        fq = f32(f32(i + 1) * mf / f32(512.0))
        trh = f32(frank(1.0e3 * np.float64(fq)) - 100.0)
        trh = trh - f32(fq * fq) * f32(0.015)
        spec[i] = trh
    ath = np.empty(52, f32)
    for b in range(52):
        start = int(T.SPECS_START_LONG[b])
        x = f32(999.0)
        for line in range(start, start + int(T.SPECS_PER_BLOCK[b])):
            x = min(x, spec[line])
        ath[b] = f32(10.0 ** np.float64(0.1 * np.float64(x)))
    return ath


_AT1_ATH = _at1_ath()

_FIX_LONG = np.asarray([
    7, 7, 7, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
    6, 6, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 4,
    4, 4, 3, 3, 3, 3, 3, 3, 2, 1, 1, 1, 1, 0, 0, 0], f32)
_FIX_SHORT = np.asarray([
    6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
    6, 6, 6, 6, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5,
    4, 4, 4, 4, 4, 4, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0], f32)
_BOOST_MASK = np.asarray([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
    1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.int32)
_BFU_AMOUNT_TAB = np.asarray(T.BFU_AMOUNT_TAB if hasattr(T, "BFU_AMOUNT_TAB")
                             else [20, 28, 32, 36, 40, 44, 48, 52], np.int32)

_SPREAD = f32(0.4)                                   # BitAllocSpread
_BIAS_GAIN = f32(0.3)
_BIAS_TILT_FLOOR = f32(7.0)
_BIAS_MAX = f32(1.5)
_BIAS_HIGH_RATIO = f32(0.5)


def _calc_bits_allocation(sfi, energy, bfu_num, shift, short_mask, loudness):
    """CalcBitsAllocation (atrac1_bitalloc.cpp:163-205) for one channel."""
    b2b = np.asarray(T.BFU_TO_BAND)
    # CalcLowToMidTilt
    sum_low = f32(0.0)
    sum_mid = f32(0.0)
    n_low = n_mid = 0
    for i in range(bfu_num):
        if b2b[i] == 0:
            sum_low = f32(sum_low + f32(sfi[i]))
            n_low += 1
        elif b2b[i] == 1:
            sum_mid = f32(sum_mid + f32(sfi[i]))
            n_mid += 1
    tilt = (f32(f32(sum_low / f32(n_low)) - f32(sum_mid / f32(n_mid)))
            if n_low and n_mid else f32(0.0))
    mid_bias = min(_BIAS_MAX,
                   f32(_BIAS_GAIN * max(f32(0.0),
                                        f32(tilt - _BIAS_TILT_FLOOR))))
    band_bias = [f32(0.0), mid_bias, f32(mid_bias * _BIAS_HIGH_RATIO)]

    bits = np.zeros(bfu_num, np.int64)
    for i in range(bfu_num):
        short_blk = bool(short_mask[b2b[i]])
        fix = _FIX_SHORT[i] if short_blk else _FIX_LONG[i]
        ath = f32(_AT1_ATH[i] * loudness)
        if not short_blk and energy[i] < ath:
            bits[i] = 0
            continue
        tmp_f = (f32(_SPREAD * f32(f32(sfi[i]) / f32(3.2)))
                 + f32(f32(f32(1.0) - _SPREAD) * fix))
        tmp_f = f32(f32(tmp_f - shift) + band_bias[b2b[i]])
        tmp = int(tmp_f)                             # C int cast: trunc
        bits[i] = 16 if tmp > 16 else (0 if tmp < 2 else tmp)
    return bits


def _get_max_used_bfu_id(bits):
    """GetMaxUsedBfuId (atrac1_bitalloc.cpp:207-230)."""
    idx = 7
    while True:
        bfu_num = int(_BFU_AMOUNT_TAB[idx])
        if bfu_num > len(bits):
            idx -= 1
        elif idx != 0:
            i = 0
            while idx and bits[bfu_num - 1 - i] == 0:
                i += 1
                if i >= int(_BFU_AMOUNT_TAB[idx] - _BFU_AMOUNT_TAB[idx - 1]):
                    idx -= 1
                    bfu_num -= i
                    i = 0
            return idx
        else:
            return idx


class _Booster:
    """TBitsBooster (atrac1_bitalloc.cpp:69-114): multimap iteration order =
    ascending (nBits, insertion order)."""

    def __init__(self):
        entries = [(int(T.SPECS_PER_BLOCK[i]), i)
                   for i in range(52) if _BOOST_MASK[i]]
        self.entries = sorted(entries, key=lambda kv: kv[0])
        self.max_bits = self.entries[-1][0]
        self.min_key = self.entries[0][0]

    def apply(self, bits, cur, target):
        surplus = target - cur
        key = min(surplus, self.max_bits)
        upto = [e for e in self.entries if e[0] <= key]
        if not upto:
            return surplus
        while surplus >= self.min_key:
            done = True
            for cur_bits, pos in upto:
                if pos >= len(bits):
                    break
                if bits[pos] == 16:
                    continue
                per_spec = 1 if bits[pos] else 2
                if bits[pos] == 0 and cur_bits * 2 > surplus:
                    continue
                if cur_bits * per_spec > surplus:
                    continue
                bits[pos] += per_spec
                surplus -= cur_bits * per_spec
                done = False
            if done:
                break
        return surplus


_BOOSTER = _Booster()


def _avail_bits(bfu_num):
    return 212 * 8 - 3 - 32 - 2 - 3 - bfu_num * (4 + 6)


def _allocate_channel(sfi, energy, short_mask, loudness, bfu_idx_const=0):
    """TAt1BitAlloc::Write decision chain for one channel-frame.
    Returns (bfu_idx, bits[52])."""
    bfu_idx = bfu_idx_const - 1 if bfu_idx_const else 7
    while True:
        bfu_num = int(_BFU_AMOUNT_TAB[bfu_idx])
        target = _avail_bits(bfu_num)
        min_l, max_l = f32(-3.0), f32(15.0)
        last_l = f32(15.0)
        while True:
            if max_l <= min_l:
                shift = last_l
                final = True
            else:
                shift = f32(f32(max_l + min_l) / f32(2.0))
                final = False
            alloc = _calc_bits_allocation(sfi, energy, bfu_num, shift,
                                          short_mask, loudness)
            used = int(np.sum(np.asarray(T.SPECS_PER_BLOCK[:bfu_num],
                                         np.int64) * alloc))
            if final:
                break
            if used < target:
                last_l = shift
                max_l = f32(shift - f32(0.01))
            elif used > target:
                min_l = f32(shift + f32(0.01))
            else:
                break
        if bfu_idx_const == 0:
            used_id = _get_max_used_bfu_id(alloc)
            if used_id < bfu_idx:
                bfu_idx -= 1
                continue
        bits = list(alloc)
        _BOOSTER.apply(bits, used, target)
        out = np.zeros(52, np.int32)
        out[:bfu_num] = bits
        return bfu_idx, out


# ---------------------------------------------------------------------------
# Top level
# ---------------------------------------------------------------------------

def encode_track_exact(pcm, bfu_idx_const=0, window_mode="auto",
                       window_mask=0):
    """[C, T] float PCM -> AT1 planes, byte-exact to the reference encoder
    when packed by frame.pack.  T is padded to whole frames."""
    pcm = np.atleast_2d(np.asarray(pcm, f32))
    c, t = pcm.shape
    pad = (-t) % 512
    if pad:
        pcm = np.pad(pcm, ((0, 0), (0, pad)))
    nf = pcm.shape[1] // 512

    low, mid, hi = _analysis_tree(pcm)

    if window_mode == "auto":
        inv = np.asarray([1.0, -1.0] * 64, f32)
        fl_low = _detect_band(low)
        fl_mid = _detect_band(mid * inv[None, None, :])
        fl_hi = _detect_band(hi * np.asarray([1.0, -1.0] * 128,
                                             f32)[None, None, :])
        masks = np.stack([fl_low, fl_mid, fl_hi], axis=-1)  # [C, F, 3]
    else:
        masks = np.broadcast_to(
            np.asarray([bool(window_mask & 1), bool(window_mask & 2),
                        bool(window_mask & 4)]), (c, nf, 3)).copy()

    specs = np.concatenate([
        _mdct_band(low, masks[..., 0], 0),
        _mdct_band(mid, masks[..., 1], 1),
        _mdct_band(hi, masks[..., 2], 2)], axis=-1)  # [C, F, 512]

    # loudness (atrac1denc.cpp:236-247): sequential f32 accumulation
    loud_frames = np.zeros((c, nf), f32)
    for i in range(512):
        e = specs[:, :, i] * specs[:, :, i]
        loud_frames = loud_frames + e * _LOUD_CURVE[i]

    wordlen = np.zeros((c, nf, 52), np.int32)
    sfi_all = np.zeros((c, nf, 52), np.int32)
    mant = np.zeros((c, nf, 52, 20), np.int32)
    bfu_idx_out = np.zeros((c, nf), np.int32)
    loudness_state = f32(0.006)
    for fi in range(nf):
        sfi, vals, energy = _scale_frame(specs[:, fi], masks[:, fi])
        m0 = bool(masks[0, fi].any())
        if c == 2 and not m0 and not masks[1, fi].any():
            s = f32(loud_frames[0, fi] + loud_frames[1, fi])
            loudness_state = f32(0.98 * np.float64(loudness_state)
                                 + 0.01 * np.float64(s))
        elif not m0:
            loudness_state = f32(0.98 * np.float64(loudness_state)
                                 + 0.02 * np.float64(loud_frames[0, fi]))
        loud = f32(loudness_state / f32(0.006))
        for ci in range(c):
            bfu_idx, bits = _allocate_channel(
                sfi[ci], energy[ci], masks[ci, fi], loud, bfu_idx_const)
            bfu_num = int(_BFU_AMOUNT_TAB[bfu_idx])
            wordlen[ci, fi] = bits
            sfi_all[ci, fi, :bfu_num] = sfi[ci][:bfu_num]  # wire carries
            bfu_idx_out[ci, fi] = bfu_idx                  # only bfu_num
            for b in range(int(_BFU_AMOUNT_TAB[bfu_idx])):
                wl = int(bits[b])
                if wl in (0, 1):
                    continue
                multiple = f32((1 << (wl - 1)) - 1)
                ns = int(T.SPECS_PER_BLOCK[b])
                mant[ci, fi, b, :ns] = np.rint(
                    vals[ci, b, :ns] * multiple).astype(np.int32)

    return {
        "short_mask": masks,
        "bfu_idx": bfu_idx_out,
        "wordlen": wordlen,
        "sfi": sfi_all,
        "mant": mant,
    }
