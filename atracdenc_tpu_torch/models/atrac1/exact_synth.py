"""Bit-exact ATRAC1 synthesis (reference float32 semantics).

Replicates, operation-for-operation in IEEE float32, the reference decoder's
float path:

  * dequantisation          (reference: src/atrac/at1/atrac1_dequantiser.cpp:31-68)
  * TMIDCT pre/post-twiddle (reference: src/lib/mdct/mdct.h:107-180, mdct.cpp:25-37)
  * kissfft forward FFT     (reference: src/lib/fft/kissfft_impl/kiss_fft.c)
  * vector_fmul_window + overlap bookkeeping (reference: src/atrac1denc.cpp:51-68,103-139)
  * two-stage QMF synthesis tree (reference: src/qmf/qmf.h:66-89,
    src/atrac/at1/atrac1_qmf.h:46-64, src/qmf/qmf.cpp:25-45)

The reference oracle builds with -O2 and no -march flags: scalar SSE2 float,
one rounding per operation, no FMA contraction — which NumPy float32
elementwise arithmetic reproduces exactly.  Everything that has no
cross-frame state (dequant, MIDCT) is batched over [channels, frames];
the stateful tails (16-float window chains, QMF tap sums) vectorize over
the whole track with the per-sample accumulation order preserved.

This is the decoder's verification-grade path (BASELINE "bit-exact QMF
synthesis"); the JAX path in decoder.py is the batched/TPU formulation of
the same math and is cross-checked against this one to float tolerance.
"""
import ctypes
import ctypes.util

import numpy as np

from . import tables as T

f32 = np.float32

__all__ = ["decode_track_exact"]

# The reference's tables are built with glibc's double cos/sin, whose
# results can differ from NumPy's SIMD trig by 1 ulp (double) — enough to
# flip the float32 table entry on rounding-boundary arguments.  Call the
# exact same libm.
_libm = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
_libm.cos.restype = ctypes.c_double
_libm.cos.argtypes = [ctypes.c_double]
_libm.sin.restype = ctypes.c_double
_libm.sin.argtypes = [ctypes.c_double]
_libm.cosf.restype = ctypes.c_float
_libm.cosf.argtypes = [ctypes.c_float]
_libm.sinf.restype = ctypes.c_float
_libm.sinf.argtypes = [ctypes.c_float]


def _libm_cos(x):
    return np.asarray([_libm.cos(float(v)) for v in np.atleast_1d(x)],
                      np.float64)


def _libm_sin(x):
    return np.asarray([_libm.sin(float(v)) for v in np.atleast_1d(x)],
                      np.float64)


def _libm_cosf(x):
    return np.asarray([_libm.cosf(float(v)) for v in np.atleast_1d(x)], f32)


def _libm_sinf(x):
    return np.asarray([_libm.sinf(float(v)) for v in np.atleast_1d(x)], f32)


# ---------------------------------------------------------------------------
# kissfft (forward, float32) — exact dataflow replication
# ---------------------------------------------------------------------------

def _kf_factor(n):
    """kiss_fft.c:309-331 — radix list (4s first, then 2, 3, primes)."""
    facs = []
    p = 4
    floor_sqrt = int(np.floor(np.sqrt(float(n))))
    while True:
        while n % p:
            p = {4: 2, 2: 3}.get(p, p + 2)
            if p > floor_sqrt:
                p = n
        n //= p
        facs += [p, n]
        if n <= 1:
            return facs


def _kf_perm(n, facs):
    """Input index permutation of the kf_work recursion (kiss_fft.c:238-303).

    The recursion's only effect on INPUT ordering is this permutation; the
    butterflies then run bottom-up on contiguous segments.
    """
    res = np.empty(n, np.int64)

    def work(out_off, f_off, fstride, fpos):
        p, m = facs[fpos], facs[fpos + 1]
        if m == 1:
            for j in range(p):
                res[out_off + j] = f_off + j * fstride
        else:
            for k in range(p):
                work(out_off + k * m, f_off + k * fstride, fstride * p,
                     fpos + 2)

    work(0, 0, 1, 0)
    return res


class _KissFFT:
    """Complex FFT, bit-exact to kiss_fft (scalar float build); forward or
    inverse per kiss_fft_alloc's `inverse_fft`."""

    def __init__(self, n, inverse=False):
        self.n = n
        self.inverse = inverse
        i = np.arange(n, dtype=np.float64)
        phase = -2.0 * np.pi * i / n          # kiss_fft.c:358-362 (double)
        if inverse:
            phase = -phase
        self.twr = _libm_cos(phase).astype(f32)
        self.twi = _libm_sin(phase).astype(f32)
        facs = _kf_factor(n)
        self.perm = _kf_perm(n, facs)
        stages = []                           # (p, m, fstride), top-down
        fstride = 1
        for pos in range(0, len(facs), 2):
            stages.append((facs[pos], facs[pos + 1], fstride))
            fstride *= facs[pos]
        self.stages = stages[::-1]            # butterflies run bottom-up

    def __call__(self, xr, xi):
        """xr, xi: [..., n] float32 -> (yr, yi) float32."""
        xr = np.ascontiguousarray(xr[..., self.perm])
        xi = np.ascontiguousarray(xi[..., self.perm])
        lead = xr.shape[:-1]
        for p, m, fstride in self.stages:
            blocks = self.n // (p * m)
            Fr = xr.reshape(lead + (blocks, p, m))
            Fi = xi.reshape(lead + (blocks, p, m))
            k = np.arange(m)
            if p == 4:
                # kf_bfly4, forward branch (kiss_fft.c:44-90)
                t1r, t1i = _cmul(Fr[..., 1, :], Fi[..., 1, :],
                                 self.twr[k * fstride], self.twi[k * fstride])
                t2r, t2i = _cmul(Fr[..., 2, :], Fi[..., 2, :],
                                 self.twr[k * fstride * 2],
                                 self.twi[k * fstride * 2])
                t3r, t3i = _cmul(Fr[..., 3, :], Fi[..., 3, :],
                                 self.twr[k * fstride * 3],
                                 self.twi[k * fstride * 3])
                f0r, f0i = Fr[..., 0, :], Fi[..., 0, :]
                s5r = f0r - t2r
                s5i = f0i - t2i
                f0r = f0r + t2r
                f0i = f0i + t2i
                s3r = t1r + t3r
                s3i = t1i + t3i
                s4r = t1r - t3r
                s4i = t1i - t3i
                Fr[..., 2, :] = f0r - s3r
                Fi[..., 2, :] = f0i - s3i
                Fr[..., 0, :] = f0r + s3r
                Fi[..., 0, :] = f0i + s3i
                if self.inverse:              # kiss_fft.c:77-81
                    Fr[..., 1, :] = s5r - s4i
                    Fi[..., 1, :] = s5i + s4r
                    Fr[..., 3, :] = s5r + s4i
                    Fi[..., 3, :] = s5i - s4r
                else:
                    Fr[..., 1, :] = s5r + s4i
                    Fi[..., 1, :] = s5i - s4r
                    Fr[..., 3, :] = s5r - s4i
                    Fi[..., 3, :] = s5i + s4r
            elif p == 2:
                # kf_bfly2 (kiss_fft.c:21-42)
                tr, ti = _cmul(Fr[..., 1, :], Fi[..., 1, :],
                               self.twr[k * fstride], self.twi[k * fstride])
                f0r, f0i = Fr[..., 0, :], Fi[..., 0, :]
                Fr[..., 1, :] = f0r - tr
                Fi[..., 1, :] = f0i - ti
                Fr[..., 0, :] = f0r + tr
                Fi[..., 0, :] = f0i + ti
            else:                             # pragma: no cover
                raise NotImplementedError(f"radix {p}")
        return xr, xi


def _cmul(ar, ai, br, bi):
    """C_MUL: one f32 rounding per multiply/add (_kiss_fft_guts.h)."""
    return ar * br - ai * bi, ar * bi + ai * br


# ---------------------------------------------------------------------------
# TMIDCT<N> — pre-twiddle, FFT(N/4), post-twiddle (mdct.h:107-180)
# ---------------------------------------------------------------------------

class _MIDCT:
    def __init__(self, N, scale):
        # decoder instances: Midct512(1024), Midct256(512), Midct64(128)
        # (atrac1denc.h:52-54) -> TMDCTBase(N, scale/2); CalcSinCos
        # computes in float alpha/omiga, double cos/sin (mdct.cpp:25-37)
        self.N = N
        base_scale = scale / 2.0
        n4 = N // 4
        alpha = f32(2.0 * np.pi / (8.0 * N))
        omiga = f32(2.0 * np.pi / N)
        s = np.sqrt(base_scale / N)           # double
        args = (omiga * np.arange(N // 4, dtype=np.int64).astype(f32)
                + alpha)                      # float, one rounding per op
        # C++ overload resolution gives cos(float) = cosf here
        # (mdct.cpp:30-36 with a float argument)
        sf = f32(s)
        self.cos = sf * _libm_cosf(args)
        self.sin = sf * _libm_sinf(args)
        assert self.cos.shape[0] == n4
        self.fft = _KissFFT(n4)

    def __call__(self, spec):
        """spec [..., N/2] float32 -> [..., N] float32 (mdct.h:115-178)."""
        N = self.N
        n2, n4 = N // 2, N // 4
        n34, n54 = 3 * n4, 5 * n4
        k = np.arange(n4)
        r0 = spec[..., 2 * k]
        i0 = spec[..., n2 - 1 - 2 * k]
        c, s = self.cos, self.sin
        # xr = -2.0*(i0*s + r0*c): inner sum in f32, double *2 is exact
        xr = -((i0 * s + r0 * c) * f32(2.0))
        xi = -((i0 * c - r0 * s) * f32(2.0))
        yr, yi = self.fft(xr, xi)
        r1 = yr * c + yi * s
        i1 = yr * s - yi * c
        buf = np.empty(spec.shape[:-1] + (N,), f32)
        n = 2 * k[: n4 // 2]                  # first post loop (n < n4)
        ra, ia = r1[..., : n4 // 2], i1[..., : n4 // 2]
        buf[..., n34 - 1 - n] = ra
        buf[..., n34 + n] = ra
        buf[..., n4 + n] = ia
        buf[..., n4 - 1 - n] = -ia
        n = 2 * k[n4 // 2:]                   # second post loop (n >= n4)
        rb, ib = r1[..., n4 // 2:], i1[..., n4 // 2:]
        buf[..., n34 - 1 - n] = rb
        buf[..., n - n4] = -rb
        buf[..., n4 + n] = ib
        buf[..., n54 - 1 - n] = ib
        return buf


_MIDCT64 = _MIDCT(64, 128.0)
_MIDCT256 = _MIDCT(256, 512.0)
_MIDCT512 = _MIDCT(512, 1024.0)


# ---------------------------------------------------------------------------
# dequant — specs[512] in reference order (atrac1_dequantiser.cpp:31-68)
# ---------------------------------------------------------------------------

def _dequant(short_mask, wordlen, sfi, mant):
    """[C,F,...] planes -> specs [C, F, 512] float32, exact."""
    scale_tab = np.asarray(T.SCALE_TABLE, f32)
    wl = np.asarray(wordlen, np.int64)
    denom = ((1 << np.maximum(wl, 1) - 1) - 1).astype(f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        maxq = (np.float64(1.0) / denom).astype(f32)  # double div -> float
        factor = scale_tab[np.asarray(sfi)] * maxq    # f32 * f32
        vals = factor[..., None] * np.asarray(mant, f32)  # * MakeSign value
    vals = np.where((wl >= 2)[..., None], vals, f32(0.0))

    c, f, nbfu = wl.shape
    specs = np.zeros((c, f, 512), f32)
    start_long = np.asarray(T.SPECS_START_LONG)
    start_short = np.asarray(T.SPECS_START_SHORT)
    bfu_band = np.asarray(T.BFU_TO_BAND)
    sm = np.asarray(short_mask)
    for b in range(nbfu):
        ns = int(T.SPECS_PER_BLOCK[b])
        shrt = sm[:, :, bfu_band[b]]
        start = np.where(shrt, start_short[b], start_long[b])
        # starts differ per (c, f); scatter per-BFU contiguous runs
        for off in (int(start_long[b]), int(start_short[b])):
            m = start == off
            if m.any():
                specs[:, :, off: off + ns] = np.where(
                    m[..., None], vals[:, :, b, :ns],
                    specs[:, :, off: off + ns])
    return specs


# ---------------------------------------------------------------------------
# IMDCT + overlap bookkeeping (atrac1denc.cpp:51-68, 103-139)
# ---------------------------------------------------------------------------

_SINE_WINDOW = _libm_sin(
    (np.arange(32, dtype=np.float64) + 0.5) * (np.pi / 64.0)).astype(f32)


def _fmul_window(prev, inv16, win=_SINE_WINDOW):
    """vector_fmul_window(dst, src0=prev, src1=inv16, win, len=16):
    dst[0..32) from prev[0..16) and inv16[0..16) (atrac1denc.cpp:51-68)."""
    s0 = prev                                  # src0[i], i = -16..-1 -> 0..15
    s1 = inv16[..., ::-1]                      # src1[j], j = 15..0
    wi = win[:16]
    wj = win[16:32][::-1]
    dst = np.empty(prev.shape[:-1] + (32,), f32)
    dst[..., :16] = s0 * wj - s1 * wi
    dst[..., 16:] = (s0 * wi + s1 * wj)[..., ::-1]
    return dst


def _imdct_band(specs_band, short_flags, band):
    """One band over the whole track: specs_band [C, F, W] (W=128 or 256),
    short_flags [C, F] bool -> per-frame QMF inputs [C, F, W].

    Replicates TAtrac1MDCT::IMdct including the persistent dstBuf tails.
    MIDCTs are batched up front (stateless); the 16-float window chains run
    frame-sequentially.
    """
    c, nf, W = specs_band.shape
    buf_sz = 256 if band == 2 else 128
    nshort = 8 if band == 2 else 4
    assert W == buf_sz

    sp = specs_band
    if band:
        # SwapArray per block before the MIDCT (atrac1denc.cpp:117-119)
        long_sw = sp[..., ::-1]
        short_sw = sp.reshape(c, nf, nshort, 32)[..., ::-1].reshape(c, nf, W)
        sp = np.where(short_flags[..., None], short_sw, long_sw)
    else:
        long_sw = sp
        short_sw = sp
        sp = np.where(short_flags[..., None], short_sw, long_sw)

    # batched MIDCTs for both modes (only the needed lanes are read later)
    midct_long = _MIDCT512 if band == 2 else _MIDCT256
    inv_long = midct_long(sp)                       # [C, F, 2W]
    inv_short = _MIDCT64(sp.reshape(c, nf, nshort, 32))  # [C, F, nb, 64]

    out = np.empty((c, nf, W), f32)
    tail = np.zeros((c, 16), f32)                   # dstBuf[bufSz*2-16 ..)
    # the reference memcpy writes 112/240 entries from dstBuf[32] on, but
    # the QMF reads only dstBuf[0..W) — the overrun region is never read
    ncopy = W - 32
    for fidx in range(nf):
        shrt = short_flags[:, fidx]                 # [C]
        inv_buf = np.zeros((c, 512), f32)
        frame_out = np.zeros((c, W), f32)
        # long lanes
        if (~shrt).any():
            il = inv_long[:, fidx]                  # [C, 2W]
            inv_buf_l = np.zeros((c, 512), f32)
            inv_buf_l[:, :buf_sz] = il[:, buf_sz // 2: buf_sz // 2 + buf_sz]
            dst = _fmul_window(tail, inv_buf_l[:, :16])
            fo = np.zeros((c, W), f32)
            fo[:, :32] = dst
            fo[:, 32:] = inv_buf_l[:, 16: 16 + ncopy]
            m = ~shrt
            frame_out[m] = fo[m]
            inv_buf[m] = inv_buf_l[m]
        # short lanes
        if shrt.any():
            isv = inv_short[:, fidx]                # [C, nshort, 64]
            inv_buf_s = np.zeros((c, 512), f32)
            inv_buf_s[:, : 32 * nshort] = isv[:, :, 16: 48].reshape(c, -1)
            fo = np.zeros((c, W), f32)
            prev = tail
            for blk in range(nshort):
                st = 32 * blk
                fo[:, st: st + 32] = _fmul_window(prev,
                                                  inv_buf_s[:, st: st + 16])
                prev = inv_buf_s[:, st + 16: st + 32]
            m = shrt
            frame_out[m] = fo[m]
            inv_buf[m] = inv_buf_s[m]
        out[:, fidx] = frame_out
        tail = inv_buf[:, buf_sz - 16: buf_sz].copy()
    return out


# ---------------------------------------------------------------------------
# QMF synthesis tree (qmf/qmf.h:66-89, atrac1_qmf.h:54-63)
# ---------------------------------------------------------------------------

_QMF_WINDOW = np.zeros(48, f32)
_TAP_HALF = np.asarray([
    -0.00001461907, -0.00009205479, -0.000056157569, 0.00030117269,
    0.0002422519, -0.00085293897, -0.0005205574, 0.0020340169,
    0.00078333891, -0.0042153862, -0.00075614988, 0.0078402944,
    -0.000061169922, -0.01344162, 0.0024626821, 0.021736089,
    -0.007801671, -0.034090221, 0.01880949, 0.054326009,
    -0.043596379, -0.099384367, 0.13207909, 0.46424159], np.float64)
_QMF_WINDOW[:24] = (_TAP_HALF * 2.0).astype(f32)
_QMF_WINDOW[24:] = _QMF_WINDOW[:24][::-1]


def _qmf_synthesis_stream(lower, upper):
    """TQmf::Synthesis over a whole track.

    lower/upper: [C, total/2] band streams -> [C, total] merged output.
    The per-instance PcmBufferMerge shift-by-nIn makes the merge buffer a
    continuous stream; the j-loop tap sums vectorize across all outputs
    with the i-accumulation order kept sequential.
    """
    c, half = lower.shape
    total = 2 * half
    merged = np.zeros((c, 46 + total), f32)
    # newPart butterfly (qmf.h:68-74)
    mp = merged[:, 46:].reshape(c, half, 2)
    mp[..., 0] = lower + upper
    mp[..., 1] = lower - upper

    win = _QMF_WINDOW
    # out[2j+1] = s1 = sum_i even winP[i]*win[i]; out[2j] = s2 = odd taps
    s1 = np.zeros((c, half), f32)
    s2 = np.zeros((c, half), f32)
    base = 2 * np.arange(half)
    for i in range(0, 48, 2):
        s1 = s1 + merged[:, base + i] * win[i]
        s2 = s2 + merged[:, base + i + 1] * win[i + 1]
    out = np.empty((c, total), f32)
    out[:, 0::2] = s2
    out[:, 1::2] = s1
    return out


def decode_track_exact(planes) -> np.ndarray:
    """Planes -> PCM [C, F*512] float32, bit-exact to the reference decoder.

    planes: dict with short_mask [C,F,3], wordlen/sfi [C,F,52],
    mant [C,F,52,20] (as produced by frame.unpack + channel split).
    """
    specs = _dequant(planes["short_mask"], planes["wordlen"],
                     planes["sfi"], planes["mant"])
    sm = np.asarray(planes["short_mask"], bool)
    c, nf, _ = specs.shape

    low = _imdct_band(specs[..., 0:128], sm[..., 0], 0)    # [C, F, 128]
    mid = _imdct_band(specs[..., 128:256], sm[..., 1], 1)  # [C, F, 128]
    hi = _imdct_band(specs[..., 256:512], sm[..., 2], 2)   # [C, F, 256]

    low_s = low.reshape(c, -1)
    mid_s = mid.reshape(c, -1)
    hi_s = hi.reshape(c, -1)
    # hi delay line: DelayBuf keeps the previous frame's last 39 samples
    # in front (atrac1_qmf.h:58-62) == a continuous 39-sample delay
    hi_d = np.concatenate([np.zeros((c, 39), f32), hi_s[:, :-39]], axis=1)

    mid_low = _qmf_synthesis_stream(low_s, mid_s)          # [C, F*256]
    pcm = _qmf_synthesis_stream(mid_low, hi_d)             # [C, F*512]
    # clip (atrac1denc.cpp:168-172)
    return np.clip(pcm, f32(-1.0), f32(1.0))
