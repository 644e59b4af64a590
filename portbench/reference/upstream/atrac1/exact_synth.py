"""Bit-exact float32 building blocks of the reference's ATRAC1 code: the
kissfft forward FFT (src/lib/fft/kissfft_impl/kiss_fft.c), glibc libm
bindings, and the sine and QMF window tables.

The reference oracle builds with -O2 and no -march flags: scalar SSE2 float,
one rounding per operation, no FMA contraction — which NumPy float32
elementwise arithmetic reproduces exactly.

The ATRAC1 and ATRAC3 encoders here take their FFT and libm bindings
from this module (the decoder's synthesis, which the original module also
holds, is left out).
"""
import ctypes
import ctypes.util

import numpy as np


f32 = np.float32


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
# window tables (atrac1denc.cpp:51-68; qmf/qmf.h, atrac1_qmf.h)
# ---------------------------------------------------------------------------

_SINE_WINDOW = _libm_sin(
    (np.arange(32, dtype=np.float64) + 0.5) * (np.pi / 64.0)).astype(f32)


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


