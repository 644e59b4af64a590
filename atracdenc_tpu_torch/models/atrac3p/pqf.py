"""ATRAC3+ 16-band PQF analysis as one strided convolution.

Port of ``atracdenc_tpu/models/atrac3p/pqf.py`` (reference
src/atrac/atrac3plus_pqf/atrac3plus_pqf.c:81-106): the 12-tap x 32-phase FIR
and the butterfly + DCT-IV-16 that follows it fold into one [16, 384]
kernel, applied with stride 16 over the whole track; the 368-sample overlap
is left zero padding.  The inverse (``ipqf_np``, ffmpeg semantics) is the
QA decoder's, on the host.
"""
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from atracdenc_tpu_torch import runtime  # noqa: F401  (f32 policy)
from atracdenc_tpu_torch.ops.mdct import _mdct_matrix_np
from . import tables as T

OVERLAP = 368          # PROTO_SZ - SUBBANDS_NUM
# whole-track analysis + synthesis round-trip delay
PQF_DELAY_SAMPLES = 368


@lru_cache(maxsize=None)
def _dct4_16_matrix() -> np.ndarray:
    """[16, 16] M with out = M @ yy matching atde_do_dct4_16 with the PQF's
    scale (mdct.cpp:56-81: TMIDCT<32>(32 * 128*512), out[i] = -x[i+8])."""
    imdct = _mdct_matrix_np(32).T             # [32, 16]
    factor = (32.0 * 128.0 * 512.0) / 32.0
    return -factor * imdct[8:24, :]


@lru_cache(maxsize=None)
def _analysis_kernel() -> np.ndarray:
    """[16, 384] combined kernel: out[sb] = sum_p K[sb, p] * x[p]."""
    fir = np.asarray(T.PQF_FIR, np.float64)
    dct = _dct4_16_matrix()
    # vectoring y[k] = sum_j fir[k*12+j] x[j*32 + k]; butterfly
    # yy[i] = y[i+8] + y[7-i], yy[i+8] = y[i+16] + y[31-i]; out[sb] = res[15-sb]
    b = np.zeros((16, 32))
    for i in range(8):
        b[i, i + 8] = 1.0
        b[i, 7 - i] = 1.0
        b[i + 8, i + 16] = 1.0
        b[i + 8, 31 - i] = 1.0
    m = (dct @ b)[::-1]                       # [16(sb), 32(k)]
    k = np.zeros((16, 384))
    for kk in range(32):
        for j in range(12):
            k[:, j * 32 + kk] += m[:, kk] * fir[kk * 12 + j]
    return np.asarray(k, np.float32)


@lru_cache(maxsize=None)
def _kernel(dtype, dev):
    return torch.as_tensor(_analysis_kernel(), dtype=dtype,
                           device=dev)[:, None, :]


def analysis(pcm, with_history=False):
    """[..., T] PCM (T a multiple of 2048) -> [..., 16, T/16] band samples.

    Output sample i of band sb uses input [i*16 - 368, i*16 + 16), zeros
    before the track.  ``with_history=True``: the input carries its own
    OVERLAP samples of filter history as a prefix (chunked encoding); no
    padding is added and the output covers the samples after it."""
    batch = pcm.shape[:-1]
    t = pcm.shape[-1] - (OVERLAP if with_history else 0)
    x = pcm.reshape(-1, 1, pcm.shape[-1])
    if not with_history:
        x = F.pad(x, (OVERLAP, 0))
    out = F.conv1d(x, _kernel(pcm.dtype, pcm.device), stride=16)
    return out.reshape(batch + (16, t // 16))


def ipqf_np(bands: np.ndarray) -> np.ndarray:
    """QA inverse PQF (ffmpeg ff_atrac3p_ipqf semantics), numpy.

    bands: [16, M] band samples -> [16*M] PCM.  The JAX package's loop over
    the 24-slot ring (ut/atrac3plusdsp.c:57-96) vectorised over samples:
    at sample s, tap t reads the DCT outputs of samples s - 2t (first ring)
    and s - 1 - 2t (second ring), zero before the track; the float64 sums
    run in the loop's order, so the output is the same to the bit."""
    nsb, m = bands.shape
    n_i = np.arange(16)
    dct = np.cos(np.pi / 16.0 * np.outer(n_i + 0.5, n_i + 0.5)) / 1024.0
    idct = (bands.T @ dct)[:, ::-1]           # [M, 16]
    pad = 24
    b1 = np.zeros((m + pad, 8), np.float32)
    b2 = np.zeros((m + pad, 8), np.float32)
    b1[pad:] = idct[:, 8:16]
    b2[pad:] = idct[:, 7::-1]
    c1 = np.asarray(T.IPQF_COEFFS1, np.float64)
    c2 = np.asarray(T.IPQF_COEFFS2, np.float64)
    acc = np.zeros((m, 16))
    for t_ in range(12):
        r1 = b1[pad - 2 * t_: pad - 2 * t_ + m]
        r2 = b2[pad - 1 - 2 * t_: pad - 1 - 2 * t_ + m]
        acc[:, :8] += r1 * c1[t_, :8] + r2 * c2[t_, :8]
        acc[:, 8:] += r1[:, ::-1] * c1[t_, 8:] + r2[:, ::-1] * c2[t_, 8:]
    return acc.astype(np.float32).reshape(-1)
