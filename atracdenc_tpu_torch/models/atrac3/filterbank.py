"""ATRAC3 four-band analysis / synthesis filterbank
(``atracdenc_tpu/models/atrac3/filterbank.py``): a tree of three QMF stages
(reference src/atrac/at3/atrac3_qmf.h:24-42), note the band-order flip of
the upper stage.  The synthesis bank serves the QA decoder."""
import torch

from atracdenc_tpu_torch.ops.qmf import qmf_analysis, qmf_synthesis


def analysis(pcm):
    """[..., T] PCM -> [..., 4, T/4] band samples (T multiple of 1024)."""
    lower, upper = qmf_analysis(pcm)
    s0, s1 = qmf_analysis(lower)
    s3, s2 = qmf_analysis(upper)
    return torch.stack([s0, s1, s2, s3], dim=-2)


def synthesis(bands):
    """[..., 4, M] band samples -> [..., 4M] PCM, delayed 3 * 46 = 138
    samples against the analysis input."""
    lower = qmf_synthesis(bands[..., 0, :], bands[..., 1, :])
    upper = qmf_synthesis(bands[..., 3, :], bands[..., 2, :])
    return qmf_synthesis(lower, upper)
