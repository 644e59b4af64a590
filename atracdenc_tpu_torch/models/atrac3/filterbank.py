"""ATRAC3 four-band analysis filterbank (``atracdenc_tpu/models/atrac3/
filterbank.py``): a tree of three QMF stages (reference
src/atrac/at3/atrac3_qmf.h:24-42), note the band-order flip of the upper
stage."""
import torch

from atracdenc_tpu_torch.ops.qmf import qmf_analysis


def analysis(pcm):
    """[..., T] PCM -> [..., 4, T/4] band samples (T multiple of 1024)."""
    lower, upper = qmf_analysis(pcm)
    s0, s1 = qmf_analysis(lower)
    s3, s2 = qmf_analysis(upper)
    return torch.stack([s0, s1, s2, s3], dim=-2)
