"""ATRAC1 three-band analysis / synthesis filterbank over a whole track.

Port of ``atracdenc_tpu/models/atrac1/filterbank.py`` (reference
src/atrac/at1/atrac1_qmf.h:25-64): a tree of two QMF stages,
  512 PCM -> QMF1 -> (midlow 256, hi 256); hi delayed 39 band samples
  midlow  -> QMF2 -> (low 128, mid 128)
as whole-track filters (``ops/qmf.py``); the 39-sample delay line is a
static shift.
"""
import torch

from atracdenc_tpu_torch.ops.qmf import qmf_analysis, qmf_synthesis

DELAY_COMP = 39  # hi-band alignment delay, in band samples (atrac1_qmf.h:27)


def _delay(x, n):
    """Delay the last axis by n samples, zero-filled (causal)."""
    return torch.nn.functional.pad(x, (n, 0))[..., :x.shape[-1]]


def analysis(pcm):
    """[..., T] PCM -> (low [..., T/4], mid [..., T/4], hi [..., T/2])."""
    midlow, hi = qmf_analysis(pcm)
    low, mid = qmf_analysis(midlow)
    return low, mid, _delay(hi, DELAY_COMP)


def synthesis(low, mid, hi):
    """(low, mid, hi) -> [..., T] PCM (delays mirror the analysis tree)."""
    return qmf_synthesis(qmf_synthesis(low, mid), _delay(hi, DELAY_COMP))
