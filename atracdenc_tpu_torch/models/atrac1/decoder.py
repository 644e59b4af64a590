"""ATRAC1 decoder: frame planes -> PCM, batched.

Port of ``atracdenc_tpu/models/atrac1/decoder.py`` (reference decode path
src/atrac1denc.cpp:139-177): dequantise -> windowed IMDCT with overlap-add
-> QMF synthesis -> clip to [-1, 1].  Malformed frames arrive from the
parser (``frame.unpack``) as silent planes in the neutral long window
mode, which keeps the overlap and QMF state as the reference does.
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch.models.atrac1 import exact_synth as at1_exact_synth
from atracdenc_tpu_torch.models.atrac1 import tables as T
from atracdenc_tpu_torch import runtime
from . import filterbank
from .mdct import imdct_frames


@functools.lru_cache(maxsize=None)
def _consts(dev):
    return {"scale": torch.as_tensor(T.SCALE_TABLE, device=dev),
            "mask": torch.as_tensor(T.GATHER_MASK, device=dev),
            "band": torch.as_tensor(T.BFU_TO_BAND, device=dev).long()}


def _assemble(v, start_tab):
    """[..., 52, 20] BFU blocks -> [..., 512] spectrum of one line layout
    (each BFU's lines are a contiguous run; sorted by start they tile the
    spectrum)."""
    order = np.argsort(np.asarray(start_tab)[:, 0], kind="stable")
    return torch.cat([v[..., b, :int(T.SPECS_PER_BLOCK[b])] for b in order],
                     dim=-1)


def decode_frames(short_mask, wordlen, sfi, mant):
    """Planes -> PCM [..., C, F*512]: short_mask [..., C, F, 3] bool,
    wordlen / sfi [..., C, F, 52], mant [..., C, F, 52, 20]."""
    k = _consts(mant.device)
    lead = wordlen.shape[:-2]
    wl = wordlen.to(torch.int32)
    # dequantise (atrac1_dequantiser.cpp:31-68)
    max_quant = 1.0 / ((1 << (torch.clamp(wl, min=2) - 1)) - 1).to(torch.float32)
    vals = (k["scale"][sfi.long()] * max_quant)[..., None] * mant.to(torch.float32)
    vals = torch.where((wl >= 2)[..., None], vals, 0.0) * k["mask"]

    short_per_bfu = short_mask.bool()[..., k["band"]]          # [..., 52]
    specs = (_assemble(torch.where(short_per_bfu[..., None], 0.0, vals),
                       T.GATHER_LONG)
             + _assemble(torch.where(short_per_bfu[..., None], vals, 0.0),
                         T.GATHER_SHORT))
    sm = short_mask.bool()
    low = imdct_frames(specs[..., 0:128], sm[..., 0], 0).reshape(lead + (-1,))
    mid = imdct_frames(specs[..., 128:256], sm[..., 1], 1).reshape(lead + (-1,))
    hi = imdct_frames(specs[..., 256:512], sm[..., 2], 2).reshape(lead + (-1,))
    return torch.clamp(filterbank.synthesis(low, mid, hi), -1.0, 1.0)


def decode_track(planes, exact=True, device=None):
    """Planes [C, F, ...] (numpy) -> PCM [C, F*512] float32 numpy.

    exact=True (the default, and what the CLI uses) runs the float32
    reference-semantics path ``exact_synth.decode_track_exact``, equal to
    the reference decoder sample for sample.  exact=False runs
    ``decode_frames`` on ``device`` ("cuda" by default, or "cpu")."""
    if exact:
        return at1_exact_synth.decode_track_exact(planes)
    dev = runtime.device(device)
    return runtime.to_numpy(decode_frames(
        *(runtime.to_torch(planes[key], dev)
          for key in ("short_mask", "wordlen", "sfi", "mant"))))
