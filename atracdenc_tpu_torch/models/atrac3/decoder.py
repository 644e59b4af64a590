"""ATRAC3 QA decoder: port of ``atracdenc_tpu/models/atrac3/decoder.py``.

Inverts the encode pipeline: parse frames and dequantize mantissas and
tonal components on the host (numpy, as in the JAX package), then the IMDCT
with gain demodulation, the optional M/S un-matrixing and the QMF synthesis
on the device (CUDA unless the caller asks for the CPU).
"""
import numpy as np
import torch

from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.models.atrac3 import filterbank
from atracdenc_tpu_torch.models.atrac3 import frame as at3_frame
from atracdenc_tpu_torch.models.atrac3 import tables as T
from atracdenc_tpu_torch.models.atrac3.mdct import (first_level_scale,
                                                    gain_divisors, imdct_frames)

# one-frame MDCT OLA latency (1024) + analysis+synthesis delay of the
# three-QMF tree (46 + 2*46 = 138)
_DELAY = 1024 + 138


def dequantize(parsed_channels):
    """List over frames of per-channel parse dicts -> specs [C, F, 1024]."""
    f = len(parsed_channels)
    c = len(parsed_channels[0])
    specs = np.zeros((c, f, 1024), np.float32)
    gain_np = np.zeros((c, f, 4), np.int32)
    gain_lev = np.zeros((c, f, 4, 8), np.int32)
    gain_loc = np.zeros((c, f, 4, 8), np.int32)
    for fi, chans in enumerate(parsed_channels):
        for ci, r in enumerate(chans):
            wl = r["wordlen"]
            for i in range(r["num_bfu"]):
                if not wl[i]:
                    continue
                mul = T.MAX_QUANT[wl[i]]
                sf = T.SCALE_TABLE[r["sfi"][i]]
                s, n = T.SPECS_START[i], T.SPECS_PER_BLOCK[i]
                specs[ci, fi, s:s + n] = r["mant"][i, :n] / mul * sf
            for tc in r["tonal"]:
                # quant < 2 cannot come from the encoder (clamped 2..7) but
                # corrupt input can parse to 0 -> MAX_QUANT 0: treat the
                # block as silent instead of dividing by zero
                mul = T.MAX_QUANT[tc["quant"]]
                if not mul:
                    continue
                sf = T.SCALE_TABLE[tc["sfi"]]
                pos = tc["pos"]
                vals = np.asarray(tc["mant"], np.float32) / mul * sf
                specs[ci, fi, pos:pos + len(vals)] = vals
            for b, pts in enumerate(r["gain"]):
                gain_np[ci, fi, b] = len(pts)
                for pi, (lev, loc) in enumerate(pts):
                    gain_lev[ci, fi, b, pi] = lev
                    gain_loc[ci, fi, b, pi] = loc
    return specs, gain_np, gain_lev, gain_loc


def decode_frames(specs, gain_np, gain_lev, gain_loc, js=False, device=None):
    """[C, F, 1024] specs (numpy) -> [C, T] PCM (numpy, delay-compensated).

    The transforms run on ``runtime.device(device)``; ``C`` may hold several
    independent streams' channels when ``js`` is off."""
    dev = runtime.device(device)
    lev = runtime.to_torch(gain_lev, dev)
    npts = runtime.to_torch(gain_np, dev)
    div = gain_divisors(lev, runtime.to_torch(gain_loc, dev), npts)
    scale = first_level_scale(lev, npts)
    bands = imdct_frames(runtime.to_torch(specs, dev), div=div, scale=scale)
    c, f = specs.shape[:2]
    band_sig = bands.transpose(1, 2).reshape(c, 4, f * 256)
    if js:
        m, s = band_sig[0], band_sig[1]
        band_sig = torch.stack([m + s, m - s])
    # each QMF analysis+synthesis stage carries an inherent x2; the two-stage
    # tree's x4 exactly cancels the encoder's /4 input scaling
    pcm = runtime.to_numpy(filterbank.synthesis(band_sig))[..., _DELAY:]
    # corrupt input can smuggle non-finite values through the transforms;
    # the int16 writer must never see them (non-finite becomes silence)
    return np.clip(np.nan_to_num(pcm, nan=0.0, posinf=1.0, neginf=-1.0),
                   -1.0, 1.0)


def decode_track(frames, channels=2, js=False, device=None):
    """[N, frame_bytes] frames -> [C, T] PCM."""
    parsed = at3_frame.unpack(frames, channels, js=js)
    specs, gnp, glev, gloc = dequantize(parsed)
    return decode_frames(specs, gnp, glev, gloc, js=js, device=device)
