"""ATRAC3+ QA decoder: port of ``atracdenc_tpu/models/atrac3p/decoder.py``
(the reference has no ATRAC3+ decoder).

Parse and dequantise the frames on the host (numpy ``unpack_frame``, as the
JAX package does), then the per-subband IMDCT and the GHA tone synthesis on
the device (CUDA unless the caller asks for the CPU), and the inverse PQF
on the host.
"""
import numpy as np

from atracdenc_tpu_torch import runtime
from . import tables as T
from . import frame as at3p_frame
from . import pqf
from . import gha
from .mdct import imdct_frames

# one-frame encoder look-ahead + one-frame MDCT OLA latency + PQF delay
DELAY = 2 * T.NUM_SAMPLES + pqf.PQF_DELAY_SAMPLES


def dequantize(frames: np.ndarray, channels: int):
    """[N, 2048] frames -> (specs [C, N, 2048] f32, tones or None): the host
    parse and dequantisation.  tones: the wire planes (freq / amp_sf /
    phase / valid [C, N, 8, 15], env_start / env_stop [C, N, 8]) when any
    frame carries a tonal block."""
    n = frames.shape[0]
    specs = np.zeros((channels, n, 2048), np.float32)
    tones = {"freq": np.zeros((channels, n, 8, 15), np.int32),
             "amp_sf": np.zeros((channels, n, 8, 15), np.int32),
             "phase": np.zeros((channels, n, 8, 15), np.int32),
             "valid": np.zeros((channels, n, 8, 15), bool),
             "env_start": np.full((channels, n, 8), -1, np.int32),
             "env_stop": np.full((channels, n, 8), -1, np.int32)}
    any_tones = False
    for fi in range(n):
        p = at3p_frame.unpack_frame(frames[fi], channels)
        for ch in range(channels):
            for qu in range(p["num_qu"]):
                wl = p["wordlen"][ch, qu]
                if wl == 0:
                    continue
                s, ln = T.SPECS_START[qu], T.SPECS_PER_BLOCK[qu]
                specs[ch, fi, s:s + ln] = (
                    p["mant"][ch, qu, :ln] * T.MANT_TAB[wl]
                    * T.SCALE_TABLE[p["sfi"][ch, qu]])
        if p["tones"] is not None:
            any_tones = True
            for k in tones:
                tones[k][:, fi] = p["tones"][k]
    return specs, (tones if any_tones else None)


def decode_frames(specs, tones=None, device=None) -> np.ndarray:
    """Dequantised specs [C, N, 2048] (+ tone planes) -> [C, T] PCM (numpy,
    delay-compensated).  The IMDCT and the tone synthesis run on
    ``runtime.device(device)``; the inverse PQF on the host."""
    dev = runtime.device(device)
    channels = specs.shape[0]
    bands = runtime.to_numpy(imdct_frames(runtime.to_torch(specs, dev)))
    bands = bands / T.RESIDUAL_SCALE                # [C, N, 16, 128]
    if tones is not None:
        synth = runtime.to_numpy(gha.synthesize(
            {k: runtime.to_torch(v, dev) for k, v in tones.items()}))
        # imdct_frames out[b] is content frame b-2 (coded-frame OLA latency
        # + the encoder's residual delay); wire block f carries content
        # frame f-1's waves, so content b-2 = fall*wire[b-1] + rise*wire[b]
        # = synthesize(wire)[b-1]
        bands[:, 1:, :gha.NUM_TONE_SUBBANDS, :] += synth[:, :-1]
    stream = np.swapaxes(bands, 1, 2).reshape(channels, 16, -1)
    pcm = np.stack([pqf.ipqf_np(stream[ch]) for ch in range(channels)])
    # non-finite values from corrupt input decode as silence (the int16
    # writer must never see NaN/inf)
    return np.clip(np.nan_to_num(pcm[:, pqf.PQF_DELAY_SAMPLES:],
                                 nan=0.0, posinf=1.0, neginf=-1.0),
                   -1.0, 1.0)


def decode_track(frames: np.ndarray, channels: int, device=None) -> np.ndarray:
    """[N, 2048] frames -> [C, T] PCM (numpy, delay-compensated)."""
    runtime.device(device)               # refuse a missing GPU before parsing
    return decode_frames(*dequantize(frames, channels), device=device)
