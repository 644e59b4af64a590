"""WAV (16-bit PCM) read/write without external dependencies.

The reference only accepts 44100 Hz input (main.cpp:276-283); reading
normalizes int16 by 1/32768 like libsndfile; writing scales by 32768 with
clipping.  Supports '-' for stdin/stdout like the reference CLI.
"""
import io
import sys
import wave

import numpy as np


def read(path: str):
    """Returns (pcm [C, T] float32 in [-1, 1), sample_rate)."""
    if path == "-":
        data = sys.stdin.buffer.read()
        fp = wave.open(io.BytesIO(data), "rb")
    else:
        fp = wave.open(str(path), "rb")
    with fp:
        if fp.getsampwidth() != 2:
            raise ValueError("Only 16-bit PCM WAV input is supported")
        channels = fp.getnchannels()
        rate = fp.getframerate()
        n = fp.getnframes()
        raw = fp.readframes(n)
    pcm = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    return pcm.reshape(-1, channels).T.copy(), rate


def write(path: str, pcm: np.ndarray, sample_rate: int = 44100) -> None:
    """pcm: [C, T] float in [-1, 1]."""
    pcm = np.atleast_2d(pcm)
    ints = np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype(np.int16)
    interleaved = ints.T.reshape(-1).tobytes()
    buf = io.BytesIO() if path == "-" else None
    fp = wave.open(buf if buf is not None else str(path), "wb")
    with fp:
        fp.setnchannels(pcm.shape[0])
        fp.setsampwidth(2)
        fp.setframerate(sample_rate)
        fp.writeframes(interleaved)
    if buf is not None:
        sys.stdout.buffer.write(buf.getvalue())
