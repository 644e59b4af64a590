"""ATRAC3+ reference: the upstream encoder's frames for a track's PCM, and
the dequantiser that turns frames into spectra for the error numbers.

The model's matrix products are small (a frame's 16 lanes at a time), and
the check runs one process a sampled track on a core each, so numpy's BLAS
gets one thread: threads of its own would oversubscribe the cores many
times over.  The variable is read when numpy loads, which in a reference
worker (``worker.py``) happens in this module's imports."""
import os

os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import numpy as np  # noqa: E402

from portbench.reference.upstream.atrac3plus import (  # noqa: E402
    encoder, frame as frame_io, tables as T)

SAMPLES_PER_FRAME = 2048
ROWS_PER_FRAME = 1          # one row is one stereo frame


def encode_rows(cfg, pcm):
    """f32 [2, T] (T whole frames, from a track's start) -> the upstream
    encoder's frames, uint8 [T / 2048, 2048]."""
    return encoder.encode_frames(pcm, cfg["gha_mask"])


class Reference:
    encode_rows = staticmethod(encode_rows)

    def __init__(self, cfg):
        self.cfg = cfg
        self.row_bytes = cfg["frame_bytes"]
        self.channels = cfg["channels"]

    def spectra(self, rows):
        """rows uint8 [n, 2048] -> dequantised MDCT spectra [n, C, 2048]
        f32 (ValueError if a row does not parse to its terminator)."""
        rows = np.asarray(rows, np.uint8)
        out = np.zeros((rows.shape[0], self.channels, 2048), np.float32)
        for i, row in enumerate(rows):
            try:
                p = frame_io.unpack_frame(row, self.channels)
            except AssertionError as e:
                raise ValueError(f"row {i} does not parse") from e
            for ch in range(self.channels):
                for qu in range(p["num_qu"]):
                    wl = p["wordlen"][ch, qu]
                    if not 0 <= wl < 8:
                        raise ValueError(f"row {i}: wordlen {wl}")
                    s, n = T.SPECS_START[qu], T.SPECS_PER_BLOCK[qu]
                    out[i, ch, s:s + n] = p["mant"][ch, qu, :n] * (
                        T.MANT_TAB[wl] * T.SCALE_TABLE[p["sfi"][ch, qu]])
        return out
