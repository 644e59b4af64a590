"""ATRAC3 reference: the upstream encoder's frames for a track's PCM, and
the dequantiser that turns frames into spectra for the error numbers."""
import numpy as np

from portbench.reference.upstream.atrac3 import exact_enc
from portbench.reference.upstream.atrac3 import frame as frame_io
from portbench.reference.upstream.atrac3 import tables as T

SAMPLES_PER_FRAME = 1024
ROWS_PER_FRAME = 1          # one row is one stereo frame


def options(cfg):
    return dict(frame_bytes=cfg["frame_bytes"], js=cfg["joint_stereo"],
                no_gain=not cfg["gain_control"],
                no_tonal=not cfg["tonal_components"],
                bfu_idx_const=cfg["bfu_idx_const"])


def encode_rows(cfg, pcm):
    """f32 [2, T] (T whole frames, from a track's start) -> the upstream
    encoder's frames, uint8 [T / 1024, frame_bytes]."""
    opts = options(cfg)
    planes = exact_enc.encode_track_exact(pcm, **opts)
    return frame_io.pack(planes, opts["frame_bytes"], opts["js"])


class Reference:
    encode_rows = staticmethod(encode_rows)

    def __init__(self, cfg):
        self.cfg = cfg
        self.row_bytes = cfg["frame_bytes"]
        self.js = cfg["joint_stereo"]

    def spectra(self, rows):
        """rows uint8 [n, frame_bytes] -> dequantised spectra [n, 2, 1024]
        f32 (ValueError if a row does not parse)."""
        parsed = frame_io.unpack(np.asarray(rows, np.uint8), 2, self.js)
        return np.swapaxes(_dequantize(parsed), 0, 1)


def _dequantize(parsed_channels):
    """Per-frame lists of per-channel parse dicts -> specs [C, F, 1024]."""
    f = len(parsed_channels)
    c = len(parsed_channels[0])
    specs = np.zeros((c, f, 1024), np.float32)
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
                mul = T.MAX_QUANT[tc["quant"]]
                if not mul:
                    continue
                sf = T.SCALE_TABLE[tc["sfi"]]
                pos = tc["pos"]
                vals = np.asarray(tc["mant"], np.float32) / mul * sf
                specs[ci, fi, pos:pos + len(vals)] = vals
    return specs
