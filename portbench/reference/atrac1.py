"""ATRAC1 reference: the upstream encoder's sound units for a track's PCM,
and the dequantiser (``atrac1_dequantiser.cpp``'s arithmetic) that turns
units into spectra for the error numbers."""
import numpy as np

from portbench.reference.upstream.atrac1 import exact_enc
from portbench.reference.upstream.atrac1 import frame as frame_io
from portbench.reference.upstream.atrac1 import tables as T

SAMPLES_PER_FRAME = 512
ROWS_PER_FRAME = 2          # one row is one channel's sound unit


def encode_rows(cfg, pcm):
    """f32 [2, T] (T whole frames, from a track's start) -> the upstream
    encoder's sound units in (frame, channel) order, as AEA files hold
    them: uint8 [T / 512 * 2, 212]."""
    planes = exact_enc.encode_track_exact(
        pcm, bfu_idx_const=cfg["bfu_idx_const"],
        window_mode=cfg["window_mode"], window_mask=cfg["window_mask"])
    merged = {k: np.swapaxes(np.asarray(v), 0, 1).reshape((-1,) + v.shape[2:])
              for k, v in planes.items()}
    return frame_io.pack(merged)


class Reference:
    encode_rows = staticmethod(encode_rows)

    def __init__(self, cfg):
        self.cfg = cfg
        self.row_bytes = T.SOUND_UNIT_SIZE

    def spectra(self, rows):
        """rows uint8 [n, 212] -> dequantised spectra [n, 1, 512] f32; a
        malformed unit raises ValueError."""
        p = frame_io.unpack(np.asarray(rows, np.uint8))
        if not p["valid"].all():
            raise ValueError("malformed sound unit")
        return np.swapaxes(_dequant(p["short_mask"][None], p["wordlen"][None],
                                    p["sfi"][None], p["mant"][None]), 0, 1)


def _dequant(short_mask, wordlen, sfi, mant):
    """[C, F, ...] planes -> specs [C, F, 512] f32 (atrac1_dequantiser.cpp)."""
    f32 = np.float32
    scale_tab = np.asarray(T.SCALE_TABLE, f32)
    wl = np.asarray(wordlen, np.int64)
    denom = ((1 << np.maximum(wl, 1) - 1) - 1).astype(f32)
    with np.errstate(divide="ignore", invalid="ignore"):
        maxq = (np.float64(1.0) / denom).astype(f32)
        factor = scale_tab[np.asarray(sfi)] * maxq
        vals = factor[..., None] * np.asarray(mant, f32)
    vals = np.where((wl >= 2)[..., None], vals, f32(0.0))
    c, f, nbfu = wl.shape
    specs = np.zeros((c, f, 512), f32)
    start_long = np.asarray(T.SPECS_START_LONG)
    start_short = np.asarray(T.SPECS_START_SHORT)
    sm = np.asarray(short_mask)
    for b in range(nbfu):
        ns = int(T.SPECS_PER_BLOCK[b])
        start = np.where(sm[:, :, T.BFU_TO_BAND[b]], start_short[b],
                         start_long[b])
        for off in (int(start_long[b]), int(start_short[b])):
            m = start == off
            if m.any():
                specs[:, :, off:off + ns] = np.where(
                    m[..., None], vals[:, :, b, :ns], specs[:, :, off:off + ns])
    return specs
