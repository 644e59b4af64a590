"""The upstream ATRAC3+ encoder (``-e atrac3plus``, 352.8 kbit/s), one frame
at a time, in float32 NumPy.

Per frame, as src/atrac/at3p/at3p.cpp:89-180 runs it:

  1. the 16-band PQF (atrac3plus_pqf.c:81-106: the 12-tap x 32-phase FIR,
     the butterfly and the DCT-IV folded into one [16, 384] kernel) over
     the frame and 368 samples of history;
  2. GHA (``gha.py``) on subbands 0..7: the waves of frame j are analysed
     when it arrives and finished when frame j+1 arrives (the continuation
     check looks into it); the residual of frame j is the band signal less
     the decoder's synthesis of blocks j and j+1, so it is known once frame
     j+2 has arrived (at3p.cpp's LOOK_AHEAD);
  3. the residual, scaled by 1 / (32768 / 1.122018), through the
     per-subband MDCT (at3p_mdct.cpp:52-100: sine windows, the previous
     frame's rising half stored, odd subbands reversed);
  4. the block-floating scale (atrac_scale.cpp:134-188), the fixed wordlens
     (at3p_bitstream.cpp:107-112), the mantissas, the cheapest of the 8 VLC
     table families a quant unit (the first on a tie), and the NumQuantUnits
     shrink (CheckFrameDone, at3p_bitstream.cpp:529-541): of 32, 28, 27,
     ..., 1 the first whose bits fit 2048 * 8 - 3;
  5. the bitstream writer (``frame.pack``).

Output frame p carries content frame p - 1 (the look-ahead makes the first
frame silent and drops the last content frame).  Past the track's end the
band signal is zero.
"""
import numpy as np

from . import frame as frame_io
from . import gha
from . import tables as T

F32 = np.float32
OVERLAP = 368                 # PQF history: PROTO_SZ - SUBBANDS_NUM
NS = T.NUM_SAMPLES


def _mdct_matrix(n):
    """Direct MDCT basis [n/2, n], float64."""
    m = np.arange(n, dtype=np.float64)
    k = np.arange(n // 2, dtype=np.float64)
    return np.cos(2.0 * np.pi / n * np.outer(k + 0.5, m + 0.5 + n / 4.0))


def _pqf_kernel():
    """[16, 384] kernel: band sb's sample = sum_p K[sb, p] x[p]."""
    fir = np.asarray(T.PQF_FIR, np.float64)
    # atde_do_dct4_16 with the PQF's scale: TMIDCT<32>(32 * 128 * 512),
    # out[i] = -x[i + 8]
    dct = -(32.0 * 128.0 * 512.0 / 32.0) * _mdct_matrix(32).T[8:24, :]
    b = np.zeros((16, 32))
    for i in range(8):
        b[i, i + 8] = b[i, 7 - i] = 1.0
        b[i + 8, i + 16] = b[i + 8, 31 - i] = 1.0
    m = (dct @ b)[::-1]
    k = np.zeros((16, 384))
    for kk in range(32):
        for j in range(12):
            k[:, j * 32 + kk] += m[:, kk] * fir[kk * 12 + j]
    return np.asarray(k, F32)


_PQF_T = np.ascontiguousarray(_pqf_kernel().T)                # [384, 16]
_MDCT_T = np.ascontiguousarray(
    (_mdct_matrix(256) * (1.0 / 256.0)).astype(F32).T)       # [256, 128]
_SINE = (2.0 * np.sin((np.arange(128) + 0.5) * (np.pi / 256.0))).astype(F32)
_SINE_FALL = np.ascontiguousarray(_SINE[::-1])
_ODD = np.arange(16) % 2 == 1
_SCALE = np.asarray(T.SCALE_TABLE, F32)
_INV_MANT = np.asarray(T.INV_MANT_TAB, F32)[T.FIXED_WORDLEN]  # [32]
_RESIDUAL_SCALE = F32(T.RESIDUAL_SCALE)
BUDGET = T.FRAME_BYTES * 8 - 3
CANDIDATES = [32] + list(range(28, 0, -1))


def pqf(x):
    """x [C, OVERLAP + 2048] (history, then the frame) -> bands [C, 16,
    128]: band sample i reads x[16 i : 16 i + 384]."""
    c = x.shape[0]
    win = np.lib.stride_tricks.sliding_window_view(x, 384, axis=-1)[:, ::16]
    return np.swapaxes((win.reshape(c * 128, 384) @ _PQF_T)
                       .reshape(c, 128, 16), 1, 2)


def mdct(prev, cur):
    """Residual band samples of the previous and this content frame [C, 16,
    128] (scaled) -> spectrum [C, 2048]."""
    buf = np.concatenate([_SINE * prev, _SINE_FALL * cur], axis=-1)
    spec = buf @ _MDCT_T                                      # [C, 16, 128]
    spec = np.where(_ODD[:, None], spec[..., ::-1], spec)
    return spec.reshape(spec.shape[0], 2048)


def scale_blocks(spec):
    """[C, 2048] -> (sfi [C, 32], scaled quant units [C, 32, 128])."""
    c = spec.shape[0]
    blocks = np.zeros((c, 32, 128), F32)
    for q in range(32):
        s, n = T.SPECS_START[q], T.SPECS_PER_BLOCK[q]
        blocks[:, q, :n] = spec[:, s:s + n]
    maxabs = np.minimum(np.abs(blocks).max(-1), F32(1.0))
    sfi = (_SCALE[:-1] < maxabs[..., None]).sum(-1).astype(np.int32)
    scaled = blocks / _SCALE[sfi][..., None]
    scaled = np.where(np.abs(scaled) >= 1.0,
                      np.clip(scaled, F32(-0.99999), F32(0.99999)), scaled)
    return sfi, scaled * T.GATHER_MASK


def _table_cost(m, tab_idx):
    """Spectrum bits of quant units m [..., ln] int32 in table tab_idx
    (EncodeQuSpectra's dry run, at3p_bitstream.cpp:286-345)."""
    gs, nc, bits, signed = (int(x) for x in T.SPECTRA_TABS[tab_idx])
    ln = m.shape[-1]
    grp = m.reshape(m.shape[:-1] + (ln // nc, nc))
    if signed:
        t = grp & ((1 << bits) - 1)
        sign_bits = 0
    else:
        t = np.abs(grp)
        sign_bits = (grp != 0).sum((-1, -2))
    val = (t << (bits * np.arange(nc))).sum(-1)
    nsyms = 1 << (bits * nc)
    lens = T.SPEC_LEN[tab_idx][np.clip(val, 0, nsyms - 1)]
    code_bits = np.where((val >= 0) & (val < nsyms), lens, 0).sum(-1)
    return code_bits + sign_bits + (0 if gs == 1 else ln // nc // gs)


def spectral_planes(spec):
    """[C, 2048] -> sfi [C, 32], mant [C, 32, 128], the table family of
    each quant unit [C, 32] and its bits [C, 32]."""
    sfi, scaled = scale_blocks(spec)
    mant = np.round(scaled * _INV_MANT[:, None]).astype(np.int32)
    mant = np.where(T.GATHER_MASK, mant, 0)
    c = spec.shape[0]
    cost = np.zeros((c, 32, 8), np.int64)
    for q in range(32):
        wl, n = int(T.FIXED_WORDLEN[q]), int(T.SPECS_PER_BLOCK[q])
        for fam in range(8):
            cost[:, q, fam] = _table_cost(mant[:, q, :n], 7 * fam + wl - 1)
    return sfi, mant, cost.argmin(-1).astype(np.int32), cost.min(-1)


def _wordlen_bits():
    ch0 = np.zeros(33, np.int64)
    ch1 = np.zeros(33, np.int64)
    for nq in range(1, 33):
        ch0[nq] = sum(w for _, w in frame_io._wl_fields(nq))
        ch1[nq] = sum(w for _, w in frame_io._wl_fields_ch1(nq))
    return ch0, ch1


def const_bits(channels):
    """[33] bits a frame writes for each numQU that do not depend on the
    spectra or the tones."""
    ch0, ch1 = _wordlen_bits()
    nq = np.arange(33)
    bits = 5 + 1 + ch0 + (ch1 if channels == 2 else 0)
    bits = bits + channels * (2 + 6 * nq)                     # TSfIdx
    bits = bits + 1 + channels * (1 + 2 + 1 + 3 * nq)         # code tables
    pwr = T.SUBBAND_TO_NUM_POWGRPS[T.QU_TO_SUBBAND[np.maximum(nq, 1) - 1]]
    bits = bits + channels * 4 * pwr                          # power stubs
    if channels == 2:
        bits = bits + 2                                       # swap / negate
    return bits + channels * 2 + 1 + 1 + 2   # windows, gain, tonal, noise, end


def wire_order(p):
    """A frame's tone planes with each subband's waves in ascending
    frequency (the writer's order), the absent waves last."""
    key = np.where(p["valid"], p["freq"], 1 << 20)
    order = np.argsort(key, axis=-1, kind="stable")
    out = dict(p)
    for k in ("freq", "amp_sf", "phase", "valid"):
        out[k] = np.take_along_axis(p[k], order, axis=-1)
    return out


def tonal_bits(p, channels):
    """Bits of a frame's tonal block (0 with no tones)."""
    nb = int(np.where(p["valid"].any(-1).any(0), np.arange(8) + 1, 0).max())
    if not nb:
        return 0
    one = {k: (np.asarray(v)[None] if k in ("sharing", "leader")
               else np.asarray(v)[:, None]) for k, v in p.items()}
    return sum(w for _, w in frame_io.tonal_block_fields(one, 0, channels, nb))


def num_qu(spec_bits, tone_bits, cbits):
    total = cbits + np.concatenate([[0], np.cumsum(spec_bits.sum(0))]) \
        + tone_bits
    for nq in CANDIDATES:
        if total[nq] <= BUDGET:
            return nq
    return 1


class Encoder:
    """The encoder's state across frames: ``feed`` one frame of PCM [C,
    2048] at a time, then ``flush``; each returns the output frames'
    planes made so far (dicts of one frame)."""

    def __init__(self, channels, gha_mask=7):
        if gha_mask is not None and gha_mask & 8:
            raise ValueError("the wideband GHA strategy is not modelled")
        self.c = channels
        self.mask = gha_mask
        self.hist = np.zeros((channels, OVERLAP), F32)
        self.cbits = const_bits(channels)
        zero = np.zeros((channels, 16, 128), F32)
        self.bands = []             # band samples of frames not yet coded
        self.analysed = []          # GHA analyses of frames not finished
        self.stop = np.zeros(channels * gha.NUM_TONE_SUBBANDS, bool)
        self.planes = []            # finished tone planes, oldest first
        self.blocks = []            # synthesis blocks, oldest first
        self.prev_resid = zero      # residual of the last coded content frame
        self.out = [self._code(zero, None)]       # output frame 0: silent

    def _code(self, resid, tones):
        """Output planes of one frame: the MDCT of a content frame's
        residual with its tones."""
        spec = mdct(self.prev_resid, resid)
        self.prev_resid = resid
        sfi, mant, tab, bits = spectral_planes(spec)
        planes = {"sfi": sfi, "mant": mant, "spec_tab": tab}
        tb = 0
        if tones is not None:
            planes["tones"] = tones = wire_order(tones)
            tb = tonal_bits(tones, self.c)
        planes["num_qu"] = num_qu(bits, tb, self.cbits)
        return planes

    def _residual(self, bands):
        """The oldest uncoded content frame's residual, scaled for the
        MDCT, once its block and the next (or the track's end) are known."""
        m = self.mask
        src = bands if m & 1 else np.zeros_like(bands)
        nxt = self.blocks[1] if len(self.blocks) > 1 else None
        tone = gha.synth_frame(self.blocks[0], nxt)
        resid = src.copy()
        resid[:, :gha.NUM_TONE_SUBBANDS] -= tone
        if not m & 4:
            resid = np.zeros_like(resid)
        return resid * _RESIDUAL_SCALE

    def _finish_one(self, next_bands):
        """Finish the oldest analysed frame against the next frame's bands."""
        planes, self.stop = gha.finish(self.analysed.pop(0), next_bands,
                                       self.stop)
        prev = self.planes[-1] if self.planes else gha.empty_planes(self.c)
        self.planes.append(planes)
        self.blocks.append(gha.block(prev, planes))

    def _emit(self):
        """Code the oldest content frame whose residual is known."""
        bands = self.bands.pop(0)
        if self.mask is None:
            self.out.append(self._code(bands * _RESIDUAL_SCALE, None))
            return
        resid = self._residual(bands)
        tones = self.planes.pop(0)
        self.blocks.pop(0)
        self.out.append(self._code(resid, tones if self.mask & 2 else None))

    def feed(self, pcm):
        x = np.concatenate([self.hist, np.asarray(pcm, F32)], axis=-1)
        self.hist = x[:, -OVERLAP:]
        bands = pqf(x)
        self.bands.append(bands)
        if self.mask is None:
            if len(self.bands) > 1:
                self._emit()
        else:
            if self.analysed:
                self._finish_one(bands)
            self.analysed.append(gha.analyse(bands))
            if len(self.blocks) > 1:
                self._emit()
        return self._take()

    def flush(self):
        """The frames left at the track's end: the last content frame is
        dropped (the look-ahead), as upstream drops it."""
        if self.mask is not None and self.analysed:
            self._finish_one(np.zeros_like(self.bands[-1]))
        while len(self.bands) > 1:
            self._emit()
        return self._take()

    def _take(self):
        out, self.out = self.out, []
        return out


def encode_track(pcm, gha_mask=7):
    """[C, T] PCM (padded to whole frames) -> planes of all frames: num_qu
    [F], sfi / spec_tab [C, F, 32], mant [C, F, 32, 128], and tones (wire
    ordered; freq / amp_sf / phase / valid [C, F, 8, 8], env_start /
    env_stop [C, F, 8], sharing [F, 8], leader [F]) unless ``gha_mask`` is
    None or leaves out the tonal block (bit 2)."""
    pcm = np.atleast_2d(np.asarray(pcm, F32))
    c, t = pcm.shape
    pcm = np.pad(pcm, ((0, 0), (0, (-t) % NS)))
    enc = Encoder(c, gha_mask)
    frames = []
    for i in range(pcm.shape[1] // NS):
        frames += enc.feed(pcm[:, i * NS:(i + 1) * NS])
    frames += enc.flush()
    return stack(frames, c)


def stack(frames, c):
    """Per-frame planes -> planes with a frame axis."""
    out = {"num_qu": np.asarray([f["num_qu"] for f in frames], np.int32)}
    for k in ("sfi", "mant", "spec_tab"):
        out[k] = np.stack([f[k] for f in frames], axis=1)
    if "tones" in frames[-1]:
        tones = [f.get("tones") or gha.empty_planes(c) for f in frames]
        out["tones"] = {k: np.stack([np.asarray(p[k]) for p in tones],
                                    axis=0 if k in ("sharing", "leader")
                                    else 1)
                        for k in tones[0]}
        out["tones"]["leader"] = out["tones"]["leader"].astype(np.int32)
    return out


def encode_frames(pcm, gha_mask=7):
    """[C, T] PCM -> the upstream encoder's frames, uint8 [F, 2048]."""
    pcm = np.atleast_2d(pcm)
    return frame_io.pack(encode_track(pcm, gha_mask), pcm.shape[0])
