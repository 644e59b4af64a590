"""ATRAC3+ encoder in PyTorch, batched over tracks.

Port of ``atracdenc_tpu/models/atrac3p/encoder.py`` (reference
src/atrac/at3p/at3p.cpp:89-180): 16-band PQF analysis -> [GHA tonal model]
-> one-frame-delayed residual, scaled by 1/(32768/1.122018) -> per-subband
MDCT -> block-floating scale -> fixed per-QU wordlens -> mantissas ->
best-of-8 spectrum VLC table per quant unit -> NumQuantUnits shrink until
the 2048-byte frame fits.

The reference's one-frame look-ahead makes the first output frame silent
and drops the final content frame: output frame p carries content frame
p - 1.  Without GHA the residual is the PQF output, a complete, valid
ATRAC3+ stream.  Every path is the batched chunk call
``encode_chunk_device``: a track is chunks of it (``encode_track``) or one
chunk (``encode_frames_bytes``).

Where JAX vmaps ``encode_frames_bytes`` over streams, the port takes pcm
[C, T] or [S, C, T]; the core always runs with the stream axis in front.
"""
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from atracdenc_tpu_torch import runtime, trace
from atracdenc_tpu_torch.ops import scale as scale_ops
from .. import track
from . import tables as T
from . import pqf
from . import gha
from .device_pack import pack_device, tonal_fields_device, _qu_classes, _table
from .mdct import mdct_frames

CHUNK_LEFT = 4      # context frames that pin every cross-frame coupling
CHUNK_RIGHT = 1     # lookahead frames (GHA CheckNextFrame + synth region 2)
# planes without a channel axis ([F, ...]; others [C, F, ...]), with the
# stream axis in front inside the core (models/track.py)
PER_FRAME = ("num_qu", "tones.sharing", "tones.leader")


@lru_cache(maxsize=None)
def _consts(dev):
    inv_mant = np.asarray(T.INV_MANT_TAB)[np.asarray(T.FIXED_WORDLEN)]
    return {"mask": torch.as_tensor(T.GATHER_MASK, device=dev),
            "scale": torch.as_tensor(T.SCALE_TABLE, device=dev),
            "inv_mant": torch.as_tensor(inv_mant, device=dev)[:, None]}


def band_frames(pcm):
    """[..., C, T] PCM -> [..., C, F, 16, 128] PQF band samples."""
    f = pcm.shape[-1] // T.NUM_SAMPLES
    bands = pqf.analysis(pcm)                 # [..., 16, T/16]
    return bands.reshape(pcm.shape[:-1] + (16, f, 128)).transpose(-3, -2)


def gather_qu_blocks(specs):
    """[..., 2048] spectra -> padded QU blocks [..., 32, 128] (static slices
    and pads: the QUs tile the spectrum with contiguous ranges)."""
    parts = []
    for b in range(32):
        s = int(T.SPECS_START[b])
        ln = int(T.SPECS_PER_BLOCK[b])
        parts.append(F.pad(specs[..., s:s + ln], (0, 128 - ln)))
    return torch.stack(parts, dim=-2)


def _qu_table_cost(m, tab_idx):
    """Spectrum bits of QUs of one block length at one table
    (EncodeQuSpectra dry run, at3p_bitstream.cpp:286-345).  m [..., Q, ln]
    int32 -> [..., Q] int32; the JAX package takes one QU at a time.

    The codeword lengths are gathered (``SPEC_LEN[tab][val]``); the JAX
    package sums an equality mask over the codebook row instead.  Both give
    the same bits, with 0 for a value past the row, which the guard keeps."""
    gs, nc, bits, signed = (int(x) for x in T.SPECTRA_TABS[tab_idx])
    ln = m.shape[-1]
    ncodes = ln // nc
    grp = m.reshape(m.shape[:-1] + (ncodes, nc))
    if signed:
        t = grp & ((1 << bits) - 1)
        sign_bits = 0
    else:
        t = torch.abs(grp)
        sign_bits = (grp != 0).sum((-1, -2), dtype=torch.int32)
    val = (t << _table(("shifts", bits, nc), m.device)).sum(
        -1, dtype=torch.int32)                            # [..., Q, ncodes]
    nsyms = 1 << (bits * nc)
    lens = _table(("spec", tab_idx), m.device)[1]         # SPEC_LEN[tab_idx]
    inside = (val >= 0) & (val < nsyms)
    looked = lens[torch.clamp(val, 0, nsyms - 1).long()]
    code_bits = torch.where(inside, looked, 0).sum(-1, dtype=torch.int32)
    group_bits = 0 if gs == 1 else ncodes // gs
    return code_bits + sign_bits + group_bits


def _frame_slice(v, ax, sl):
    return v[(slice(None),) * ax + (sl,)]


def _core_impl(pcm, gha_mask, wb_refine, zero_tail, first):
    """The encode core over a chunk window: pcm [S, C, T] = [OVERLAP PQF
    history | CHUNK_LEFT context frames | f content frames | CHUNK_RIGHT
    lookahead frame], every output with S in front.  Every cross-frame
    coupling reaches at most CHUNK_LEFT frames left and CHUNK_RIGHT right,
    so the content frames' outputs equal a whole track's.  zero_tail (a
    track's last chunk): the lookahead frame's bands are zero, as past the
    track's end.  first (a track's first chunk): output frame 0 carries no
    tone frame, so its tone planes are zeros, not a silent context frame's
    analysis.

    gha_mask: None = GHA disabled; else the reference's ghadbg bitmask
    (atrac3p.h:29-43): 1 = GHA_PASS_INPUT, 2 = GHA_WRITE_TONAL, 4 =
    GHA_WRITE_RESIUDAL, 8 = GHA_WIDEBAND (wb_refine: True = raw refine)."""
    s, c = pcm.shape[:2]
    left = CHUNK_LEFT
    fe = (pcm.shape[-1] - pqf.OVERLAP) // T.NUM_SAMPLES   # left + f + right
    f = fe - left - CHUNK_RIGHT

    with trace.span("pqf_analysis"):
        bands = pqf.analysis(pcm, with_history=True)
        bands = bands.reshape(s, c, 16, fe, 128).transpose(2, 3)
        if zero_tail:
            bands[:, :, fe - 1] = 0.0               # no frame past track end
    tone_out = None
    if gha_mask is None:
        resid = bands
    else:
        with trace.span("gha_extract"):
            if gha_mask & 8:
                raw = pcm[..., pqf.OVERLAP:].reshape(
                    s, c, fe, T.NUM_SAMPLES).clone()
                if zero_tail:
                    raw[:, :, fe - 1] = 0.0
                tone_planes = gha.extract_wideband(bands, raw,
                                                   refine_raw=bool(wb_refine))
            else:
                tone_planes = gha.extract(bands)
        with trace.span("gha_subtract"):
            src = bands if (gha_mask & 1) else torch.zeros_like(bands)
            resid = gha.subtract(src, tone_planes)
            if not (gha_mask & 4):
                resid = torch.zeros_like(resid)
        if gha_mask & 2:
            # output alignment (one-frame tonal-block delay,
            # at3p.cpp:128-131,173-177): out frame p carries tone frame p-1
            tone_out = {}
            for key, v in tone_planes.items():
                ax = track.frame_axis("tones." + key, PER_FRAME, lead=1)
                v = _frame_slice(v, ax, slice(left - 1, left + f - 1))
                if first:
                    v = v.clone()
                    _frame_slice(v, ax, 0).zero_()
                tone_out[key] = v
    # one-frame delay: output frame p carries content frame p-1 (LOOK_AHEAD)
    with trace.span("mdct"):
        # res window [left-1, left+f) plus one MDCT warm-up frame whose
        # stored half seeds position left-1's overlap; drop its output
        res_win = resid[:, :, left - 2: left + f - 1]
        specs = mdct_frames(res_win * T.RESIDUAL_SCALE)[:, :, 1:]
        blocks = gather_qu_blocks(specs)                 # [S, C, F, 32, 128]

    return (*_block_planes(blocks), tone_out)


def _spectral_planes(specs):
    """[..., 2048] MDCT spectra -> (sfi, mant, spec_tab, spec_bits), each
    [..., 32]-shaped (mant [..., 32, 128]): block-floating scale, the fixed
    wordlens' mantissas and the best of the 8 spectrum tables per QU."""
    return _block_planes(gather_qu_blocks(specs))


def _block_planes(blocks):
    """``_spectral_planes`` of spectra already laid out as QU blocks."""
    k = _consts(blocks.device)
    sfi, scaled, _ = scale_ops.scale_blocks(blocks, k["mask"], k["scale"])
    with trace.span("spectral_planes"):
        mant = torch.round(scaled * k["inv_mant"]).to(torch.int32)
        mant = torch.where(k["mask"], mant, 0)

        # best-of-8 spectrum table per QU (strict less -> first minimum),
        # over the QU runs of one (wordlen, block length)
        costs = []
        for q0, q1, wl, ln in _qu_classes():
            m = mant[..., q0:q1, :ln]
            costs.append(torch.stack([_qu_table_cost(m, 7 * i + wl - 1)
                                      for i in range(8)], dim=-1))
        cost = torch.cat(costs, dim=-2)             # [..., 32, 8]
        spec_tab = torch.argmin(cost, dim=-1).to(torch.int32)
        spec_bits = torch.amin(cost, dim=-1)        # [..., 32]
    return sfi, mant, spec_tab, spec_bits


def _fold_streams(core):
    """Core outputs [S, C, F, ...] -> [C, S*F, ...]: frames of every stream
    in one frame axis, stream-major (the tail and the packer are per
    frame)."""
    *arrays, tone_out = core

    def fold(v, ax):                 # ax: the F axis, after S (and C)
        return (v.transpose(0, 1) if ax == 2 else v).flatten(ax - 1, ax)

    arrays = [fold(a, 2) for a in arrays]
    if tone_out is not None:
        tone_out = {key: fold(v, track.frame_axis("tones." + key,
                                                  PER_FRAME, lead=1))
                    for key, v in tone_out.items()}
    return (*arrays, tone_out)


def core_frames(pcm, f0, f1, gha_mask=7, wb_refine=None, device=None):
    """The encode core's output frames [f0, f1) of pcm [S, C, T] (numpy) ->
    (sfi, mant, spec_tab, spec_bits, tone_out), each [S, ...]: the core of
    ``encode_chunk_device`` on the same window, its PQF history, context
    frames before f0 and lookahead frame after f1 read from pcm (zeros past
    either end)."""
    dev = runtime.device(device)
    n, t = T.NUM_SAMPLES, pcm.shape[-1]
    a, b = f0 * n - pqf.OVERLAP - CHUNK_LEFT * n, (f1 + CHUNK_RIGHT) * n
    ext = np.pad(pcm[..., max(a, 0):min(b, t)],
                 ((0, 0), (0, 0), (max(-a, 0), max(b - t, 0))))
    return _core_impl(runtime.to_torch(ext, dev), gha_mask, wb_refine, b > t,
                      f0 == 0)


def core_dict(core):
    """Core outputs as one flat dict: sfi, mant, spec_tab, spec_bits and
    tones.<plane>."""
    *arrays, tone_out = core
    out = dict(zip(("sfi", "mant", "spec_tab", "spec_bits"), arrays))
    out.update({f"tones.{k}": v for k, v in (tone_out or {}).items()})
    return out


def dryrun_sharded(mesh, mesh1):
    """Run the core (GHA mask 7) over a (dp, sp) mesh on tiny shapes and
    assert that every plane equals the single-rank run's."""
    from atracdenc_tpu_torch.parallel.mesh import encode_core_at3p_sharded

    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    s = max(2, dp)
    t = T.NUM_SAMPLES * 2 * sp
    rng = np.random.default_rng(2)
    pcm = (0.25 * rng.standard_normal((s, 2, t))).astype(np.float32)
    got = encode_core_at3p_sharded(pcm, mesh, gha_mask=7)
    ref = encode_core_at3p_sharded(pcm, mesh1, gha_mask=7)
    assert got.keys() == ref.keys()
    for k in ref:
        assert np.array_equal(got[k], ref[k]), f"AT3P sharded != unsharded: {k}"


@trace.span("at3p.encode_chunk")
def encode_chunk_device(pcm, state=None, next_head=None, gha_mask=7,
                        wb_refine=None):
    """Exact chunked encode of a batch of tracks on pcm's device: pcm
    [S, C, k*2048]; state = the previous chunk's carry ``{"pcm_hist": [S,
    C, OVERLAP + CHUNK_LEFT * 2048]}`` (None at the tracks' start);
    next_head [S, C, 2048] = the next chunk's first frame (None at their
    end).  Returns (planes, state): the planes of ``_finish_planes_device``
    with the streams' frames stream-major in one frame axis (num_qu [S*k],
    sfi [C, S*k, 32], ...).  Concatenated chunks equal the whole-track
    core's frames, and nothing is read back to the host."""
    s, c, t = pcm.shape
    hist_len = pqf.OVERLAP + CHUNK_LEFT * T.NUM_SAMPLES
    hist = (pcm.new_zeros((s, c, hist_len)) if state is None
            else state["pcm_hist"])
    tail = (pcm.new_zeros((s, c, T.NUM_SAMPLES)) if next_head is None
            else next_head)
    ext = torch.cat([hist, pcm, tail], dim=-1)
    core = _core_impl(ext, gha_mask, wb_refine, next_head is None,
                      state is None)
    with trace.span("finish_planes"):
        planes = _finish_planes_device(_fold_streams(core), c)
    return planes, {"pcm_hist": ext[..., t:t + hist_len].clone()}


def encode_chunk_bytes(pcm, state=None, next_head=None, gha_mask=7,
                       wb_refine=None):
    """``encode_chunk_device`` and the device packer: -> (uint8 [S, k,
    2048] frames on pcm's device, state)."""
    planes, state = encode_chunk_device(pcm, state, next_head, gha_mask,
                                        wb_refine)
    frames = pack_device(planes, pcm.shape[1])
    return frames.reshape(pcm.shape[0], -1, T.FRAME_BYTES), state


def encode_track(pcm, use_gha=True, wb_refine=False, chunk_frames=512,
                 progress=None, device=None):
    """[C, T] PCM -> ATRAC3+ frame planes (dict of numpy arrays), the track
    in chunks of ``chunk_frames`` through ``encode_chunk_device``
    (``models/track.py``).  On the CPU the planes do not depend on
    ``chunk_frames``, and tests hold that; on the card a chunk's shape can
    move a float across a decision.

    use_gha: True -> GHA_ENABLED (mask 7); False -> GHA disabled (plain
    transform); int -> the reference's ghadbg mask (0..15, bit 3 = wideband
    strategy).  wb_refine selects ghawbrefine=1 (raw).  progress: optional
    callback(percent) after each chunk.  device: "cuda" (the default) or an
    explicit "cpu"."""
    gha_mask = (7 if use_gha is True else None if use_gha is False
                else int(use_gha))

    def chunk(x, state, nxt):
        return encode_chunk_device(x[None], state,
                                   None if nxt is None else nxt[None],
                                   gha_mask, wb_refine)
    return track.encode_track(chunk, pcm, T.NUM_SAMPLES, chunk_frames,
                              PER_FRAME, "at3p.track_chunk", progress, device)


def _num_qu(total):
    """NumQuantUnits shrink (CheckFrameDone, at3p_bitstream.cpp:529-541):
    of the candidates 32, 28, 27, ..., 1 the first whose total [F, 33]
    fits 2048*8-3 bits; 1 when none does."""
    budget = T.FRAME_BYTES * 8 - 3
    cand = _table("num_qu", total.device)
    fits = total[:, cand] <= budget                          # [F, 30]
    first = torch.argmax(fits.to(torch.int32), dim=-1)       # first True
    return torch.where(fits.any(-1), cand[first], 1).to(torch.int32)


def _finish_planes_device(core, c):
    """The tail of every path (core outputs [C, F, ...] -> planes): the
    tones' wire order (ascending frequencies per band), the tonal-section
    bits and the NumQuantUnits shrink, as tensors on the core's device."""
    sfi, mant, spec_tab, spec_bits, tone_out = core
    f = sfi.shape[1]
    tones = None
    if tone_out is not None:
        keys = torch.where(tone_out["valid"], tone_out["freq"], 1 << 20)
        order = torch.argsort(keys, dim=-1, stable=True)
        tones = {k: (v.gather(-1, order) if v.dim() == 4 else v)
                 for k, v in tone_out.items()}
        tonal_bits = tonal_fields_device(tones, c)[3].to(torch.int32)
    else:
        tonal_bits = torch.zeros((f,), dtype=torch.int32, device=sfi.device)

    const_bits = _table(("const_bits", c), sfi.device)
    spec_bits = spec_bits.to(torch.int32)
    cum = F.pad(torch.cumsum(spec_bits, dim=-1, dtype=torch.int32), (1, 0))
    total = const_bits[None] + cum.sum(0, dtype=torch.int32) \
        + tonal_bits[:, None]
    out = {"num_qu": _num_qu(total), "sfi": sfi, "mant": mant,
           "spec_tab": spec_tab}
    if tones is not None:
        out["tones"] = tones
    return out


def encode_frames_bytes(pcm, channels, gha_mask=7, wb_refine=None):
    """Whole-track device path: [C, T] PCM -> [F, 2048] frame bytes, or
    [S, C, T] -> [S, F, 2048] (T a multiple of NUM_SAMPLES: pad as
    encode_track does; ``channels`` is C, as in the JAX signature): the
    track as one chunk of ``encode_chunk_bytes``."""
    x = pcm if pcm.dim() == 3 else pcm[None]
    frames, _ = encode_chunk_bytes(x, None, None, gha_mask, wb_refine)
    return frames if pcm.dim() == 3 else frames[0]


def _num_tone_bands(tones):
    """[F] number of tone bands per output frame (0 = no tonal block)."""
    any_wave = tones["valid"].any(axis=-1).any(axis=0)   # [F, 8]
    nb = np.where(any_wave, np.arange(8)[None, :] + 1, 0).max(axis=-1)
    return nb.astype(np.int64)


def _tonal_section_bits(tones, channels):
    """Bits of the tonal block per frame (WriteTonalBlock dry run,
    at3p_bitstream.cpp:366-520): the host walk, test oracle for the
    plane-wise ``tonal_fields_device`` bits the shrink budgets with."""
    from . import frame as fr
    nb = _num_tone_bands(tones)
    bits = np.zeros(nb.shape[0], np.int64)
    for fi in range(nb.shape[0]):
        if nb[fi]:
            bits[fi] = sum(w for _, w in fr.tonal_block_fields(
                tones, fi, channels, int(nb[fi])))
    return bits
