"""ATRAC3 encoder in PyTorch, batched over streams, channels and frames.

Port of ``atracdenc_tpu/models/atrac3/encoder.py`` (reference call stack
src/atrac3denc.cpp:679-867): QMF analysis (4 bands) -> [gain control] ->
windowed MDCT with gain modulation -> loudness IIR -> [tonal extraction] ->
block-floating scale -> quantisation-cost memo -> rate control ->
mantissas.  The output is a dict of fixed-shape integer planes that the
JAX package's host packer (``atracdenc_tpu/models/atrac3/frame.py``)
serialises into sound units.

Where JAX vmaps over streams, the port takes an optional leading stream
axis: pcm [C, T] or [S, C, T].  Stages that treat channels alike run on
the flattened [S*C, ...] axis.
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch.shared import tables as T
from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.ops import psy, scale as scale_ops
from . import filterbank, gain, specblocks, tonal
from .bitalloc import allocate, final_mantissas, quant_tensors
from .mdct import first_level_scale, gain_divisors, mdct_frames

_LOUD_CURVE = psy.create_loudness_curve(1024)


@functools.lru_cache(maxsize=None)
def _consts(dev):
    return {"loud_curve": torch.as_tensor(_LOUD_CURVE, device=dev),
            "mask": torch.as_tensor(T.GATHER_MASK, device=dev),
            "scale": torch.as_tensor(T.SCALE_TABLE, device=dev),
            "enc_win": torch.as_tensor(T.ENCODE_WINDOW, device=dev)}


def band_frames(pcm):
    """[..., T] PCM -> [..., F, 4, 256] band samples (input scaled by 1/4,
    atrac3denc.cpp:703-705)."""
    f = pcm.shape[-1] // T.NUM_SAMPLES
    bands = filterbank.analysis(pcm * 0.25)                # [..., 4, T/4]
    bands = bands.reshape(pcm.shape[:-1] + (4, f, 256))
    return bands.transpose(-3, -2)


def spread_from_sfi(sfi):
    """AnalizeScaleFactorSpread over all 32 blocks
    (atrac_psy_common.cpp:101-124)."""
    mean = torch.mean(sfi.to(torch.float32), dim=-1)
    d = sfi - mean[..., None]
    var = torch.mean(d * d, dim=-1)
    return torch.clamp(torch.sqrt(var), max=14.0) / 14.0


def init_state(c, dev, lead=()):
    """Carry state for exact chunked encoding (gain context, MDCT overlap
    half, NextOverlapScale, loudness IIR, QMF input tail); shapes as the
    JAX package's ``init_state`` with the stream axes ``lead`` in front."""
    lead = tuple(lead)
    g = gain.init_ctx(int(np.prod(lead, dtype=np.int64)) * c, dev)
    return {
        "gain": {k: v.reshape(lead + (c,) + v.shape[1:]) for k, v in g.items()},
        "mdct_prev": torch.zeros(lead + (c, 4, 256), device=dev),
        "next_overlap": torch.ones(lead + (c, 4), device=dev),
        "loudness": torch.full(lead, T.LOUD_FACTOR, dtype=torch.float32,
                               device=dev),
        "pcm_tail": torch.zeros(lead + (c, T.NUM_SAMPLES), device=dev),
    }


def encode_frames(pcm, frame_bytes=384, js=False, no_gain_control=True,
                  no_tonal=True, bfu_idx_const=0, use_rate_kernel=True):
    """[C, T] or [S, C, T] PCM (T a multiple of 1024) -> frame planes."""
    planes, _ = encode_frames_chunk(pcm, None, None, frame_bytes, js,
                                    no_gain_control, no_tonal, bfu_idx_const,
                                    use_rate_kernel)
    return planes


def encode_frames_chunk(pcm, state=None, next_pcm=None, frame_bytes=384,
                        js=False, no_gain_control=True, no_tonal=True,
                        bfu_idx_const=0, use_rate_kernel=True):
    """Encode [..., C, T] PCM into ATRAC3 frame planes.

    ``state`` carries the exact cross-chunk recurrences (``init_state``);
    ``next_pcm`` [..., C, 1024] is the lookahead after this chunk (None at
    track end).  ``use_rate_kernel=False`` runs the tensor-op rate control
    instead of kernel C (same bytes).  Returns (planes, new_state); planes
    (per [..., C, F]): num_bfu, coding_mode (1 = CLC), wordlen [32], sfi
    [32], mant [32, 128], gain_npoints [4], gain_levels / gain_locs [4, 8],
    loudness [..., F], ms_shift [..., F], clip_count, clip_max, and with
    tonal components the tonal_* planes."""
    lead = pcm.shape[:-2]
    c, t = pcm.shape[-2:]
    f = t // T.NUM_SAMPLES
    dev = pcm.device
    k = _consts(dev)
    if state is None:
        state = init_state(c, dev, lead)
    s = int(np.prod(lead, dtype=np.int64))
    x = pcm.reshape(s, c, t)
    st = {
        "gain": {kk: v.reshape((s * c,) + v.shape[len(lead) + 1:])
                 for kk, v in state["gain"].items()},
        "mdct_prev": state["mdct_prev"].reshape(s * c, 4, 256),
        "next_overlap": state["next_overlap"].reshape(s * c, 4),
        "loudness": state["loudness"].reshape(s),
        "pcm_tail": state["pcm_tail"].reshape(s, c, T.NUM_SAMPLES),
    }

    # QMF needs ~366 samples of history: prepend the previous chunk's tail
    # frame and drop its band outputs
    ext = torch.cat([st["pcm_tail"], x], dim=-1)
    bands = band_frames(ext)[:, :, 1:]                    # [S, C, F, 4, 256]
    if next_pcm is None:
        next_head = torch.zeros((s, c, 4, 128), dtype=pcm.dtype, device=dev)
    else:
        la = torch.cat([x[..., -2048:], next_pcm.reshape(s, c, -1)], dim=-1)
        next_head = filterbank.analysis(la * 0.25)[..., -256:-128]
    if js and c == 2:
        # M/S matrixing in the band-sample domain (atrac3denc.cpp:665-677)
        bands = torch.stack([(bands[:, 0] + bands[:, 1]) * 0.5,
                             (bands[:, 0] - bands[:, 1]) * 0.5], dim=1)
        next_head = torch.stack([(next_head[:, 0] + next_head[:, 1]) * 0.5,
                                 (next_head[:, 0] - next_head[:, 1]) * 0.5],
                                dim=1)
    bands = bands.reshape(s * c, f, 4, 256)
    next_head = next_head.reshape(s * c, 4, 128)

    if no_gain_control:
        gain_npoints = torch.zeros((s * c, f, 4), dtype=torch.int32, device=dev)
        gain_levels = torch.zeros((s * c, f, 4, 8), dtype=torch.int32,
                                  device=dev)
        gain_locs = torch.zeros_like(gain_levels)
        gain_scale_frame = torch.ones((s * c, f, 4), device=dev)
        gain_ctx_out = st["gain"]
        next_overlap = st["next_overlap"]
        specs = mdct_frames(bands, prev_half=st["mdct_prev"])
        mdct_last = k["enc_win"] * bands[:, -1]
    else:
        gain_levels, gain_locs, gain_npoints, gain_ctx_out = gain.gain_control(
            bands, ctx=st["gain"], next_head=next_head)
        div = gain_divisors(gain_levels, gain_locs, gain_npoints)
        scl = first_level_scale(gain_levels, gain_npoints)
        gain_scale_frame, (mdct_last, next_overlap) = gain.energy_scale(
            bands, div, scl, prev_half=st["mdct_prev"],
            prev_overlap_init=st["next_overlap"])
        specs = mdct_frames(bands, div, scl, prev_half=st["mdct_prev"])

    # loudness IIR (atrac3denc.cpp:811-841): stereo non-JS averages both
    # channels; mono and JS use channel 0 only
    gs_per_line = torch.repeat_interleave(gain_scale_frame, 256, dim=-1)
    frame_loud = torch.sum(specs * specs * gs_per_line * k["loud_curve"],
                           dim=-1).reshape(s, c, f)
    ones = torch.ones(f, dtype=torch.bool, device=dev)
    if c == 2 and not js:
        loud = psy.track_loudness_scan(frame_loud[:, 0], frame_loud[:, 1],
                                       ones, ~ones, st["loudness"])
    else:
        loud = psy.track_loudness_scan(frame_loud[:, 0],
                                       torch.zeros_like(frame_loud[:, 0]),
                                       ~ones, ones, st["loudness"])
    loudness = loud / T.LOUD_FACTOR                       # [S, F]

    # tonal component extraction (atrac3denc.cpp:822-827); flatness and
    # loudness both use the pre-extraction spectrum
    tonal_planes = None
    if not no_tonal:
        flat = tonal.flatness_per_bfu(specs * specs)
        specs, tp = tonal.extract(specs, flat)
        tonal_planes = tonal.scale_groups(tp)

    blocks = specblocks.to_blocks(specs)                  # [S*C, F, 32, 128]
    sfi, scaled, energy = scale_ops.scale_blocks(blocks, k["mask"], k["scale"])
    absb = torch.abs(blocks)
    clip_count = torch.sum(absb > 1.0, dim=(-1, -2), dtype=torch.int32)
    clip_max = torch.amax(absb, dim=(-1, -2))
    spread = spread_from_sfi(sfi)

    # per-channel bit budget (WriteSoundUnit, atrac3_bitstream.cpp:830-892)
    half = frame_bytes // 2
    id_bits = torch.tensor([14 if (js and ch == 1) else 6 for ch in range(c)],
                           dtype=torch.int32, device=dev)[None, :, None]
    header_bits = id_bits + 2 + torch.sum(
        3 + gain_npoints.reshape(s, c, f, 4) * 9, dim=-1, dtype=torch.int32)
    if js:
        # M/S byte-budget shift (CalcMSBytesShift, atrac3_bitstream.cpp:
        # 800-828); a mono input's empty side channel gets the minimum
        h1 = header_bits[:, 1] if c == 2 else 14 + 2 + 3
        total_used = 12 + header_bits[:, 0] + h1
        max_shift = half - (1 + torch.div(total_used - 1, 8,
                                          rounding_mode="floor"))
        if c == 2:
            total_loud = frame_loud[:, 0] + frame_loud[:, 1]
            ratio = torch.where(total_loud > 0,
                                frame_loud[:, 0] / total_loud - 0.5, 0.0)
            ms_shift = torch.clamp(
                torch.round(frame_bytes * ratio).to(torch.int32),
                -max_shift, max_shift)
        else:
            ms_shift = max_shift.to(torch.int32)
    else:
        ms_shift = torch.zeros((s, f), dtype=torch.int32, device=dev)
    shift_per_ch = torch.stack([ms_shift, -ms_shift], dim=1)[:, :c]
    target = torch.clamp(8 * (half + shift_per_ch) - 6 - header_bits,
                         min=1).to(torch.int32).reshape(s * c, f)

    qt = quant_tensors(scaled, k["mask"])
    loud_cf = loudness[:, None, :].expand(s, c, f).reshape(s * c, f)
    num_bfu, mode, wl = allocate(
        qt, sfi, gain_scale_frame, energy, spread, loud_cf, target,
        tonal_planes=tonal_planes, bfu_idx_const=bfu_idx_const,
        use_rate_kernel=use_rate_kernel)
    mant = final_mantissas(scaled, k["mask"], wl)

    def cf(x):                       # [S*C, F, ...] -> [..., C, F, ...]
        return x.reshape(lead + (c, f) + x.shape[2:])

    out = {
        "num_bfu": cf(num_bfu.to(torch.int8)),
        "coding_mode": cf(mode),
        "wordlen": cf(wl.to(torch.int8)),
        "sfi": cf(sfi.to(torch.int8)),
        "mant": cf(mant),
        "gain_npoints": cf(gain_npoints.to(torch.int8)),
        "gain_levels": cf(gain_levels.to(torch.int8)),
        "gain_locs": cf(gain_locs.to(torch.int8)),
        "loudness": loudness.reshape(lead + (f,)),
        "ms_shift": ms_shift.reshape(lead + (f,)),
        "clip_count": cf(clip_count),
        "clip_max": cf(clip_max),
    }
    if tonal_planes is not None:
        active, quant = tonal.block_quant(tonal_planes, wl, num_bfu)
        out["tonal_active"] = cf(active)
        out["tonal_start"] = cf(tonal_planes["start"].to(torch.int16))
        out["tonal_len"] = cf(tonal_planes["len"].to(torch.int8))
        out["tonal_sfi"] = cf(tonal_planes["sfi"].to(torch.int8))
        out["tonal_quant"] = cf(torch.where(active, quant, 0).to(torch.int8))
        tm = torch.gather(tonal_planes["mant"], -2,
                          quant.long()[..., None, None].expand(
                              quant.shape + (1, tonal.BLOCK_LEN)))[..., 0, :]
        out["tonal_mant"] = cf(tm.to(torch.int8))

    state_out = {
        "gain": {kk: v.reshape(lead + (c,) + v.shape[1:])
                 for kk, v in gain_ctx_out.items()},
        "mdct_prev": mdct_last.reshape(lead + (c, 4, 256)),
        "next_overlap": next_overlap.reshape(lead + (c, 4)),
        "loudness": loud[:, -1].reshape(lead),
        "pcm_tail": x[..., -T.NUM_SAMPLES:].reshape(lead + (c, T.NUM_SAMPLES)),
    }
    return out, state_out


def encode_track(pcm, frame_bytes=384, js=False, no_gain_control=True,
                 no_tonal=True, bfu_idx_const=0, chunk_frames=1024,
                 progress=None, device=None, use_rate_kernel=True):
    """NumPy wrapper: [C, T] PCM -> numpy planes.  Pads to whole frames and
    encodes tracks longer than ``chunk_frames`` in exact chunks (the carry
    state makes chunked output identical to whole-track output).

    device: "cuda" (the default) or an explicit "cpu".
    progress: optional callback(percent) after each chunk."""
    dev = runtime.device(device)
    pcm = np.atleast_2d(np.asarray(pcm, np.float32))
    c, t = pcm.shape
    pad = (-t) % T.NUM_SAMPLES
    if pad:
        pcm = np.pad(pcm, ((0, 0), (0, pad)))
    f_total = pcm.shape[1] // T.NUM_SAMPLES
    opts = dict(frame_bytes=frame_bytes, js=js,
                no_gain_control=no_gain_control, no_tonal=no_tonal,
                bfu_idx_const=bfu_idx_const, use_rate_kernel=use_rate_kernel)

    if f_total <= chunk_frames:
        planes = encode_frames(runtime.to_torch(pcm, dev), **opts)
        if progress is not None:
            progress(100)
        return {kk: runtime.to_numpy(v) for kk, v in planes.items()}

    state = None
    outs = []
    n = T.NUM_SAMPLES
    for a in range(0, f_total, chunk_frames):
        b = min(a + chunk_frames, f_total)
        chunk = runtime.to_torch(pcm[:, a * n: b * n], dev)
        nxt = None
        if b < f_total:
            nxt = runtime.to_torch(pcm[:, b * n: (b + 1) * n], dev)
        planes, state = encode_frames_chunk(chunk, state, nxt, **opts)
        outs.append({kk: runtime.to_numpy(v) for kk, v in planes.items()})
        if progress is not None:
            progress(int(b * 100 / f_total))
    return {kk: np.concatenate([o[kk] for o in outs],
                               axis=0 if outs[0][kk].ndim == 1 else 1)
            for kk in outs[0]}
