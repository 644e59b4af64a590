"""ATRAC3 encoder in PyTorch, batched over streams, channels and frames.

Port of ``atracdenc_tpu/models/atrac3/encoder.py`` (reference call stack
src/atrac3denc.cpp:679-867): QMF analysis (4 bands) -> [gain control] ->
windowed MDCT with gain modulation -> loudness IIR -> [tonal extraction] ->
block-floating scale -> quantisation-cost memo -> rate control ->
mantissas.  The output is a dict of fixed-shape integer planes that the
device packer (``device_pack.py``, through ``encode_frames_bytes``) or the
JAX package's host packer (``atracdenc_tpu/models/atrac3/frame.py``)
serialises into sound units.

Where JAX vmaps over streams, the port takes an optional leading stream
axis: pcm [C, T] or [S, C, T].  Stages that treat channels alike run on
the flattened [S*C, ...] axis.
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch.models.atrac3 import tables as T
from atracdenc_tpu_torch import runtime, trace
from atracdenc_tpu_torch.ops import psy, scale as scale_ops
from .. import track
from . import device_pack, filterbank, gain, specblocks, tonal
from .bitalloc import allocate, final_mantissas, quant_tensors
from .mdct import first_level_scale, gain_divisors, mdct_frames

_LOUD_CURVE = psy.create_loudness_curve(1024)
PER_FRAME = ("loudness", "ms_shift")   # [..., F]; others [..., C, F, ...]


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


@trace.span("ms_matrix")
def ms_matrix(bands, next_head):
    """M/S matrixing in the band-sample domain (atrac3denc.cpp:665-677):
    channel 0 of [S, 2, ...] becomes (L + R) / 2, channel 1 (L - R) / 2;
    of the chunk's band samples and of the look-ahead head alike."""
    def ms(x):
        return torch.stack([(x[:, 0] + x[:, 1]) * 0.5,
                            (x[:, 0] - x[:, 1]) * 0.5], dim=1)
    return ms(bands), ms(next_head)


def calc_ms_shift(frame_loud, header_bits, frame_bytes):
    """CalcMSBytesShift (atrac3_bitstream.cpp:800-828): the bytes a JS
    frame moves from the side channel to the mid channel, set by mid's
    share of the frame's loudness and bounded by what the headers leave.
    frame_loud f32 [S, C, F], header_bits int32 [S, C, F] -> int32 [S, F];
    a mono input's empty side channel gets the minimum."""
    c = frame_loud.shape[1]
    half = frame_bytes // 2
    h1 = header_bits[:, 1] if c == 2 else 14 + 2 + 3
    total_used = 12 + header_bits[:, 0] + h1
    max_shift = half - (1 + torch.div(total_used - 1, 8,
                                      rounding_mode="floor"))
    if c == 1:
        return max_shift.to(torch.int32)
    total_loud = frame_loud[:, 0] + frame_loud[:, 1]
    ratio = torch.where(total_loud > 0,
                        frame_loud[:, 0] / total_loud - 0.5, 0.0)
    return torch.clamp(torch.round(frame_bytes * ratio).to(torch.int32),
                       -max_shift, max_shift)


def channel_targets(ms_shift, header_bits, frame_bytes):
    """Each channel's bit target, 8 * (frame_bytes / 2 +- ms_shift) less
    its header and 6 bits, at least 1: ms_shift int32 [S, F], header_bits
    [S, C, F] -> int32 [S * C, F]."""
    s, c, f = header_bits.shape
    shift_per_ch = torch.stack([ms_shift, -ms_shift], dim=1)[:, :c]
    return torch.clamp(8 * (frame_bytes // 2 + shift_per_ch) - 6
                       - header_bits, min=1).to(torch.int32).reshape(s * c, f)


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
                  no_tonal=True, bfu_idx_const=0, use_rate_kernel=True,
                  fused_memo=False):
    """[C, T] or [S, C, T] PCM (T a multiple of 1024) -> frame planes."""
    planes, _ = encode_frames_chunk(pcm, None, None, frame_bytes, js,
                                    no_gain_control, no_tonal, bfu_idx_const,
                                    use_rate_kernel, fused_memo)
    return planes


def encode_frames_bytes(pcm, frame_bytes=384, js=False, no_gain_control=True,
                        no_tonal=True, bfu_idx_const=0, use_rate_kernel=True,
                        fused_memo=False):
    """[C, T] PCM -> [F, frame_bytes] uint8 frames, or [S, C, T] -> [S, F,
    frame_bytes], packed on the device: byte-identical to ``frame.pack`` of
    ``encode_frames``, and only the frame bytes leave the device."""
    planes = encode_frames(pcm, frame_bytes, js, no_gain_control, no_tonal,
                           bfu_idx_const, use_rate_kernel, fused_memo)
    if pcm.dim() == 3:
        return device_pack.pack_device_batch(planes, frame_bytes, js)
    return device_pack.pack_device(planes, frame_bytes, js)


@trace.span("at3.encode_chunk")
def encode_frames_chunk(pcm, state=None, next_pcm=None, frame_bytes=384,
                        js=False, no_gain_control=True, no_tonal=True,
                        bfu_idx_const=0, use_rate_kernel=True,
                        fused_memo=False):
    """Encode [..., C, T] PCM into ATRAC3 frame planes.

    ``state`` carries the exact cross-chunk recurrences (``init_state``);
    ``next_pcm`` [..., C, 1024] is the lookahead after this chunk (None at
    track end).  ``use_rate_kernel=False`` runs the tensor-op rate control
    instead of kernel C (same bytes); ``fused_memo=True`` computes the
    quantisation-cost memo in kernel D instead of kernels A and B (the JAX
    package's ``ATRACDENC_TPU_PALLAS_QUANT=1``).  Returns (planes, new_state); planes
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
    with trace.span("band_frames"):
        ext = torch.cat([st["pcm_tail"], x], dim=-1)
        bands = band_frames(ext)[:, :, 1:]                # [S, C, F, 4, 256]
        if next_pcm is None:
            next_head = torch.zeros((s, c, 4, 128), dtype=pcm.dtype,
                                    device=dev)
        else:
            la = torch.cat([x[..., -2048:], next_pcm.reshape(s, c, -1)],
                           dim=-1)
            next_head = filterbank.analysis(la * 0.25)[..., -256:-128]
    if js and c == 2:
        bands, next_head = ms_matrix(bands, next_head)
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
        with trace.span("mdct"):
            specs = mdct_frames(bands, prev_half=st["mdct_prev"])
            mdct_last = k["enc_win"] * bands[:, -1]
    else:
        gain_levels, gain_locs, gain_npoints, gain_ctx_out = gain.gain_control(
            bands, ctx=st["gain"], next_head=next_head)
        with trace.span("mdct"):
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
        with trace.span("tonal"):
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
    id_bits = runtime.from_host([14 if (js and ch == 1) else 6
                                 for ch in range(c)], dev,
                                torch.int32)[None, :, None]
    header_bits = id_bits + 2 + torch.sum(
        3 + gain_npoints.reshape(s, c, f, 4) * 9, dim=-1, dtype=torch.int32)
    if js:
        with trace.span("ms_shift"):
            ms_shift = calc_ms_shift(frame_loud, header_bits, frame_bytes)
            target = channel_targets(ms_shift, header_bits, frame_bytes)
            trace.count("at3.js_frames", s * f)
            shifted = trace.device_counter("at3.js_shift_bytes", dev)
            if shifted is not None:
                shifted.add_(torch.sum(torch.abs(ms_shift)))
    else:
        ms_shift = torch.zeros((s, f), dtype=torch.int32, device=dev)
        target = channel_targets(ms_shift, header_bits, frame_bytes)

    qt = quant_tensors(scaled, k["mask"], fused_memo)
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
                 progress=None, device=None, use_rate_kernel=True,
                 fused_memo=False):
    """NumPy wrapper: [C, T] PCM -> numpy planes, the track in chunks of
    ``chunk_frames`` through ``encode_frames_chunk`` (``models/track.py``).
    On the CPU the carry makes the planes independent of ``chunk_frames``,
    and tests hold that; on the card a chunk's shape can move a float
    across a decision.

    device: "cuda" (the default) or an explicit "cpu".
    progress: optional callback(percent) after each chunk."""
    def chunk(x, state, nxt):
        return encode_frames_chunk(x, state, nxt, frame_bytes, js,
                                   no_gain_control, no_tonal, bfu_idx_const,
                                   use_rate_kernel, fused_memo)
    return track.encode_track(chunk, pcm, T.NUM_SAMPLES, chunk_frames,
                              PER_FRAME, "at3.track_chunk", progress, device)
