"""ATRAC1 encoder in PyTorch, batched over streams, channels and frames.

Port of ``atracdenc_tpu/models/atrac1/encoder.py`` (reference call stack
src/atrac1denc.cpp:180-255): QMF analysis -> per-band transient detection
-> windowed MDCT -> loudness IIR -> block-floating scale -> bit allocation
(kernel E) -> mantissas.  The output is a dict of fixed-shape integer
planes; ``frame.pack`` on the host or ``device_pack.pack_device``
on the device serialises them into 212-byte sound units.

Where JAX vmaps over streams, the port takes an optional leading stream
axis: pcm [C, T] or [S, C, T], planes [..., C, F, ...].
"""
import functools

import torch

from atracdenc_tpu_torch.models.atrac1 import tables as T
from atracdenc_tpu_torch import runtime, trace
from atracdenc_tpu_torch.ops import psy, scale as scale_ops
from atracdenc_tpu_torch.ops.at1_alloc import at1_allocate_block
from atracdenc_tpu_torch.ops.transient import transient_mask
from .. import track
from . import bitalloc, filterbank
from .mdct import mdct_frames

CHUNK_LEFT = 3    # context frames: QMF-tree FIR reach (~140 samples) +
                  # MDCT prev-half + transient prev-block, each <= 1 frame
CHUNK_RIGHT = 1   # the transient HPF reads 1 sample past the frame
PER_FRAME = ()    # planes without a channel axis: none (models/track.py)


@functools.lru_cache(maxsize=None)
def _consts(dev):
    return {"loud_curve": torch.as_tensor(
                psy.create_loudness_curve(T.NUM_SAMPLES), device=dev),
            "mask": torch.as_tensor(T.GATHER_MASK, device=dev),
            "scale": torch.as_tensor(T.SCALE_TABLE, device=dev),
            "band": torch.as_tensor(T.BFU_TO_BAND, device=dev).long(),
            # a device tensor, so CUDA divides exactly (it multiplies by
            # the reciprocal of a host scalar)
            "loud_factor": torch.tensor(T.LOUD_FACTOR, dtype=torch.float32,
                                        device=dev)}


def _invert_spectrum(x):
    """Negate even-indexed samples (util.h:51-63); frames are even-length,
    so the per-frame pattern is the whole-track pattern."""
    sign = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    sign[0::2] = -1.0
    return x * sign


def _blocks_static(specs, start_tab):
    """[..., 512] -> [..., 52, 20] padded BFU blocks of one static line
    layout: every BFU's lines are a contiguous run."""
    parts = []
    for b in range(T.MAX_BFUS):
        s, n = int(start_tab[b, 0]), int(T.SPECS_PER_BLOCK[b])
        parts.append(torch.nn.functional.pad(specs[..., s:s + n], (0, 20 - n)))
    return torch.stack(parts, dim=-2)


@trace.span("bfu_gather")
def gather_bfu_blocks(specs, short_flags):
    """[..., 512] spectra -> padded BFU blocks [..., 52, 20]; short_flags
    [..., 3] bool per band selects the short or long line layout
    (atrac_scale.cpp:175-188)."""
    k = _consts(specs.device)
    short_per_bfu = short_flags[..., k["band"]]              # [..., 52]
    return torch.where(short_per_bfu[..., None],
                       _blocks_static(specs, T.GATHER_SHORT),
                       _blocks_static(specs, T.GATHER_LONG)) * k["mask"]


def _fixed_masks(window_mask, shape, dev):
    m = runtime.from_host([bool(window_mask & 1), bool(window_mask & 2),
                           bool(window_mask & 4)], dev)
    return m.expand(shape + (3,))


def _encode_specs(specs, masks, loud_init, bfu_idx_const, use_rate_kernel):
    """Spectra [..., C, F, 512] and window masks [..., C, F, 3] -> (planes,
    raw loudness track [..., F]): the loudness IIR, scaling, rate control
    (kernel E, or ``bitalloc.allocate`` with ``use_rate_kernel=False``) and
    the mantissas."""
    k = _consts(specs.device)
    c = specs.shape[-3]
    # loudness IIR across frames (atrac1denc.cpp:235-247): stereo averages
    # both channels while neither is in short windows, else channel 0 alone
    frame_loud = torch.sum(specs * specs * k["loud_curve"], dim=-1)
    mask_any = torch.any(masks, dim=-1)                        # [..., C, F]
    if c == 2:
        use_both = ~mask_any[..., 0, :] & ~mask_any[..., 1, :]
        use_one = ~mask_any[..., 0, :] & ~use_both
        l0, l1 = frame_loud[..., 0, :], frame_loud[..., 1, :]
    else:
        use_both = torch.zeros_like(mask_any[..., 0, :])
        use_one = ~mask_any[..., 0, :]
        l0 = frame_loud[..., 0, :]
        l1 = torch.zeros_like(l0)
    loud = psy.track_loudness_scan(l0, l1, use_both, use_one, loud_init)
    loudness = (loud / k["loud_factor"])[..., None, :].expand(mask_any.shape)

    blocks = gather_bfu_blocks(specs, masks)                  # [..., 52, 20]
    sfi, scaled, energy = scale_ops.scale_blocks(blocks, k["mask"], k["scale"])
    alloc = at1_allocate_block if use_rate_kernel else bitalloc.allocate
    with trace.span("rate_control"):
        bfu_idx, wordlen = alloc(sfi, energy, masks, loudness,
                                 bfu_idx_const=bfu_idx_const)
    mant = scale_ops.quant_mantissas(scaled, wordlen)
    # operator feedback: |spec| > 1 is where the reference clamps and warns
    # (atrac_scale.cpp:150-167); counted here instead of printed per value
    absb = torch.abs(blocks)
    planes = {
        "short_mask": masks,
        "bfu_idx": bfu_idx,
        "wordlen": wordlen,
        "sfi": sfi,
        "mant": mant,
        "clip_count": torch.sum(absb > 1.0, dim=(-1, -2), dtype=torch.int32),
        "clip_max": torch.amax(absb, dim=(-1, -2)),
    }
    return planes, loud


def encode_frames(pcm, bfu_idx_const=0, window_mode="auto", window_mask=0,
                  use_rate_kernel=True):
    """[..., C, T] PCM (T a multiple of 512) -> frame planes: short_mask
    [..., C, F, 3] bool, bfu_idx [..., C, F], wordlen / sfi [..., C, F, 52],
    mant [..., C, F, 52, 20] (int32), clip_count / clip_max [..., C, F]: the
    whole track as one chunk of ``encode_frames_chunk``.

    ``use_rate_kernel=False`` runs the rate control as tensor ops
    (``bitalloc.allocate``, the JAX package's ``use_pallas=False`` XLA path)
    on the tensors' device instead of kernel E; the bytes are the same."""
    return encode_frames_chunk(pcm, None, None, bfu_idx_const, window_mode,
                               window_mask, use_rate_kernel)[0]


def _encode_window(pcm_ext, loud_init, bfu_idx_const, window_mode,
                   window_mask, first, use_rate_kernel):
    """Chunk core: pcm_ext [..., C, (CHUNK_LEFT + f + 1) * 512] -> (planes
    of the f content frames, raw loudness carry [...]).  The context frames
    pin the filterbank, transient and MDCT couplings; the loudness IIR
    enters through loud_init.  first=True takes the track-start transient
    semantics (the reference's first LastEnergy is 0 dB,
    transient_detector.h:41) over content and lookahead only."""
    lead = pcm_ext.shape[:-1]
    fe = pcm_ext.shape[-1] // T.NUM_SAMPLES
    f = fe - CHUNK_LEFT - CHUNK_RIGHT
    with trace.span("qmf_analysis"):
        low, mid, hi = filterbank.analysis(pcm_ext)
    with trace.span("transient_masks"):
        if window_mode == "auto":
            if first:
                c2, c4 = CHUNK_LEFT * 128, CHUNK_LEFT * 256
                m = [transient_mask(low[..., c2:], 128),
                     transient_mask(_invert_spectrum(mid[..., c2:]), 128),
                     transient_mask(_invert_spectrum(hi[..., c4:]), 256)]
            else:
                m = [transient_mask(low, 128),
                     transient_mask(_invert_spectrum(mid), 128),
                     transient_mask(_invert_spectrum(hi), 256)]
                m = [x[..., CHUNK_LEFT:] for x in m]
            masks_cl = torch.stack(m, dim=-1)             # [..., C, f+1, 3]
        else:
            masks_cl = _fixed_masks(window_mask, lead + (f + 1,),
                                    pcm_ext.device)
    masks = masks_cl[..., :f, :]

    # MDCT with one warm-up frame whose stored half seeds the overlap (its
    # own mask only selects its dropped output, so False is fine)
    warm = torch.zeros(lead + (1,), dtype=torch.bool, device=pcm_ext.device)

    def band_specs(sig, fsz, col, band):
        bf = sig.reshape(lead + (fe, fsz))[..., CHUNK_LEFT - 1:CHUNK_LEFT + f, :]
        m = torch.cat([warm, masks[..., col]], dim=-1)
        return mdct_frames(bf, m, band)[..., 1:, :]

    with trace.span("mdct"):
        specs = torch.cat([band_specs(low, 128, 0, 0),
                           band_specs(mid, 128, 1, 1),
                           band_specs(hi, 256, 2, 2)], dim=-1)
    planes, loud = _encode_specs(specs, masks, loud_init, bfu_idx_const,
                                 use_rate_kernel)
    return planes, loud[..., -1]


@trace.span("at1.encode_chunk")
def encode_frames_chunk(pcm, state=None, next_head=None, bfu_idx_const=0,
                        window_mode="auto", window_mask=0,
                        use_rate_kernel=True):
    """Exact chunked encode: pcm [..., C, k*512]; state = the previous
    chunk's carry ``{"pcm_tail": [..., C, 1536], "loud": [...]}`` (None at
    track start); next_head [..., C, 512] = the next chunk's first frame
    (None at track end).  Concatenated chunk planes equal the planes of the
    whole track as one chunk (``encode_frames``).  Returns (planes,
    new_state)."""
    hist_len = CHUNK_LEFT * T.NUM_SAMPLES
    k = pcm.shape[-1]
    if state is None:
        hist = torch.zeros(pcm.shape[:-1] + (hist_len,), dtype=pcm.dtype,
                           device=pcm.device)
        loud_init = T.LOUD_FACTOR
    else:
        hist, loud_init = state["pcm_tail"], state["loud"]
    tail = (torch.zeros(pcm.shape[:-1] + (T.NUM_SAMPLES,), dtype=pcm.dtype,
                        device=pcm.device) if next_head is None else next_head)
    with trace.span("chunk_cat"):
        ext = torch.cat([hist, pcm, tail], dim=-1)
    planes, loud_last = _encode_window(ext, loud_init, bfu_idx_const,
                                       window_mode, window_mask,
                                       state is None, use_rate_kernel)
    return planes, {"pcm_tail": ext[..., k:hist_len + k], "loud": loud_last}


def encode_track(pcm, bfu_idx_const=0, window_mode="auto", window_mask=0,
                 chunk_frames=2048, progress=None, device=None):
    """NumPy wrapper: [C, T] PCM -> numpy planes [C, F, ...], the track in
    chunks of ``chunk_frames`` through ``encode_frames_chunk``
    (``models/track.py``).  On the CPU the planes do not depend on
    ``chunk_frames``, and tests hold that; on the card a chunk's shape can
    move a float across a decision.  device: "cuda" (the default) or an
    explicit "cpu".  progress: optional callback(percent) after each
    chunk."""
    def chunk(x, state, nxt):
        return encode_frames_chunk(x, state, nxt, bfu_idx_const, window_mode,
                                   window_mask)
    return track.encode_track(chunk, pcm, T.NUM_SAMPLES, chunk_frames,
                              PER_FRAME, "at1.track_chunk", progress, device)
