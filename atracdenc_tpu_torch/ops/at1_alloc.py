"""Kernel E: the whole ATRAC1 rate control per channel-frame.

Counterpart of ``atracdenc_tpu/ops/pallas_alloc.py::at1_allocate_block``.
The CUDA kernel is ``csrc/at1_alloc.cu`` (one warp per channel-frame, on
the encoder's row-major planes as they are, the tables passed in as device
tensors); its plain version, ``at1_allocate_torch``, is
``models/atrac1/bitalloc.allocate``, the JAX package's XLA path.  Both are
bit-equal.
"""
import functools

import torch

from atracdenc_tpu_torch import kernels, trace
from atracdenc_tpu_torch.models.atrac1 import bitalloc

NB = 52


def at1_allocate_torch(sfi, energy, short_flags, loudness, bfu_idx_const=0):
    """Plain version; arguments and result as ``at1_allocate_block``."""
    return bitalloc.allocate(sfi, energy, short_flags, loudness, bfu_idx_const)


@functools.lru_cache(maxsize=None)
def _table_ptrs(dev):
    """The kernel's tables (``bitalloc.consts``, checked once) as pointers."""
    c = bitalloc.consts(dev)
    tabs = [c[k] for k in ("ath", "fix_long", "fix_short", "band", "specs",
                           "amount", "boost_bits", "boost_pos")]
    kernels.require_cuda("at1_allocate_block", *tabs)
    return tuple(t.data_ptr() for t in tabs)


def rows(sfi, energy, short_flags, loudness):
    """The inputs as kernel E reads them: (sfi [n, 52] i32, energy [n, 52]
    f32, flags, flags_stride, loud, loud_channels, loud_frames), each
    tensor contiguous.  Row r's short flags are the 3 bytes at
    ``flags[r * flags_stride:]`` and its loudness is
    ``loud[r // (C * F) * F + r % F]`` for C = loud_channels and F =
    loud_frames.

    The encoder's tensors pass with no copy: sfi and energy row-major;
    short_flags contiguous bool [..., 3], or one [3] row broadcast over
    every frame (fixed windows, ``encoder._fixed_masks``: flags_stride 0);
    loudness [..., C, F] broadcast over its channel axis C (stride 0) or
    contiguous (C = 1, F = n).  Any other layout or dtype is copied into
    these forms first."""
    lead = tuple(loudness.shape)
    n = loudness.numel()
    for x, tail in ((sfi, (NB,)), (energy, (NB,)), (short_flags, (3,))):
        if tuple(x.shape) != lead + tail:
            raise ValueError(f"at1_allocate_block: got shape {tuple(x.shape)}"
                             f", expected {lead + tail}")
    sfi = sfi.to(torch.int32).contiguous()
    energy = energy.to(torch.float32).contiguous()

    flags = short_flags if short_flags.dtype in (torch.bool, torch.uint8) \
        else short_flags.to(torch.bool)
    if flags.is_contiguous():
        flags_stride = 3
    elif flags.stride(-1) == 1 and not any(flags.stride()[:-1]):
        flags, flags_stride = flags.as_strided((3,), (1,)), 0
    else:
        flags, flags_stride = flags.contiguous(), 3

    loud = loudness.to(torch.float32)
    if loud.is_contiguous():
        channels, frames = 1, n
    elif loud.dim() >= 2 and loud.stride(-2) == 0 \
            and loud.select(-2, 0).is_contiguous():
        loud, channels, frames = loud.select(-2, 0), lead[-2], lead[-1]
    else:
        loud, channels, frames = loud.contiguous(), 1, n
    return sfi, energy, flags, flags_stride, loud, channels, frames


def at1_allocate_block(sfi, energy, short_flags, loudness, bfu_idx_const=0):
    """ATRAC1 rate control (bisection, BFU-shrink rounds, booster) for a
    batch of channel-frames.

    sfi [..., 52] int, energy [..., 52] f32, short_flags [..., 3] bool,
    loudness [...] f32 (Loudness / LoudFactor); bfu_idx_const 0 (auto) or
    1..8.  Returns (bfu_idx [...] int32, wordlen [..., 52] int32).

    The kernel reads the encoder's tensors in place, the broadcast
    loudness and fixed-window flags included, and writes the returned
    tensors itself (``rows`` gives the layouts; no copy, no cast, no
    transpose).  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    if sfi.device.type == "cpu":
        return at1_allocate_torch(sfi, energy, short_flags, loudness,
                                  bfu_idx_const)
    lib = kernels.library()
    if not 0 <= bfu_idx_const <= 8:
        raise ValueError(f"at1_allocate_block: bfu_idx_const {bfu_idx_const} "
                         "not in 0..8")
    sfi, energy, flags, flags_stride, loud, channels, frames = rows(
        sfi, energy, short_flags, loudness)
    lead = tuple(loudness.shape)
    dev = sfi.device
    wl = torch.empty(lead + (NB,), dtype=torch.int32, device=dev)
    idx = torch.empty(lead, dtype=torch.int32, device=dev)
    # the kernel reads scalars: element alignment is enough
    kernels.require_cuda("at1_allocate_block", sfi, energy, flags, loud, wl,
                         idx, align=1)
    kernels.check(lib.atrac1_allocate(
        sfi.data_ptr(), energy.data_ptr(), flags.data_ptr(), loud.data_ptr(),
        *_table_ptrs(dev), len(bitalloc.BOOST_ENTRIES), wl.data_ptr(),
        idx.data_ptr(), idx.numel(), bfu_idx_const, flags_stride, channels,
        frames, kernels.stream_ptr(sfi)), "at1_allocate_block")
    trace.count("launch.at1_alloc")
    return idx, wl
