"""Kernel E: the whole ATRAC1 rate control per channel-frame.

Counterpart of ``atracdenc_tpu/ops/pallas_alloc.py::at1_allocate_block``.
The CUDA kernel is ``csrc/at1_alloc.cu`` (one thread per channel-frame,
frame-minor inputs, the tables passed in as device tensors); its plain
version, ``at1_allocate_torch``, is ``models/atrac1/bitalloc.allocate``,
the JAX package's XLA path.  Both are bit-equal.
"""
import torch

from atracdenc_tpu_torch import kernels
from atracdenc_tpu_torch.models.atrac1 import bitalloc

NB = 52

# launches of the CUDA kernel (the plain version is not counted)
launches = 0


def at1_allocate_torch(sfi, energy, short_flags, loudness, bfu_idx_const=0):
    """Plain version; arguments and result as ``at1_allocate_block``."""
    return bitalloc.allocate(sfi, energy, short_flags, loudness, bfu_idx_const)


def at1_allocate_block(sfi, energy, short_flags, loudness, bfu_idx_const=0):
    """ATRAC1 rate control (bisection, BFU-shrink rounds, booster) for a
    batch of channel-frames.

    sfi [..., 52] int, energy [..., 52] f32, short_flags [..., 3] bool,
    loudness [...] f32 (Loudness / LoudFactor); bfu_idx_const 0 (auto) or
    1..8.  Returns (bfu_idx [...] int32, wordlen [..., 52] int32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    if sfi.device.type == "cpu":
        return at1_allocate_torch(sfi, energy, short_flags, loudness,
                                  bfu_idx_const)
    global launches
    lib = kernels.library()
    if not 0 <= bfu_idx_const <= 8:
        raise ValueError(f"at1_allocate_block: bfu_idx_const {bfu_idx_const} "
                         "not in 0..8")
    lead = tuple(loudness.shape)
    n = loudness.numel()

    def frame_minor(x, dtype, tail):         # [..., *tail] -> [*tail, n]
        if tuple(x.shape) != lead + tail:
            raise ValueError(f"at1_allocate_block: got shape {tuple(x.shape)}"
                             f", expected {lead + tail}")
        return x.reshape((n,) + tail).to(dtype).permute(
            *range(1, len(tail) + 1), 0).contiguous()

    ins = [frame_minor(sfi, torch.int32, (NB,)),
           frame_minor(energy, torch.float32, (NB,)),
           frame_minor(short_flags, torch.uint8, (3,)),
           frame_minor(loudness, torch.float32, ())]
    c = bitalloc.consts(sfi.device)
    tabs = [c[k] for k in ("ath", "fix_long", "fix_short", "band", "specs",
                           "amount", "boost_bits", "boost_pos")]
    wl = torch.empty((NB, n), dtype=torch.int32, device=sfi.device)
    idx = torch.empty(n, dtype=torch.int32, device=sfi.device)
    kernels.require_cuda("at1_allocate_block", *ins, *tabs, wl, idx)
    kernels.check(lib.atrac1_allocate(
        *[t.data_ptr() for t in ins + tabs], len(bitalloc.BOOST_ENTRIES),
        wl.data_ptr(), idx.data_ptr(), n, bfu_idx_const,
        kernels.stream_ptr(sfi)), "at1_allocate_block")
    launches += 1
    return idx.reshape(lead), wl.t().reshape(lead + (NB,))
