"""Kernel C: the full ATRAC3 rate-control loop per channel-frame.

Counterpart of ``atracdenc_tpu/ops/pallas_rate.py::rate_control_block``.
The CUDA kernel is ``csrc/rate_control.cu`` (one thread per channel-frame,
frame-minor inputs); its plain version, ``rate_control_torch``, is the
XLA path of ``atracdenc_tpu/models/atrac3/bitalloc.py::allocate``
(:451-476): the batched bisection, the energy boost and the shrink loop
written with the tensor ops of ``models/atrac3/bitalloc.py``.  Both are
bit-equal: every float op is elementwise in one order, every sum integer.
"""
import functools

import torch

from atracdenc_tpu_torch.shared import tables as T
from atracdenc_tpu_torch import kernels

MAX_WL = 8

# launches of the CUDA kernel (the plain version is not counted)
launches = 0


@functools.lru_cache(maxsize=None)
def _consts(dev):
    return {"fix": torch.as_tensor(T.FIXED_BIT_ALLOC.astype("float32"), device=dev),
            "xdiv": torch.as_tensor(T.SFI_DIVISOR, device=dev)}


def rate_control_torch(csfi, gated, tonal_counts, spread, target, num_bfu,
                       err, clc, vlc, t_active, t_pos, t_len, t_bfu, t_vlc,
                       auto=True):
    """Plain version; arguments and result as ``rate_control_block``."""
    from atracdenc_tpu_torch.models.atrac3 import bitalloc, tonal

    planes = {"active": t_active > 0, "start": t_pos, "len": t_len,
              "bfu": t_bfu, "vlc_cost": t_vlc}
    return bitalloc.allocate_torch(
        {"err": err, "clc": clc, "vlc": vlc}, csfi, gated, spread, target,
        num_bfu, tonal_counts, tonal.make_cost_fn(planes), auto)


def rate_control_block(csfi, gated, tonal_counts, spread, target, num_bfu,
                       err, clc, vlc, t_active, t_pos, t_len, t_bfu, t_vlc,
                       auto=True):
    """Rate control for a batch of channel-frames.

    csfi [..., 32] f32, gated [..., 32] bool, tonal_counts [..., 32] i32,
    spread [...] f32, target / num_bfu [...] i32, err [..., 32, 8] f32,
    clc / vlc [..., 32, 8] i32, tonal planes t_active / t_pos / t_len /
    t_bfu [..., 32] i32 and t_vlc [..., 32, 8] i32.  auto=False freezes
    num_bfu (--bfuidxconst).  Returns (num_bfu [...] i32, mode [...] bool
    (1 = CLC), wl [..., 32] i32).

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    if csfi.device.type == "cpu":
        return rate_control_torch(csfi, gated, tonal_counts, spread, target,
                                  num_bfu, err, clc, vlc, t_active, t_pos,
                                  t_len, t_bfu, t_vlc, auto)
    global launches
    lib = kernels.library()
    lead = tuple(spread.shape)
    n = spread.numel()

    def frame_minor(x, dtype, tail):         # [..., *tail] -> [*tail, n]
        if tuple(x.shape) != lead + tail:
            raise ValueError(f"rate_control_block: got shape {tuple(x.shape)}"
                             f", expected {lead + tail}")
        return x.reshape((n,) + tail).to(dtype).permute(
            *range(1, len(tail) + 1), 0).contiguous()

    def per_bfu(x, dtype):
        return frame_minor(x, dtype, (32,))

    def memo(x, dtype):
        return frame_minor(x, dtype, (32, MAX_WL))

    def scalar(x, dtype):
        return frame_minor(x, dtype, ())

    i32, f32 = torch.int32, torch.float32
    ins = [per_bfu(csfi, f32), per_bfu(gated, torch.uint8),
           per_bfu(tonal_counts, i32), scalar(spread, f32),
           scalar(target, i32), scalar(num_bfu, i32), memo(err, f32),
           memo(clc, i32), memo(vlc, i32), per_bfu(t_active, i32),
           per_bfu(t_pos, i32), per_bfu(t_len, i32), per_bfu(t_bfu, i32),
           memo(t_vlc, i32)]
    c = _consts(csfi.device)
    wl = torch.empty((32, n), dtype=i32, device=csfi.device)
    nb = torch.empty(n, dtype=i32, device=csfi.device)
    mode = torch.empty(n, dtype=torch.uint8, device=csfi.device)
    outs = [wl, nb, mode]
    kernels.require_cuda("rate_control_block", *ins, c["fix"], c["xdiv"], *outs)
    kernels.check(lib.atrac3_rate_control(
        *[t.data_ptr() for t in ins], c["fix"].data_ptr(),
        c["xdiv"].data_ptr(), *[t.data_ptr() for t in outs], n,
        1 if auto else 0, kernels.stream_ptr(csfi)), "rate_control_block")
    launches += 1
    return (nb.reshape(lead), mode.reshape(lead).bool(),
            wl.t().reshape(lead + (32,)))
