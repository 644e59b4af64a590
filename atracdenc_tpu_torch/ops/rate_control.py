"""Kernels C and F: the ATRAC3 rate control per channel-frame.

* C, ``rate_control_block``: counterpart of
  ``atracdenc_tpu/ops/pallas_rate.py::rate_control_block``.  The CUDA
  kernel is ``csrc/rate_control.cu`` (one thread per channel-frame,
  frame-minor inputs); its plain version, ``rate_control_torch``, is the
  XLA path of ``atracdenc_tpu/models/atrac3/bitalloc.py::allocate``
  (:451-476): the batched bisection, the energy boost and the shrink loop
  written with the tensor ops of ``models/atrac3/bitalloc.py``.
* F, ``bisect_block``: counterpart of
  ``atracdenc_tpu/ops/pallas_alloc.py::bisect_block``, one lambda
  bisection at a fixed num_bfu (C's first round with the shrink off).  The
  CUDA kernel is ``csrc/bisect.cu``, on C's evaluation
  (``csrc/rate_eval.cuh``); its plain version, ``bisect_torch``, is
  ``bitalloc._bisect``.  No encoder path calls it, as in the JAX package.

Kernels and plain versions are bit-equal: every float op is elementwise in
one order, every sum integer.
"""
import functools

import torch

from atracdenc_tpu_torch.models.atrac3 import tables as T
from atracdenc_tpu_torch import kernels

MAX_WL = 8

# launches of the CUDA kernels C and F (the plain versions are not counted)
launches = 0
bisect_launches = 0


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


def bisect_torch(csfi, gated, tonal_counts, spread, target, num_bfu, err,
                 clc, vlc, t_active, t_pos, t_len, t_bfu, t_vlc):
    """Plain version; arguments and result as ``bisect_block``."""
    from atracdenc_tpu_torch.models.atrac3 import bitalloc, tonal

    planes = {"active": t_active > 0, "start": t_pos, "len": t_len,
              "bfu": t_bfu, "vlc_cost": t_vlc}
    return bitalloc._bisect(csfi, gated, spread, num_bfu.to(torch.int32),
                            tonal_counts, tonal.make_cost_fn(planes),
                            {"err": err, "clc": clc, "vlc": vlc}, target)


def _frame_minor(name, csfi, gated, tonal_counts, spread, target, num_bfu,
                 err, clc, vlc, t_active, t_pos, t_len, t_bfu, t_vlc):
    """The 14 inputs of kernels C and F in their frame-minor layout
    ([..., *tail] -> [*tail, n]) and dtypes, then the tables fix and xdiv."""
    lead = tuple(spread.shape)
    n = spread.numel()

    def fm(x, dtype, tail):
        if tuple(x.shape) != lead + tail:
            raise ValueError(f"{name}: got shape {tuple(x.shape)}, expected "
                             f"{lead + tail}")
        return x.reshape((n,) + tail).to(dtype).permute(
            *range(1, len(tail) + 1), 0).contiguous()

    i32, f32, u8 = torch.int32, torch.float32, torch.uint8
    b, m, s = (32,), (32, MAX_WL), ()
    c = _consts(csfi.device)
    return [fm(csfi, f32, b), fm(gated, u8, b), fm(tonal_counts, i32, b),
            fm(spread, f32, s), fm(target, i32, s), fm(num_bfu, i32, s),
            fm(err, f32, m), fm(clc, i32, m), fm(vlc, i32, m),
            fm(t_active, i32, b), fm(t_pos, i32, b), fm(t_len, i32, b),
            fm(t_bfu, i32, b), fm(t_vlc, i32, m), c["fix"], c["xdiv"]]


def bisect_block(csfi, gated, tonal_counts, spread, target, num_bfu, err,
                 clc, vlc, t_active, t_pos, t_len, t_bfu, t_vlc):
    """One lambda bisection at a fixed num_bfu for a batch of channel-frames.

    Arguments as ``rate_control_block``.  Returns wl [..., 32] i32, the
    energy-boosted wordlens at the best lambda under the budget (equal to
    ``rate_control_block(..., auto=False)``'s wl).

    A CPU tensor takes the plain version; a CUDA tensor launches kernel F
    (or raises)."""
    args = (csfi, gated, tonal_counts, spread, target, num_bfu, err, clc,
            vlc, t_active, t_pos, t_len, t_bfu, t_vlc)
    if csfi.device.type == "cpu":
        return bisect_torch(*args)
    global bisect_launches
    lib = kernels.library()
    lead = tuple(spread.shape)
    n = spread.numel()
    ins = _frame_minor("bisect_block", *args)
    wl = torch.empty((32, n), dtype=torch.int32, device=csfi.device)
    kernels.require_cuda("bisect_block", *ins, wl)
    kernels.check(lib.atrac3_bisect(
        *[t.data_ptr() for t in ins], wl.data_ptr(), n,
        kernels.stream_ptr(csfi)), "bisect_block")
    bisect_launches += 1
    return wl.t().reshape(lead + (32,))


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
    ins = _frame_minor("rate_control_block", csfi, gated, tonal_counts, spread,
                       target, num_bfu, err, clc, vlc, t_active, t_pos, t_len,
                       t_bfu, t_vlc)
    i32 = torch.int32
    wl = torch.empty((32, n), dtype=i32, device=csfi.device)
    nb = torch.empty(n, dtype=i32, device=csfi.device)
    mode = torch.empty(n, dtype=torch.uint8, device=csfi.device)
    outs = [wl, nb, mode]
    kernels.require_cuda("rate_control_block", *ins, *outs)
    kernels.check(lib.atrac3_rate_control(
        *[t.data_ptr() for t in ins], *[t.data_ptr() for t in outs], n,
        1 if auto else 0, kernels.stream_ptr(csfi)), "rate_control_block")
    launches += 1
    return (nb.reshape(lead), mode.reshape(lead).bool(),
            wl.t().reshape(lead + (32,)))
