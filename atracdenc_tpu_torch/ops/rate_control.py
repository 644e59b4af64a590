"""Kernels C and F: the ATRAC3 rate control per channel-frame.

* C, ``rate_control_block``: counterpart of
  ``atracdenc_tpu/ops/pallas_rate.py::rate_control_block``.  The CUDA
  kernel is ``csrc/rate_control.cu`` (one warp per channel-frame, on the
  encoder's frame-major planes as they are); its plain version,
  ``rate_control_torch``, is the XLA path of
  ``atracdenc_tpu/models/atrac3/bitalloc.py::allocate`` (:451-476): the
  batched bisection, the energy boost and the shrink loop written with the
  tensor ops of ``models/atrac3/bitalloc.py``.
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
from atracdenc_tpu_torch import kernels, trace

MAX_WL = 8


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


def _planes(name, csfi, gated, tonal_counts, spread, target, num_bfu, err,
            clc, vlc, t_active, t_pos, t_len, t_bfu, t_vlc):
    """The 14 inputs of kernels C and F in the encoder's frame-major layout
    ([..., 32], [..., 32, 8], [...]), then the tables fix and xdiv; and
    clc's frame stride.  Inputs of the kernel's dtype and layout pass as
    they are, and clc may be one [32, 8] table broadcast over the frames
    (as ``quant_tensors`` gives it), which the kernel reads in place."""
    lead = tuple(spread.shape)

    def plane(x, dtype, tail):
        if tuple(x.shape) != lead + tail:
            raise ValueError(f"{name}: got shape {tuple(x.shape)}, expected "
                             f"{lead + tail}")
        return x.to(dtype).contiguous()

    i32, f32 = torch.int32, torch.float32
    b, m, s = (32,), (32, MAX_WL), ()
    if tuple(clc.shape) == lead + m and clc.dtype == i32 \
            and clc.stride()[-2:] == (MAX_WL, 1) and not any(clc.stride()[:-2]):
        clc, clc_stride = clc.as_strided(m, (MAX_WL, 1)), 0
    else:
        clc, clc_stride = plane(clc, i32, m), 32 * MAX_WL
    c = _consts(csfi.device)
    return [plane(csfi, f32, b), plane(gated, torch.bool, b),
            plane(tonal_counts, i32, b), plane(spread, f32, s),
            plane(target, i32, s), plane(num_bfu, i32, s), plane(err, f32, m),
            clc, plane(vlc, i32, m), plane(t_active, i32, b),
            plane(t_pos, i32, b), plane(t_len, i32, b), plane(t_bfu, i32, b),
            plane(t_vlc, i32, m), c["fix"], c["xdiv"]], clc_stride


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
    lib = kernels.library()
    lead = tuple(spread.shape)
    ins, clc_stride = _planes("bisect_block", *args)
    wl = torch.empty(lead + (32,), dtype=torch.int32, device=csfi.device)
    kernels.require_cuda("bisect_block", *ins, wl)
    kernels.check(lib.atrac3_bisect(
        *[t.data_ptr() for t in ins], wl.data_ptr(), spread.numel(),
        clc_stride, kernels.stream_ptr(csfi)), "bisect_block")
    trace.count("launch.bisect")
    return wl


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
    lib = kernels.library()
    lead = tuple(spread.shape)
    ins, clc_stride = _planes("rate_control_block", csfi, gated, tonal_counts,
                              spread, target, num_bfu, err, clc, vlc, t_active,
                              t_pos, t_len, t_bfu, t_vlc)
    dev = csfi.device
    wl = torch.empty(lead + (32,), dtype=torch.int32, device=dev)
    nb = torch.empty(lead, dtype=torch.int32, device=dev)
    mode = torch.empty(lead, dtype=torch.bool, device=dev)
    kernels.require_cuda("rate_control_block", *ins, wl, nb, mode)
    kernels.check(lib.atrac3_rate_control(
        *[t.data_ptr() for t in ins], wl.data_ptr(), nb.data_ptr(),
        mode.data_ptr(), spread.numel(), clc_stride, 1 if auto else 0,
        kernels.stream_ptr(csfi)), "rate_control_block")
    trace.count("launch.rate_control")
    return nb, mode, wl
