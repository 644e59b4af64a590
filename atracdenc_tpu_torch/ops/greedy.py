"""Kernel B: the EA greedy-accept recurrence over |delta|-sorted candidates.

Counterpart of ``atracdenc_tpu/ops/pallas_greedy.py::greedy_scan``.  The
CUDA kernel is ``csrc/greedy.cu``; its plain version, ``greedy_torch``, is
the scan of ``atracdenc_tpu/ops/quant.py:142-155`` as a Python loop over
the candidate axis.  Both apply ``ex = (e2 - a) + b`` and
``accept = elig & (|ex - e1| < |e2 - e1|)`` in the same float order, so
they agree bit for bit.
"""
import torch

from atracdenc_tpu_torch import kernels

# launches of the CUDA kernel (the plain version is not counted)
launches = 0


def greedy_torch(a, b, elig, e1, e2):
    """Plain version.  a, b [rows, L] f32, elig [rows, L] bool, e1, e2
    [rows] f32 -> (e2_fin [rows] f32, accept [rows, L] bool)."""
    accept = torch.empty(elig.shape, dtype=torch.bool, device=a.device)
    for k in range(a.shape[-1]):
        ex = (e2 - a[:, k]) + b[:, k]
        acc = elig[:, k] & (torch.abs(ex - e1) < torch.abs(e2 - e1))
        e2 = torch.where(acc, ex, e2)
        accept[:, k] = acc
    return e2, accept


def greedy_scan(a, b, elig, e1, e2):
    """Run the recurrence; a CPU tensor takes the plain version, a CUDA
    tensor launches the kernel (or raises).  Same signature and result as
    the JAX ``greedy_scan``."""
    if a.device.type == "cpu":
        return greedy_torch(a, b, elig, e1, e2)
    global launches
    lib = kernels.library()
    rows, L = a.shape
    if a.dtype != torch.float32 or b.shape != a.shape or elig.shape != a.shape \
            or e1.shape != (rows,) or e2.shape != (rows,):
        raise ValueError("greedy_scan: need a, b, elig [rows, L] and e1, e2 "
                         "[rows] f32")
    # [L, rows]: at every step neighbouring threads read neighbouring words
    at = a.t().contiguous()
    bt = b.to(torch.float32).t().contiguous()
    et = elig.to(torch.uint8).t().contiguous()
    e1c = e1.to(torch.float32).contiguous()
    e2c = e2.to(torch.float32).contiguous()
    e2_out = torch.empty(rows, dtype=torch.float32, device=a.device)
    acc = torch.empty((L, rows), dtype=torch.uint8, device=a.device)
    kernels.require_cuda("greedy_scan", at, bt, et, e1c, e2c, e2_out, acc)
    kernels.check(lib.atrac3_greedy_scan(
        at.data_ptr(), bt.data_ptr(), et.data_ptr(), e1c.data_ptr(),
        e2c.data_ptr(), e2_out.data_ptr(), acc.data_ptr(), rows, L,
        kernels.stream_ptr(a)), "greedy_scan")
    launches += 1
    return e2_out, acc.t().bool()
