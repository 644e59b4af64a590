"""Kernel B: the EA greedy-accept recurrence over |delta|-sorted candidates.

Counterpart of ``atracdenc_tpu/ops/pallas_greedy.py::greedy_scan``.  The
CUDA kernel is ``csrc/greedy.cu``; its plain version, ``greedy_torch``, is
the scan of ``atracdenc_tpu/ops/quant.py:142-155`` as a Python loop over
the candidate axis.  Both apply ``ex = (e2 - a) + b`` and
``accept = elig & (|ex - e1| < |e2 - e1|)`` in the same float order, so
they agree bit for bit.
"""
import torch

from atracdenc_tpu_torch import kernels, trace


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
    lib = kernels.library()
    rows, L = a.shape
    f32 = torch.float32
    if any(x.dtype != f32 for x in (a, b, e1, e2)) or elig.dtype != torch.bool \
            or b.shape != a.shape or elig.shape != a.shape \
            or e1.shape != (rows,) or e2.shape != (rows,):
        raise ValueError("greedy_scan: need a, b [rows, L] f32, elig [rows, L] "
                         "bool and e1, e2 [rows] f32")
    # the kernel reads and writes the caller's row-major tensors in place
    e2_out = torch.empty(rows, dtype=f32, device=a.device)
    accept = torch.empty((rows, L), dtype=torch.bool, device=a.device)
    kernels.require_cuda("greedy_scan", a, b, elig, e1, e2, e2_out, accept)
    kernels.check(lib.atrac3_greedy_scan(
        a.data_ptr(), b.data_ptr(), elig.data_ptr(), e1.data_ptr(),
        e2.data_ptr(), e2_out.data_ptr(), accept.data_ptr(), rows, L,
        kernels.stream_ptr(a)), "greedy_scan")
    trace.count("launch.greedy")
    return e2_out, accept
