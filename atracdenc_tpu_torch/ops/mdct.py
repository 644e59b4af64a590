"""MDCT as a matmul with the direct basis.

Port of ``atracdenc_tpu/ops/mdct.py::mdct_matrix`` / ``mdct``:
``TMDCT<N>(scale) == (scale / N) * direct_mdct`` with
``direct_mdct[k] = sum_n x[n] cos(2 pi / N (n + 0.5 + N/4)(k + 0.5))``.
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch import runtime  # noqa: F401  (f32 policy)

__all__ = ["mdct_matrix", "mdct"]


@functools.lru_cache(maxsize=None)
def _mdct_matrix_np(n: int) -> np.ndarray:
    """Direct MDCT basis, shape [N/2, N], float64."""
    m = np.arange(n, dtype=np.float64)
    k = np.arange(n // 2, dtype=np.float64)
    return np.cos(2.0 * np.pi / n * np.outer(k + 0.5, m + 0.5 + n / 4.0))


@functools.lru_cache(maxsize=None)
def mdct_matrix(n: int, scale: float = 1.0, dtype=torch.float32,
                device=torch.device("cpu")) -> torch.Tensor:
    """[N/2, N] MDCT basis scaled by `scale` (built in f64, cast)."""
    return torch.as_tensor(_mdct_matrix_np(n) * scale, dtype=dtype,
                           device=device)


def mdct(x, scale: float = 1.0):
    """Forward MDCT over the last axis: [..., N] -> [..., N/2]."""
    basis = mdct_matrix(x.shape[-1], scale, x.dtype, x.device)
    return torch.matmul(x, basis.t())
