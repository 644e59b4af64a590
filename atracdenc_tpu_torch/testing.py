"""Helpers for holding the port against the JAX package on the CPU.

The tests feed the same numpy arrays to a JAX function and to its port and
compare the results as numpy arrays.  This module imports no JAX: JAX
results arrive here as arrays that ``np.asarray`` accepts.
"""
import numpy as np
import torch

from atracdenc_tpu_torch import runtime

# Float intermediates differ by reduction order only (XLA and torch sum in
# different orders); integer and decision planes must be equal.
RTOL, ATOL = 1e-5, 1e-7


def cpu_setup():
    """One intra-op thread: the tier-1 run has several pytest workers."""
    torch.set_num_threads(1)
    return torch.device("cpu")


def roll_jax_scans(monkeypatch, lax):
    """Make the JAX reference compile every ``lax.scan`` rolled (unroll=1).

    The JAX package unrolls the EA greedy scan fully on the CPU
    (atracdenc_tpu/ops/quant.py:151), so each XLA:CPU compile of its quant
    memo takes ~40 s and of its encoder ~70 s.  ``unroll`` changes how the
    loop is compiled, not its ops or their order: the rolled and unrolled
    JAX encoders give bit-identical planes on at3_default_golden's pcm_in
    (default and no-gain modes), and compile in ~2-8 s.  Pass pytest's
    ``monkeypatch`` and ``jax.lax``."""
    scan = lax.scan
    monkeypatch.setattr(lax, "scan",
                        lambda *a, **kw: scan(*a, **{**kw, "unroll": 1}))


def t(a):
    """numpy / JAX array -> CPU tensor with JAX's canonical dtypes."""
    return runtime.to_torch(np.asarray(a), "cpu")


def n(x):
    return runtime.to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_equal(ref, got, name=""):
    ref, got = n(ref), n(got)
    assert ref.shape == got.shape, f"{name}: shape {ref.shape} vs {got.shape}"
    assert ref.dtype == got.dtype, f"{name}: dtype {ref.dtype} vs {got.dtype}"
    assert np.array_equal(ref, got), \
        f"{name}: {int((ref != got).sum())} of {ref.size} values differ"


def assert_close(ref, got, name="", rtol=RTOL, atol=ATOL, peak=None):
    """Within rtol / atol; ``peak`` adds an absolute tolerance of
    peak * max|ref| for sums with cancellation (matmul outputs), where an
    element's error scales with its terms, not with its value."""
    ref, got = n(ref), n(got)
    if peak is not None:
        atol = max(atol, peak * float(np.abs(ref).max()))
    assert ref.shape == got.shape, f"{name}: shape {ref.shape} vs {got.shape}"
    assert ref.dtype == got.dtype, f"{name}: dtype {ref.dtype} vs {got.dtype}"
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)
