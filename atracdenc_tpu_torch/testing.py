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


def deposit_case(seed, total_bytes, f=6, k=256):
    """Fields for ``deposit_fields`` (values uint32, widths int32, offsets
    int32 [f, k] numpy) with the layouts its routes could get wrong, and the
    rows whose fields all fit in ``total_bytes`` (the ones a sequential
    packer can take).

    Each row's fields lie back to back from bit 0, widths 0 to 32, in a
    shuffled column order; width-0 fields carry stray values and offsets.
    Row 0 starts with a 31-bit and a 32-bit field (the second straddles
    words 0 and 1 from bit 31) and stops at the frame's last bit or before;
    row 1 ends exactly on it with a field as wide as fits; row 2 has a
    field across the end and fields past it; row 3 lies wholly past the
    end (past the sink word too); the other rows run on past the end."""
    rng = np.random.default_rng(seed)
    bits = 8 * total_bytes
    widths = np.zeros((f, k), np.int64)
    for r in range(f):
        limit = bits if r < 2 else bits + 200
        row = [31, 32] if r == 0 else []
        while len(row) < k and sum(row) < limit:
            row.append(int(rng.integers(0, 33)) if rng.random() > 0.2 else 0)
        while sum(row) > limit or (r < 2 and sum(row) > bits):
            row.pop()
        if r == 1 and len(row) < k and sum(row) < bits:
            row.append(min(32, bits - sum(row)))
        widths[r, :len(row)] = row
    offsets = np.zeros((f, k), np.int64)
    np.cumsum(widths[:, :-1], axis=1, out=offsets[:, 1:])
    offsets[3:4] += 40 * (bits + 64)
    values = rng.integers(0, 1 << 32, (f, k), dtype=np.uint64)
    gone = widths == 0
    values[~gone] &= (np.uint64(1) << widths[~gone].astype(np.uint64)) \
        - np.uint64(1)
    offsets[gone] = rng.integers(0, 4 * bits + 64, int(gone.sum()))
    perm = rng.permutation(k)
    fits = (np.where(gone, 0, offsets + widths).max(axis=1) <= bits)
    return (values[:, perm].astype(np.uint32), widths[:, perm].astype(np.int32),
            offsets[:, perm].astype(np.int32), np.flatnonzero(fits))
