"""The CUDA kernels against their plain PyTorch versions, on the card, at
shapes and values the main path rarely gives them: ragged row and frame
counts, one-candidate and full-length scans, silent and tiny blocks,
rounding ties, dense tonal planes, and both rate-control modes.

Needs a GPU and nvcc, so every test is marked ``cuda`` and skips elsewhere.
The machine with the card has no JAX, and tests/conftest.py imports it, so
run this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances are chip_smoke.py's: B and C bit-equal; A's vlc equal and its
err within 4 ulp (e1 is an f32 sum taken in another order).
"""
import numpy as np
import pytest
import torch

from atracdenc_tpu_torch.ops import greedy, quant_cost, rate_control
from atracdenc_tpu_torch.shared import tables as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _ulp(a, b):
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def _quant_inputs(n):
    rng = np.random.default_rng(n)
    x = 0.999 * np.tanh(rng.standard_normal((n, 32, 128)))
    x *= 10.0 ** rng.uniform(-3, 0, (n, 32, 1))
    x[0] = 0.0                                   # silence: 0/0 -> 0
    if n > 1:
        x[1] = 1e-6                              # e2 == 0: inf -> FLT_MAX
    if n > 2:                                    # exact rounding ties
        x[2] = (np.round(rng.uniform(-15, 15, (32, 128))) + 0.5) / 15.5
    return (np.clip(x, -0.99999, 0.99999) * T.GATHER_MASK).astype(np.float32)


@pytest.mark.parametrize("n", [1, 3, 37, 1000])
def test_quant_cost_kernel(dev, n):
    x = torch.from_numpy(_quant_inputs(n)).to(dev)
    mask = torch.as_tensor(T.GATHER_MASK, device=dev)
    err_k, vlc_k = quant_cost.quant_cost_plain(x, mask)
    err_p, vlc_p = quant_cost.quant_cost_torch(x, mask)
    torch.cuda.synchronize()
    assert torch.equal(vlc_k, vlc_p)
    assert int(_ulp(err_k, err_p).max()) <= 4


@pytest.mark.parametrize("rows,L", [(1, 1), (129, 7), (1000, 32), (4097, 128)])
def test_greedy_kernel(dev, rows, L):
    rng = np.random.default_rng(rows + L)
    m = rng.integers(-32, 33, (rows, L))
    mn = m + np.where(m >= 0, 1, -1)
    inv2 = rng.random((rows, 1)).astype(np.float32) + 0.01
    args = [(m * m).astype(np.float32) * inv2, (mn * mn).astype(np.float32) * inv2,
            rng.random((rows, L)) < 0.4, rng.random(rows).astype(np.float32) * 50.0,
            rng.random(rows).astype(np.float32) * 50.0]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
    e2_k, acc_k = greedy.greedy_scan(*args)
    e2_p, acc_p = greedy.greedy_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(e2_k, e2_p) and torch.equal(acc_k, acc_p)


def _rate_inputs(n, seed, dense_tonal):
    rng = np.random.default_rng(seed)
    shape = (n, 32)
    err = rng.uniform(0.0, 2.0, shape + (8,)).astype(np.float32)
    err[rng.random(err.shape) < 0.05] = 0.0
    err[rng.random(err.shape) < 0.02] = np.finfo(np.float32).max
    act = rng.random(shape) < (0.6 if dense_tonal else 0.15)
    start = np.sort(rng.integers(0, 1024, shape), axis=-1)
    if dense_tonal:                   # many same-bucket blocks in one group
        start[:, :18] = 256 + np.arange(18) * 3
    t_len = np.where(act, rng.integers(1, 8, shape), 0)
    return {
        "csfi": rng.uniform(0, 63, shape).astype(np.float32),
        "gated": rng.random(shape) < 0.1,
        "tonal_counts": rng.integers(0, 4, shape).astype(np.int32),
        "spread": rng.random(n).astype(np.float32),
        "target": rng.integers(40, 2500, n).astype(np.int32),
        "num_bfu": rng.integers(1, 33, n).astype(np.int32),
        "err": err,
        "clc": rng.integers(0, 150, shape + (8,)).astype(np.int32),
        "vlc": rng.integers(0, 150, shape + (8,)).astype(np.int32),
        "t_active": act.astype(np.int32),
        "t_pos": np.where(act, start, 0).astype(np.int32),
        "t_len": t_len.astype(np.int32),
        "t_bfu": np.where(act, rng.integers(0, 32, shape), 0).astype(np.int32),
        "t_vlc": rng.integers(4, 60, shape + (8,)).astype(np.int32),
    }


@pytest.mark.parametrize("n,dense_tonal", [(1, False), (130, False),
                                           (130, True), (5000, False)])
@pytest.mark.parametrize("auto", [True, False])
def test_rate_control_kernel(dev, n, dense_tonal, auto):
    ins = {k: torch.from_numpy(v).to(dev)
           for k, v in _rate_inputs(n, n + dense_tonal, dense_tonal).items()}
    out_k = rate_control.rate_control_block(**ins, auto=auto)
    out_p = rate_control.rate_control_torch(**ins, auto=auto)
    torch.cuda.synchronize()
    for name, k, p in zip(("num_bfu", "mode", "wl"), out_k, out_p):
        assert torch.equal(k.to(p.dtype), p), name


def test_wrappers_refuse_bad_shapes(dev):
    with pytest.raises(ValueError):
        quant_cost.quant_cost_plain(torch.zeros((2, 32, 64), device=dev),
                                    torch.ones((32, 128), dtype=torch.bool, device=dev))
    z = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        greedy.greedy_scan(z, z, z.bool(), z[:, 0], z[:3, 0])
    ins = {k: torch.from_numpy(v).to(dev)
           for k, v in _rate_inputs(3, 0, False).items()}
    ins["t_vlc"] = ins["t_vlc"][..., :7]
    with pytest.raises(ValueError):
        rate_control.rate_control_block(**ins)
