"""Kernel D (ops/quant_cost.py::quant_cost_full): the plain PyTorch version
of the complete quantisation-cost memo against the JAX package's fused
Pallas kernel (ops/pallas_quant.quant_cost_full) in interpret mode and
against its XLA memo (bitalloc.quant_tensors(use_pallas=False)).

Inputs are tests/test_pallas_quant.py's: random blocks, and edge rows
(silence, all-tiny blocks, rounding ties, candidates on the 0.25 |delta|
boundary).  Tolerances: vlc and clc equal; err within rtol 1e-6, since e1
is an f32 sum taken in another order than XLA's.  The CUDA kernel runs
only on the card (chip_smoke.py phase 3, tests/test_torch_cuda_kernels.py).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atracdenc_tpu.models.atrac3 import bitalloc as jba
from atracdenc_tpu.models.atrac3 import tables as T
from atracdenc_tpu.ops.pallas_quant import quant_cost_full as pallas_full
from atracdenc_tpu_torch.models.atrac3 import bitalloc
from atracdenc_tpu_torch.ops import quant, quant_cost
from atracdenc_tpu_torch.testing import (assert_close, assert_equal, cpu_setup,
                                         roll_jax_scans, t)

cpu_setup()
MASK = T.GATHER_MASK


@pytest.fixture(autouse=True, scope="module")
def _rolled_jax_scans():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()                   # no rolled trace outlives the file


def _random(seed, n):
    rng = np.random.default_rng(seed)
    x = 0.999 * np.tanh(rng.standard_normal((n, 32, 128)))
    x *= 10.0 ** rng.uniform(-3, 0, (n, 32, 1))
    return (x * MASK).astype(np.float32)


def _edges():
    """tests/test_pallas_quant.py::test_quant_tensors_edge_inputs' rows."""
    rng = np.random.default_rng(3)
    x = np.zeros((5, 32, 128), np.float32)
    x[1] = 1e-6
    x[2] = (np.round(rng.uniform(-15, 15, (32, 128))) + 0.5) / 15.5
    x[3] = (np.round(rng.uniform(-2, 2, (32, 128)))
            + rng.choice([0.249, 0.25, 0.251, 0.75], (32, 128))) / 2.5
    x[4] = 0.999 * np.tanh(rng.standard_normal((32, 128)))
    return (np.clip(x, -0.9999, 0.9999) * MASK).astype(np.float32)


CASES = {"random": lambda: _random(0, 6).reshape(2, 3, 32, 128),
         "edges": _edges}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret(case):
    scaled = CASES[case]()
    err_p, vlc_p = pallas_full(jnp.asarray(scaled), MASK, interpret=True)
    err_t, vlc_t = quant_cost.quant_cost_full_torch(t(scaled), t(MASK))
    assert_equal(vlc_p, vlc_t, "vlc")
    assert_close(err_p, err_t, "err", rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_xla_memo(case):
    scaled = CASES[case]()
    qt_j = jba.quant_tensors(jnp.asarray(scaled), MASK, use_pallas=False)
    qt_t = bitalloc.quant_tensors(t(scaled), t(MASK), fused_memo=True)
    assert_equal(qt_j["vlc"], qt_t["vlc"], "vlc")
    assert_equal(qt_j["clc"], qt_t["clc"], "clc")
    assert_close(qt_j["err"], qt_t["err"], "err", rtol=1e-6, atol=0.0)


def test_fused_and_kernel_memo_agree_on_cpu():
    """quant_tensors' two routes compute one function: on CPU tensors both
    run the same plain arithmetic (memo), so every plane is equal."""
    scaled = t(_random(1, 3))
    a = bitalloc.quant_tensors(scaled, t(MASK), fused_memo=False)
    b = bitalloc.quant_tensors(scaled, t(MASK), fused_memo=True)
    for k in ("err", "clc", "vlc"):
        assert torch.equal(a[k], b[k]), k


def test_lane_sum_is_the_warp_order():
    """lane_sum folds lane i's terms i, i+32, ... and then halves; spelled
    out here for L = 64 on values whose sum depends on the order."""
    rng = np.random.default_rng(4)
    v = torch.from_numpy((rng.standard_normal((3, 64))
                          * 10.0 ** rng.uniform(-4, 4, (3, 64))).astype(np.float32))
    s = [v[:, i] + v[:, i + 32] for i in range(32)]
    for o in (16, 8, 4, 2, 1):
        s = [s[i] + s[i + o] for i in range(o)]
    assert torch.equal(quant.lane_sum(v), s[0])
    assert_close(torch.sum(v, -1), quant.lane_sum(v), "sum", rtol=1e-5)


def test_cuda_pair_table_literal_matches_tables():
    """c_pair_bits in csrc/quant_block.cuh is VLC_BITS[0, VLC_PAIR_RTAB[k]]
    for the wl==1 pair key k = 3(a+1) + (b+1)."""
    src = os.path.join(os.path.dirname(quant_cost.__file__), "..", "csrc",
                       "quant_block.cuh")
    with open(src) as fp:
        body = re.search(r"c_pair_bits\[9\] = \{(.*?)\};", fp.read(), re.S)
    lit = np.array([int(v) for v in body.group(1).split(",")], np.int32)
    ref = np.array([T.VLC_BITS[0, T.VLC_PAIR_RTAB[k]] for k in range(9)],
                   np.int32)
    assert_equal(ref, lit, "pair bits")
    assert_equal(ref, quant_cost.pair_bits_table(), "pair_bits_table")


def test_ea_groups_match_jax():
    assert quant_cost.ea_groups() == jba._ea_groups()
