"""Kernel B (ops/greedy.py) and its caller ops/quant.quant_blocks against
the JAX package (the memo and final mantissas built on them are held
against JAX in tests/test_torch_rate_control.py).

The recurrence is bit-exact: the plain version applies the same f32 ops in
the same order as the JAX lax.scan twin and the Pallas greedy_scan
(interpret mode).  quant_blocks sorts candidates with a stable sort, so its
integer outputs (mantissas, VLC deltas) are equal; err within rtol=1e-6
(e1 is a sum taken in another order).  The CUDA kernel itself runs only on
the card (chip_smoke.py phase 3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.models.atrac3 import bitalloc as jba
from atracdenc_tpu.models.atrac3 import tables as T
from atracdenc_tpu.ops import quant as jquant
from atracdenc_tpu.ops.pallas_greedy import greedy_scan as pallas_greedy
from atracdenc_tpu_torch.ops import greedy, quant
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


def _scan_ref(a, b, elig, e1, e2):
    def step(e2_run, xs):
        elig_k, a_k, b_k = xs
        ex = (e2_run - a_k) + b_k
        accept = elig_k & (jnp.abs(ex - e1) < jnp.abs(e2_run - e1))
        return jnp.where(accept, ex, e2_run), accept

    e2_fin, acc = jax.lax.scan(
        step, e2, (jnp.moveaxis(elig, -1, 0), jnp.moveaxis(a, -1, 0),
                   jnp.moveaxis(b, -1, 0)))
    return e2_fin, jnp.moveaxis(acc, 0, -1)


def _greedy_inputs(rows, L):
    rng = np.random.default_rng(rows * L)
    m = rng.integers(-32, 33, (rows, L))
    mn = m + np.where(m >= 0, 1, -1)
    inv2 = rng.random((rows, 1)).astype(np.float32) + 0.01
    return ((m * m).astype(np.float32) * inv2, (mn * mn).astype(np.float32) * inv2,
            rng.random((rows, L)) < 0.4,
            rng.random(rows).astype(np.float32) * 50.0,
            rng.random(rows).astype(np.float32) * 50.0)


@pytest.mark.parametrize("rows,L", [(7, 32), (33, 64), (130, 128)])
def test_greedy_matches_jax_scan(rows, L):
    args = _greedy_inputs(rows, L)
    e2_j, acc_j = jax.jit(_scan_ref)(*map(jnp.asarray, args))
    e2_t, acc_t = greedy.greedy_scan(*map(t, args))
    assert_equal(e2_j, e2_t, "e2")
    assert_equal(acc_j, acc_t, "accept")


def test_greedy_matches_pallas_interpret():
    args = _greedy_inputs(9, 32)
    e2_p, acc_p = pallas_greedy(*map(jnp.asarray, args), interpret=True)
    e2_t, acc_t = greedy.greedy_scan(*map(t, args))
    assert_equal(e2_p, e2_t, "e2")
    assert_equal(acc_p, acc_t, "accept")


def _scaled(seed, lead=(2, 2)):
    rng = np.random.default_rng(seed)
    x = 0.999 * np.tanh(rng.standard_normal(lead + (32, 128)))
    x *= 10.0 ** rng.uniform(-2, 0, lead + (32, 1))
    return (x * MASK).astype(np.float32)


@pytest.mark.parametrize("b,e,ln", jba._ea_groups())
def test_quant_blocks_ea_groups(b, e, ln):
    """Each EA group of the memo, mantissa mode and cost mode."""
    scaled = _scaled(b)[..., b:e, :ln]
    valid = MASK[b:e, :ln]
    rng = np.random.default_rng(e)
    mul = T.MAX_QUANT[rng.integers(0, 8, scaled.shape[:-1])].astype(np.float32)
    ea = np.ones(mul.shape, bool)
    m_j, err_j = jquant.quant_blocks(jnp.asarray(scaled), valid,
                                     jnp.asarray(mul), jnp.asarray(ea))
    m_t, err_t = quant.quant_blocks(t(scaled), t(valid), t(mul), t(ea))
    assert_equal(m_j, m_t, "mant")
    assert_close(err_j, err_t, "err", rtol=1e-6, atol=0.0)

    aux = rng.integers(-8, 9, scaled.shape).astype(np.int32)
    mp = np.maximum(mul, 1.5).astype(np.float32)        # cost mode: mul > 0
    err_j, s_j = jquant.quant_blocks(jnp.asarray(scaled), valid, jnp.asarray(mp),
                                     jnp.asarray(ea), aux=jnp.asarray(aux))
    err_t, s_t = quant.quant_blocks(t(scaled), t(valid), t(mp), t(ea), aux=t(aux))
    assert_equal(s_j, s_t, "aux sum")
    assert_close(err_j, err_t, "err (cost mode)", rtol=1e-6, atol=0.0)
