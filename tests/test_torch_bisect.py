"""Kernel F (ops/rate_control.py::bisect_block): the plain PyTorch version
of one lambda bisection at a fixed num_bfu against the JAX package's Pallas
kernel (ops/pallas_alloc.bisect_block) in interpret mode and against its
XLA bisection (bitalloc._bisect), with and without tonal planes; and
against kernel C's plain version with the BFU shrink off.

The outputs are wordlens and must be equal: every float op of the
allocation is elementwise in one order and every sum an integer sum.  The
CUDA kernel runs only on the card (chip_smoke.py phase 3,
tests/test_torch_cuda_kernels.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.models.atrac3 import bitalloc as jba
from atracdenc_tpu.models.atrac3 import tonal as jtonal
from atracdenc_tpu.ops.pallas_alloc import bisect_block as pallas_bisect
from atracdenc_tpu_torch.ops import rate_control
from atracdenc_tpu_torch.testing import assert_equal, cpu_setup, t

cpu_setup()


def _case(seed, tonal, n=24):
    """Allocation inputs for n channel-frames: sfi / gain scale / energy /
    loudness (csfi and the gate come from the JAX package's csfi_gated), a
    memo with every kind of err value, and tonal planes with ascending
    block positions (or none)."""
    rng = np.random.default_rng(seed)
    shape = (n, 32)
    err = rng.uniform(0.0, 2.0, shape + (8,)).astype(np.float32)
    err[rng.random(err.shape) < 0.05] = 0.0
    err[rng.random(err.shape) < 0.02] = np.finfo(np.float32).max
    act = rng.random(shape) < (0.4 if tonal else 0.0)
    start = np.sort(rng.integers(0, 1024, shape), axis=-1)
    if tonal:                         # many same-bucket blocks in one group
        start[:4, :18] = 256 + np.arange(18) * 3
        act[:4, :18] = True
    bfu = np.where(act, rng.integers(0, 32, shape), 0)
    cs = {
        "sfi": rng.integers(0, 64, shape).astype(np.int32),
        "gs": (10.0 ** rng.uniform(-0.3, 0.3, (n, 4))).astype(np.float32),
        "energy": (10.0 ** rng.uniform(-9, 1, shape)).astype(np.float32),
        "loud": (10.0 ** rng.uniform(-3, 0, n)).astype(np.float32),
        "spread": rng.random(n).astype(np.float32),
        "target": rng.integers(40, 2500, n).astype(np.int32),
        "num_bfu": rng.integers(1, 33, n).astype(np.int32),
        "qt": {"err": err,
               "clc": rng.integers(0, 150, shape + (8,)).astype(np.int32),
               "vlc": rng.integers(0, 150, shape + (8,)).astype(np.int32)},
        "planes": {"active": act,
                   "start": np.where(act, start, 0).astype(np.int32),
                   "len": np.where(act, rng.integers(1, 8, shape), 0).astype(np.int32),
                   "bfu": bfu.astype(np.int32),
                   "vlc_cost": rng.integers(4, 60, shape + (8,)).astype(np.int32)},
    }
    cs["counts"] = (np.eye(32, dtype=np.int32)[bfu] * act[..., None]).sum(-2)
    csfi, gated = jba.csfi_gated(cs["sfi"], cs["gs"], cs["energy"], cs["loud"])
    cs["csfi"], cs["gated"] = np.asarray(csfi), np.asarray(gated)
    return cs


def _args(cs):
    p = cs["planes"]
    return (cs["csfi"], cs["gated"], cs["counts"], cs["spread"], cs["target"],
            cs["num_bfu"], cs["qt"]["err"], cs["qt"]["clc"], cs["qt"]["vlc"],
            p["active"].astype(np.int32), p["start"], p["len"], p["bfu"],
            p["vlc_cost"])


@pytest.mark.parametrize("tonal", [False, True])
def test_plain_matches_pallas_interpret(tonal):
    cs = _case(1 + tonal, tonal)
    ref = pallas_bisect(*map(jnp.asarray, _args(cs)), interpret=True)
    got = rate_control.bisect_block(*map(t, _args(cs)))
    assert_equal(ref, got, "wl")


@jax.jit
def _jax_bisect(cs, tonal_fn_planes):
    fn = (jtonal.make_cost_fn(tonal_fn_planes) if tonal_fn_planes is not None
          else lambda wl, nb: jnp.asarray(5, jnp.int32))
    return jba._bisect(cs["sfi"], cs["gs"], cs["energy"], cs["spread"],
                       cs["num_bfu"], cs["loud"], cs["counts"], fn, cs["qt"],
                       cs["target"])


@pytest.mark.parametrize("tonal", [False, True])
def test_plain_matches_xla_bisect(tonal):
    cs = _case(3 + tonal, tonal)
    jcs = {k: cs[k] for k in ("sfi", "gs", "energy", "spread", "num_bfu",
                              "loud", "counts", "qt", "target")}
    ref = _jax_bisect(jcs, cs["planes"] if tonal else None)
    got = rate_control.bisect_torch(*map(t, _args(cs)))
    assert_equal(ref, got, "wl")


@pytest.mark.parametrize("tonal", [False, True])
def test_equals_rate_control_without_shrink(tonal):
    """F is C's first round: with auto=False C keeps num_bfu and returns
    the same wordlens."""
    args = list(map(t, _args(_case(5 + tonal, tonal))))
    _, _, wl_c = rate_control.rate_control_block(*args, auto=False)
    assert_equal(wl_c, rate_control.bisect_block(*args), "wl")
