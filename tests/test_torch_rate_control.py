"""Kernel C (ops/rate_control.py) and models/atrac3/bitalloc.allocate
against the JAX package's rate control.

Inputs come from the JAX pipeline (input substitution): the JAX memo, sfi,
energies and tonal planes go to both sides.  The outputs are decisions
(num_bfu, coding mode, wordlens) and must be equal: every float op of the
allocation is elementwise in one order and every sum an integer sum.  The
reference is ``allocate(use_pallas=False)`` (the XLA twin of the Pallas
kernel), and one small case runs the Pallas kernel in interpret mode.  The
CUDA kernel itself runs only on the card (chip_smoke.py phase 3)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.models.atrac3 import bitalloc as jba
from atracdenc_tpu.models.atrac3 import tables as T
from atracdenc_tpu.models.atrac3 import tonal as jtonal
from atracdenc_tpu.models.atrac3.encoder import gather_bfu_blocks, spread_from_sfi
from atracdenc_tpu.ops import scale as jscale
from atracdenc_tpu.ops.pallas_rate import rate_control_block as pallas_rate
from atracdenc_tpu_torch.models.atrac3 import bitalloc
from atracdenc_tpu_torch.ops import rate_control
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


@jax.jit
def _jax_inputs(specs):
    """JAX-side rate-control inputs from spectra (one compile per shape):
    tonal extraction, scaling, the quantisation-cost memo, and mantissas
    at some wordlens."""
    specs, tp = jtonal.extract(specs, jtonal.flatness_per_bfu(specs * specs))
    planes = jtonal.scale_groups(tp)
    counts = jnp.sum(jax.nn.one_hot(planes["bfu"], 32, dtype=jnp.int32)
                     * planes["active"][..., None].astype(jnp.int32), axis=-2)
    sfi, scaled, energy = jscale.scale_blocks(
        gather_bfu_blocks(specs), MASK, jnp.asarray(T.SCALE_TABLE))
    wl = (sfi % 8).astype(jnp.int32)              # some of every wordlen
    return {"qt": jba.quant_tensors(scaled, MASK, use_pallas=False),
            "sfi": sfi, "energy": energy, "spread": spread_from_sfi(sfi),
            "counts": counts, "planes": planes, "scaled": scaled, "wl": wl,
            "mant": jba.final_mantissas(scaled, MASK, wl)}


@functools.partial(jax.jit, static_argnames=("bfu_idx_const", "tonal"))
def _jax_allocate(cs, bfu_idx_const, tonal):
    fn = jtonal.make_cost_fn(cs["planes"]) if tonal else None
    return jba.allocate(cs["qt"], cs["sfi"], cs["gs"], cs["energy"],
                        cs["spread"], cs["loud"], cs["target"],
                        tonal_counts=cs["counts"] if tonal else None,
                        tonal_bits_fn=fn, bfu_idx_const=bfu_idx_const,
                        use_pallas=False)


def _case(seed, low_budget=False, c=2, f=4):
    rng = np.random.default_rng(seed)
    specs = (rng.standard_normal((c, f, 1024))
             * 10.0 ** rng.uniform(-4, 0, (c, f, 1))).astype(np.float32)
    for line in (70, 150, 300, 301, 460):       # flat BFUs: tonal blocks
        specs[..., line] = rng.uniform(0.2, 0.6, (c, f))
    cs = dict(_jax_inputs(jnp.asarray(specs)))
    lo, hi = (40, 220) if low_budget else (300, 1600)
    cs["gs"] = jnp.asarray(10.0 ** rng.uniform(-0.3, 0.3, (c, f, 4)).astype(np.float32))
    cs["loud"] = jnp.asarray(10.0 ** rng.uniform(-3, 0, (c, f)).astype(np.float32))
    cs["target"] = jnp.asarray(rng.integers(lo, hi, (c, f)).astype(np.int32))
    return cs


def _dense_tonal_case():
    """>= 8 same-bucket tonal blocks in one 64-line group: the limiter
    break ranks (cnt == 8, 15) that extracted planes rarely reach."""
    cs = _case(11)
    rng = np.random.default_rng(11)
    shape = np.asarray(cs["sfi"]).shape
    act = np.zeros(shape, bool)
    start = np.zeros(shape, np.int32)
    ln = np.zeros(shape, np.int32)
    bfu = np.zeros(shape, np.int32)
    act[..., :18] = True
    start[..., :18] = 256 + np.arange(18) * 3
    ln[..., :18] = 2
    bfu[..., :18] = 10
    cs["planes"] = dict(cs["planes"], active=jnp.asarray(act),
                        start=jnp.asarray(start), len=jnp.asarray(ln),
                        bfu=jnp.asarray(bfu), vlc_cost=jnp.asarray(
                            rng.integers(4, 60, shape + (8,)).astype(np.int32)))
    cs["counts"] = jnp.asarray((np.eye(32, dtype=np.int32)[bfu] * act[..., None]).sum(-2))
    return cs


def _port_alloc(cs, use_rate_kernel, bfu_idx_const, tonal):
    planes = {k: t(v) for k, v in cs["planes"].items()} if tonal else None
    return bitalloc.allocate(
        {k: t(v) for k, v in cs["qt"].items()}, t(cs["sfi"]), t(cs["gs"]),
        t(cs["energy"]), t(cs["spread"]), t(cs["loud"]), t(cs["target"]),
        tonal_planes=planes, bfu_idx_const=bfu_idx_const,
        use_rate_kernel=use_rate_kernel)


# (case, tonal planes on, bfu_idx_const); 12 is the auto=False
# (--bfuidxconst) case of kernel C
CASES = [("no_tonal", False, 0), ("tonal", True, 0), ("tonal", True, 12),
         ("low_budget_shrink", True, 0), ("dense_tonal_limiter", True, 0)]
_BUILD = {"no_tonal": lambda: _case(0), "tonal": lambda: _case(1),
          "low_budget_shrink": lambda: _case(7, low_budget=True),
          "dense_tonal_limiter": _dense_tonal_case}


@pytest.mark.parametrize("name,tonal,bfu_idx_const", CASES)
def test_allocate_matches_jax(name, tonal, bfu_idx_const):
    """Both routes of the port (kernel C's wrapper, which takes its plain
    version on the CPU, and the tensor-op path) equal the JAX XLA path."""
    cs = _BUILD[name]()
    ref = _jax_allocate(cs, bfu_idx_const, tonal)
    for use_rate_kernel in (True, False):
        got = _port_alloc(cs, use_rate_kernel, bfu_idx_const, tonal)
        for label, a, b in zip(("num_bfu", "mode", "wl"), ref, got):
            assert_equal(a, b, f"{label} (use_rate_kernel={use_rate_kernel})")


def test_quant_tensors_and_final_mantissas():
    """The memo (kernel A's plain lanes, the EA groups through quant_blocks
    and kernel B, the wl==1 pair codebook) and the final mantissas: integer
    planes equal, err within rtol=1e-6 (e1 sums in another order)."""
    cs = _case(2)
    qt = bitalloc.quant_tensors(t(cs["scaled"]), t(MASK))
    assert_equal(cs["qt"]["clc"], qt["clc"], "clc")
    assert_equal(cs["qt"]["vlc"], qt["vlc"], "vlc")
    assert_close(cs["qt"]["err"], qt["err"], "err", rtol=1e-6, atol=0.0)
    assert_equal(cs["mant"], bitalloc.final_mantissas(t(cs["scaled"]), t(MASK),
                                                      t(cs["wl"])), "mant")


def test_rate_control_matches_pallas_interpret():
    cs = _case(3)
    csfi, gated = jba.csfi_gated(cs["sfi"], cs["gs"], cs["energy"], cs["loud"])
    p = cs["planes"]
    args = (csfi, gated, cs["counts"], cs["spread"], cs["target"],
            jnp.full(cs["spread"].shape, 32, jnp.int32), cs["qt"]["err"],
            cs["qt"]["clc"], cs["qt"]["vlc"], p["active"].astype(jnp.int32),
            p["start"], p["len"], p["bfu"], p["vlc_cost"])
    ref = pallas_rate(*args, auto=True, interpret=True)
    got = rate_control.rate_control_block(*map(t, args), auto=True)
    for label, a, b in zip(("num_bfu", "mode", "wl"), ref, got):
        assert_equal(a, b, label)


@jax.jit
def _jax_pieces(cs, shift, nb):
    wl = jba.calc_bits_allocation(cs["sfi"], cs["gs"], cs["energy"], cs["spread"],
                                  shift, nb, cs["loud"], cs["counts"])
    boost = jba._energy_boost(wl, cs["qt"], nb)
    return wl, boost, jba._spec_cost(boost, cs["qt"], nb)


def test_allocation_pieces_match_jax():
    """calc_bits_allocation, the energy boost and the spectrum cost alone."""
    cs = _case(5)
    rng = np.random.default_rng(5)
    shift = rng.uniform(-8, 20, cs["spread"].shape).astype(np.float32)
    nb = rng.integers(1, 33, cs["spread"].shape).astype(np.int32)
    wl_j, boost_j, cost_j = _jax_pieces(cs, jnp.asarray(shift), jnp.asarray(nb))
    wl_t = bitalloc.calc_bits_allocation(t(cs["sfi"]), t(cs["gs"]), t(cs["energy"]),
                                         t(cs["spread"]), t(shift), t(nb),
                                         t(cs["loud"]), t(cs["counts"]))
    assert_equal(wl_j, wl_t, "calc_bits_allocation")
    qt_t = {k: t(v) for k, v in cs["qt"].items()}
    assert_equal(boost_j, bitalloc._energy_boost(t(wl_j), qt_t, t(nb)),
                 "energy boost")
    for a, b in zip(cost_j, bitalloc._spec_cost(t(boost_j), qt_t, t(nb))):
        assert_equal(a, b, "spec cost")
