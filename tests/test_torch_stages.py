"""Port vs JAX, stage by stage, on the same numpy inputs (CPU, tiny shapes).

Tolerances: integer and decision planes (sfi, gain points, tonal planes,
mantissas) must be equal; float intermediates (bands, spectra, energies,
loudness) within rtol=1e-5, atol=1e-7 — XLA and torch reduce in different
orders.  MDCT spectra add 1e-6 of the spectrum's peak as absolute
tolerance: a 512-term dot product with cancellation errs with the size of
its terms, not of its result.  Each stage gets the JAX stage's own inputs (input substitution),
so an upstream float knife edge cannot hide a logic fault.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.models.atrac3 import encoder as jenc
from atracdenc_tpu.models.atrac3 import gain as jgain
from atracdenc_tpu.models.atrac3 import mdct as jm3
from atracdenc_tpu.models.atrac3 import specblocks as jsb
from atracdenc_tpu.models.atrac3 import tables as T
from atracdenc_tpu.models.atrac3 import tonal as jtonal
from atracdenc_tpu.ops import mdct as jmdct
from atracdenc_tpu.ops import psy as jpsy
from atracdenc_tpu.ops import qmf as jqmf
from atracdenc_tpu.ops import scale as jscale
from atracdenc_tpu_torch.models.atrac3 import encoder, gain, specblocks, tonal
from atracdenc_tpu_torch.models.atrac3 import mdct as m3
from atracdenc_tpu_torch.ops import mdct, psy, qmf, scale
from atracdenc_tpu_torch.testing import (assert_close, assert_equal, cpu_setup,
                                         roll_jax_scans, t)

cpu_setup()


@pytest.fixture(autouse=True, scope="module")
def _rolled_jax_scans():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()                   # no rolled trace outlives the file


def _pcm(seed, c=2, f=4):
    """Tone + noise with a loud burst in the middle (gain points appear)."""
    rng = np.random.default_rng(seed)
    k = np.arange(1024 * f)
    x = 0.3 * np.sin(2 * np.pi * 997 * k / 44100)[None] * [[1.0], [0.7]][:c]
    x = x + 0.02 * rng.standard_normal((c, k.size))
    x[:, k.size // 2: k.size // 2 + 300] *= 3.0
    return np.clip(x, -1, 1).astype(np.float32)


def _bands(seed, c=2, f=4):
    return np.asarray(jenc.band_frames(jnp.asarray(_pcm(seed, c, f))))


def test_qmf_analysis():
    x = np.random.default_rng(0).standard_normal((3, 2048)).astype(np.float32)
    for r, g in zip(jqmf.qmf_analysis(jnp.asarray(x)), qmf.qmf_analysis(t(x))):
        assert_close(r, g, "qmf")


def test_band_frames():
    pcm = _pcm(1)
    assert_close(jenc.band_frames(jnp.asarray(pcm)), encoder.band_frames(t(pcm)),
                 "band_frames")


def test_mdct():
    # band-level inputs; the scale 1/512 is the ATRAC3 MDCT's
    x = 0.1 * np.random.default_rng(2).standard_normal((5, 512)).astype(np.float32)
    assert_equal(jmdct.mdct_matrix(512, 1 / 512.0),
                 mdct.mdct_matrix(512, 1 / 512.0), "basis")
    assert_close(jmdct.mdct(jnp.asarray(x), 1 / 512.0),
                 mdct.mdct(t(x), 1 / 512.0), "mdct", peak=1e-6)


def _gain_points(seed, shape=(2, 4, 4)):
    rng = np.random.default_rng(seed)
    npts = rng.integers(0, 9, shape).astype(np.int32)
    levels = rng.integers(0, 16, shape + (8,)).astype(np.int32)
    locs = np.sort(np.stack([rng.choice(32, 8, replace=False)
                             for _ in range(int(np.prod(shape)))]), axis=-1)
    return levels, locs.reshape(shape + (8,)).astype(np.int32), npts


def test_gain_divisors_and_mdct_frames():
    levels, locs, npts = _gain_points(3)
    div_j = jm3.gain_divisors(jnp.asarray(levels), jnp.asarray(locs),
                              jnp.asarray(npts))
    div_t = m3.gain_divisors(t(levels), t(locs), t(npts))
    assert_equal(div_j, div_t, "gain_divisors")          # exact ramp table
    assert_equal(jm3.first_level_scale(jnp.asarray(levels), jnp.asarray(npts)),
                 m3.first_level_scale(t(levels), t(npts)), "first_level_scale")

    bands = _bands(4)
    scl = np.asarray(jm3.first_level_scale(jnp.asarray(levels), jnp.asarray(npts)))
    prev = 0.1 * np.random.default_rng(5).standard_normal((2, 4, 256)).astype(np.float32)
    for args in ((), (np.asarray(div_j), scl, prev)):
        r = jm3.mdct_frames(jnp.asarray(bands), *map(jnp.asarray, args))
        g = m3.mdct_frames(t(bands), *map(t, args))
        assert_close(r, g, "mdct_frames", peak=1e-6)


def test_psy_tables_and_loudness_scan():
    assert_equal(jpsy.create_loudness_curve(1024), psy.create_loudness_curve(1024))
    assert_equal(T.ath_per_bfu(), psy.ath_per_bfu(T.SPECS_START, T.SPECS_PER_BLOCK))
    rng = np.random.default_rng(6)
    l0, l1 = (rng.random((2, 9)).astype(np.float32) * 1e-2)
    both = np.array([1, 1, 0, 1, 0, 0, 1, 1, 1], bool)
    one = ~both & (np.arange(9) % 2 == 0)
    r = jpsy.track_loudness_scan(jnp.asarray(l0), jnp.asarray(l1),
                                 jnp.asarray(both), jnp.asarray(one), 0.006)
    g = psy.track_loudness_scan(t(l0), t(l1), t(both), t(one), 0.006)
    assert_close(r, g, "loudness")


def test_scale_blocks_spread_specblocks():
    rng = np.random.default_rng(7)
    specs = (rng.standard_normal((2, 3, 1024))
             * 10.0 ** rng.uniform(-5, 0.2, (2, 3, 1))).astype(np.float32)
    bj = jenc.gather_bfu_blocks(jnp.asarray(specs))
    bt = specblocks.to_blocks(t(specs))
    assert_equal(bj, bt, "to_blocks")
    assert_equal(jsb.from_blocks(bj), specblocks.from_blocks(bt), "from_blocks")
    sfi_j, sc_j, en_j = jscale.scale_blocks(bj, T.GATHER_MASK, jnp.asarray(T.SCALE_TABLE))
    sfi_t, sc_t, en_t = scale.scale_blocks(bt, t(T.GATHER_MASK), t(T.SCALE_TABLE))
    assert_equal(sfi_j, sfi_t, "sfi")
    assert_equal(sc_j, sc_t, "scaled")                   # one IEEE division
    assert_close(en_j, en_t, "energy")
    assert_close(jenc.spread_from_sfi(sfi_j), encoder.spread_from_sfi(t(sfi_j)),
                 "spread")


@pytest.mark.parametrize("chunked", [False, True])
def test_gain_control(chunked):
    bands = _bands(8, f=6)
    ctx = next_head = None
    if chunked:
        rng = np.random.default_rng(9)
        ctx = {"last_level": rng.random((2, 4)).astype(np.float32) * 0.1,
               "last_target": rng.random((2, 4)).astype(np.float32) * 0.1,
               "last_hpf": rng.random((2, 4)).astype(np.float32) * 0.1,
               "prev_tail": 0.1 * rng.standard_normal((2, 4, 128)).astype(np.float32)}
        next_head = 0.1 * rng.standard_normal((2, 4, 128)).astype(np.float32)
    jctx = None if ctx is None else {k: jnp.asarray(v) for k, v in ctx.items()}
    rj = jgain.gain_control(jnp.asarray(bands), jctx,
                            None if next_head is None else jnp.asarray(next_head))
    rt = gain.gain_control(t(bands), None if ctx is None else
                           {k: t(v) for k, v in ctx.items()},
                           None if next_head is None else t(next_head))
    assert int(np.asarray(rj[2]).sum()) > 0, "case has no gain points"
    for name, a, b in zip(("levels", "locs", "npoints"), rj[:3], rt[:3]):
        assert_equal(a, b, name)
    for k in rj[3]:
        assert_close(rj[3][k], rt[3][k], f"ctx {k}")

    div = jm3.gain_divisors(*rj[:3])
    scl = jm3.first_level_scale(rj[0], rj[2])
    gs_j, (st_j, no_j) = jgain.energy_scale(jnp.asarray(bands), div, scl)
    gs_t, (st_t, no_t) = gain.energy_scale(t(bands), t(div), t(scl))
    assert_close(gs_j, gs_t, "energy_scale")
    assert_close(st_j, st_t, "stored half")
    assert_close(no_j, no_t, "next overlap")


def test_gain_control_debug():
    """debug=True returns the JAX package's seven YAML-log intermediates
    within the float bound; the planes and the carry equal debug=False's."""
    bands = _bands(8, f=6)
    rj = jgain.gain_control(jnp.asarray(bands), debug=True)
    rt = gain.gain_control(t(bands), debug=True)
    plain = gain.gain_control(t(bands))
    assert len(rt) == 5 and sorted(rt[4]) == sorted(rj[4]) and len(rj[4]) == 7
    assert int(np.asarray(rj[2]).sum()) > 0, "case has no gain points"
    for k in rj[4]:
        assert_close(rj[4][k], rt[4][k], f"debug {k}")
    for name, a, b in zip(("levels", "locs", "npoints"), plain[:3], rt[:3]):
        assert_equal(a, b, name)
    for k in plain[3]:
        assert_equal(plain[3][k], rt[3][k], f"ctx {k}")


def _tonal_specs(seed, c=2, f=3):
    """Spectra with a few strong lines so flat BFUs and tonal runs occur."""
    rng = np.random.default_rng(seed)
    specs = 1e-4 * rng.standard_normal((c, f, 1024))
    for line in (70, 71, 150, 300, 301, 302, 460, 610):
        specs[..., line] = rng.uniform(0.2, 0.6, (c, f))
    return specs.astype(np.float32)


def test_tonal_stages():
    specs = _tonal_specs(10)
    flat_j = jtonal.flatness_per_bfu(jnp.asarray(specs * specs))
    assert_close(flat_j, tonal.flatness_per_bfu(t(specs * specs)), "flatness")

    so_j, tp_j = jtonal.extract(jnp.asarray(specs), flat_j)
    so_t, tp_t = tonal.extract(t(specs), t(flat_j))
    assert int(np.asarray(tp_j["active"]).sum()) > 2, "case has no tonal blocks"
    assert_equal(so_j, so_t, "specs_out")
    for k in ("active", "start", "len", "bfu", "values"):
        assert_equal(tp_j[k], tp_t[k], k)

    pj = jtonal.scale_groups(tp_j)
    pt = tonal.scale_groups({k: t(v) for k, v in tp_j.items()})
    for k in ("sfi", "vlc_cost", "mant"):
        assert_equal(pj[k], pt[k], k)

    rng = np.random.default_rng(11)
    cost_j = jtonal.make_cost_fn(pj)
    cost_t = tonal.make_cost_fn({k: t(v) for k, v in pj.items()})
    for _ in range(4):
        wl = rng.integers(0, 8, specs.shape[:2] + (32,)).astype(np.int32)
        nb = rng.integers(10, 33, specs.shape[:2]).astype(np.int32)
        assert_equal(cost_j(jnp.asarray(wl), jnp.asarray(nb)),
                     cost_t(t(wl), t(nb)), "tonal cost")
        for a, b in zip(jtonal.block_quant(pj, jnp.asarray(wl), jnp.asarray(nb)),
                        tonal.block_quant({k: t(v) for k, v in pj.items()},
                                          t(wl), t(nb))):
            assert_equal(a, b, "block_quant")


def test_regroup_merges_and_splits():
    """Adjacent runs across BFU boundaries merge; runs longer than 7
    components split."""
    act = np.zeros((1, 32), bool)
    start = np.zeros((1, 32), np.int32)
    ln = np.zeros((1, 32), np.int32)
    for b, s, l in ((9, 79, 1), (10, 80, 5), (11, 96, 5), (12, 101, 4), (20, 330, 2)):
        act[0, b], start[0, b], ln[0, b] = True, s, l
    vals = np.where(np.arange(5) < ln[..., None], 0.5, 0.0).astype(np.float32)
    planes = {"active": act, "start": start, "len": ln, "values": vals}
    rj = jtonal.regroup({k: jnp.asarray(v) for k, v in planes.items()})
    rt = tonal.regroup({k: t(v) for k, v in planes.items()})
    for k in ("active", "start", "len", "bfu", "values"):
        assert_equal(rj[k], rt[k], k)
