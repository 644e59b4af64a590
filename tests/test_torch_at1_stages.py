"""The port's ATRAC1 stages against their JAX twins on the same numpy inputs
(CPU, small shapes).

Tolerances: bool and integer planes (transient masks, scale-factor
indices, mantissas) and pure selections (BFU blocks) must be equal.  The
filters and transforms are f32 sums taken in another order than XLA's:
the HPF, the QMF tree and the MDCT / IMDCT are held within 1e-6 of their
output's peak (a sum with cancellation errs with the size of its terms,
not of its result), other floats within rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.models.atrac1 import encoder as jenc
from atracdenc_tpu.models.atrac1 import filterbank as jfb
from atracdenc_tpu.models.atrac1 import mdct as jmdct
from atracdenc_tpu.models.atrac1 import tables as T
from atracdenc_tpu.ops import psy as jpsy
from atracdenc_tpu.ops import qmf as jqmf
from atracdenc_tpu.ops import scale as jscale
from atracdenc_tpu.ops import transient as jtr
from atracdenc_tpu_torch.models.atrac1 import encoder, filterbank, mdct
from atracdenc_tpu_torch.ops import psy, qmf, scale, transient
from atracdenc_tpu_torch.testing import (assert_close, assert_equal, cpu_setup,
                                         roll_jax_scans, t)

cpu_setup()


@pytest.fixture(autouse=True, scope="module")
def _rolled_jax_scans():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()                   # no rolled trace outlives the file


def _band(seed, shape=(2, 3, 2048)):
    """A band signal with silence (the -inf dB levels), bursts (attacks and
    releases) and a tone."""
    rng = np.random.default_rng(seed)
    x = 0.3 * np.sin(np.arange(shape[-1]) * 0.37) + 0.01 * rng.standard_normal(shape)
    x[..., :300] = 0.0
    x[..., 900:960] *= 40.0
    x[..., 1500:] *= 1e-4
    return x.astype(np.float32)


def test_hpf_and_transient_mask():
    x = _band(0)
    assert_close(jtr.hpf(jnp.asarray(x)), transient.hpf(t(x)), "hpf", peak=1e-6)
    for frame_sz in (128, 256):
        assert_equal(jtr.transient_mask(jnp.asarray(x), frame_sz),
                     transient.transient_mask(t(x), frame_sz), f"mask {frame_sz}")


def test_qmf_synthesis():
    rng = np.random.default_rng(1)
    lo, up = (rng.standard_normal((3, 1024)).astype(np.float32) for _ in range(2))
    assert_close(jqmf.qmf_synthesis(jnp.asarray(lo), jnp.asarray(up)),
                 qmf.qmf_synthesis(t(lo), t(up)), "qmf_synthesis", peak=1e-6)


def test_filterbank_analysis_and_synthesis():
    pcm = (0.5 * np.random.default_rng(2).standard_normal((2, 4096))
           ).astype(np.float32)
    bands_j = jfb.analysis(jnp.asarray(pcm))
    bands_t = filterbank.analysis(t(pcm))
    for name, r, g in zip(("low", "mid", "hi"), bands_j, bands_t):
        assert_close(r, g, name, peak=1e-6)
    bands = [np.asarray(b) for b in bands_j]
    assert_close(jfb.synthesis(*(jnp.asarray(b) for b in bands)),
                 filterbank.synthesis(*(t(b) for b in bands)), "synthesis",
                 peak=1e-6)


@pytest.mark.parametrize("band", [0, 1, 2])
@pytest.mark.parametrize("window", ["long", "short", "mixed"])
def test_mdct_and_imdct(band, window):
    bufsz = 256 if band == 2 else 128
    rng = np.random.default_rng(10 * band + len(window))
    frames = (0.2 * rng.standard_normal((2, 6, bufsz))).astype(np.float32)
    mask = {"long": np.zeros((2, 6), bool), "short": np.ones((2, 6), bool),
            "mixed": rng.random((2, 6)) < 0.5}[window]
    spec_j = jmdct.mdct_frames(jnp.asarray(frames), jnp.asarray(mask), band)
    assert_close(spec_j, mdct.mdct_frames(t(frames), t(mask), band), "mdct",
                 peak=1e-6)
    spec = np.asarray(spec_j)
    assert_close(jmdct.imdct_frames(jnp.asarray(spec), jnp.asarray(mask), band),
                 mdct.imdct_frames(t(spec), t(mask), band), "imdct", peak=1e-6)


def test_gather_scale_and_mantissas():
    rng = np.random.default_rng(4)
    specs = (rng.standard_normal((2, 5, 512))
             * 10.0 ** rng.uniform(-5, 0.2, (2, 5, 1))).astype(np.float32)
    flags = rng.random((2, 5, 3)) < 0.5
    blocks = jenc.gather_bfu_blocks(jnp.asarray(specs), jnp.asarray(flags))
    assert_equal(blocks, encoder.gather_bfu_blocks(t(specs), t(flags)), "blocks")
    sfi_j, scaled_j, energy_j = jscale.scale_blocks(
        blocks, T.GATHER_MASK, jnp.asarray(T.SCALE_TABLE))
    sfi_t, scaled_t, energy_t = scale.scale_blocks(
        t(blocks), t(T.GATHER_MASK), t(T.SCALE_TABLE))
    assert_equal(sfi_j, sfi_t, "sfi")
    assert_close(scaled_j, scaled_t, "scaled")
    assert_close(energy_j, energy_t, "energy")
    # every wordlen, and exact ties (k + 0.5) / multiple for round-half-even
    wl = rng.integers(0, 17, (2, 5, 52)).astype(np.int32)
    wl[0, 0] = 1
    scaled = np.asarray(scaled_j).copy()
    mult = (1 << (np.maximum(wl, 1) - 1)) - 1
    scaled[1, 0] = ((np.arange(20) % 7 - 3 + 0.5)
                    / np.maximum(mult[1, 0], 1)[:, None]).astype(np.float32)
    assert_equal(jscale.quant_mantissas(jnp.asarray(scaled), jnp.asarray(wl)),
                 scale.quant_mantissas(t(scaled), t(wl)), "mant")


def test_loudness_scan_with_per_stream_gates():
    """ATRAC1 gates the IIR per stream by its window modes: the batched
    scan over [S, F] matches the JAX scan run stream by stream.  Within
    rtol 1e-5, not equal: XLA:CPU contracts ``a * L + b`` into an FMA, the
    port (like the plain f32 reading of the reference) multiplies and adds,
    so single values differ by an ulp."""
    rng = np.random.default_rng(5)
    l0, l1 = (rng.uniform(0, 0.01, (3, 40)).astype(np.float32) for _ in range(2))
    both = rng.random((3, 40)) < 0.5
    one = ~both & (rng.random((3, 40)) < 0.5)
    init = np.float32(T.LOUD_FACTOR)
    ref = np.stack([np.asarray(jpsy.track_loudness_scan(
        jnp.asarray(l0[s]), jnp.asarray(l1[s]), jnp.asarray(both[s]),
        jnp.asarray(one[s]), init)) for s in range(3)])
    assert_close(ref, psy.track_loudness_scan(t(l0), t(l1), t(both), t(one),
                                              T.LOUD_FACTOR), "loudness")
