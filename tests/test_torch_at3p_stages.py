"""ATRAC3+ port vs JAX, stage by stage, on the same numpy inputs (CPU).

Tolerances: integer and decision planes (every tone plane, sharing,
leader) equal, dtypes included; float stages (PQF analysis, MDCT / IMDCT,
the lane spectrum, the wave sums, synthesize, subtract) within rtol 1e-5
plus 1e-6 of the peak (sums with cancellation err with the size of their
terms); decoded PCM within 1e-5.

Input substitution: the GHA stages get the JAX package's own band samples
(``band_frames`` of JAX), and synthesize / subtract get the JAX package's
own planes, so an upstream float difference cannot hide a logic fault.
No knife edge flipped on these inputs: the argmax over the DFT magnitudes
and over |rfft|, ``floor(4 log2 amp + 3)``, ``round(phi / 64)``, the 0.9
accept gate and the continuation test gave equal integers everywhere, so
no stage needed its own inputs substituted further.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.models.atrac3p import decoder as jdec
from atracdenc_tpu.models.atrac3p import device_pack as jdp
from atracdenc_tpu.models.atrac3p import encoder as jenc
from atracdenc_tpu.models.atrac3p import gha as jgha
from atracdenc_tpu.models.atrac3p import mdct as jmdct
from atracdenc_tpu.models.atrac3p import pqf as jpqf
from atracdenc_tpu_torch.models.atrac3p import decoder, device_pack, encoder
from atracdenc_tpu_torch.models.atrac3p import frame, gha, mdct, pqf
from atracdenc_tpu_torch.testing import assert_close, assert_equal, cpu_setup, t

cpu_setup()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PEAK = 1e-6


def tonal_pcm(frames=4, channels=2, seed=0):
    """Two tones (689 Hz on the FreqIndex grid, 3000.5 Hz off it), quiet
    for the first half, so that envelopes start mid-track; light noise."""
    n = np.arange(2048 * frames)
    x = (0.5 * np.sin(2 * np.pi * 689.0625 * n / 44100)
         + 0.2 * np.sin(2 * np.pi * 3000.5 * n / 44100))
    x[: n.size // 2] *= 0.05
    x = x + 0.01 * np.random.default_rng(seed).standard_normal(n.size)
    return np.clip(np.stack([x, 0.8 * x])[:channels], -1, 1).astype(np.float32)


def _tensors(planes):
    return {k: ({kk: t(vv) for kk, vv in v.items()} if isinstance(v, dict)
                else t(v)) for k, v in planes.items()}


def _jax(planes):
    return jax.tree.map(jnp.asarray, planes)


@pytest.fixture(scope="module", params=[2, 1], ids=["stereo", "mono"])
def bands(request):
    """(pcm, JAX band samples [C, F, 16, 128]) of tonal_pcm."""
    pcm = tonal_pcm(channels=request.param)
    return pcm, np.asarray(jenc.band_frames(jnp.asarray(pcm)))


@pytest.fixture(scope="module")
def jax_planes(bands):
    """The JAX package's GHA planes of ``bands``."""
    return jax.device_get(jgha.extract(jnp.asarray(bands[1])))


@pytest.fixture(scope="module")
def coded():
    """The JAX encoder's stereo planes (GHA on) and their frame bytes."""
    planes = jenc.encode_track(tonal_pcm(), use_gha=True)
    return planes, frame.pack(planes, 2)


@pytest.mark.parametrize("with_history", [False, True])
def test_pqf_analysis(with_history):
    x = (0.3 * np.random.default_rng(1).standard_normal(
        (3, 2048 * 2 + (pqf.OVERLAP if with_history else 0)))).astype(np.float32)
    assert_close(jpqf.analysis(jnp.asarray(x), with_history=with_history),
                 pqf.analysis(t(x), with_history=with_history), "analysis",
                 peak=PEAK)
    np.testing.assert_array_equal(jpqf._analysis_kernel(), pqf._analysis_kernel())


def test_ipqf():
    """Bit-equal to the JAX package's ring-buffer loop, and within 2^-26 of
    the golden data from the real decoder (tests/test_at3p_codec.py)."""
    b = (1000 * np.random.default_rng(2).standard_normal((16, 300))).astype(np.float32)
    assert_equal(jpqf.ipqf_np(b), pqf.ipqf_np(b), "ipqf_np")
    mr = np.fromfile(os.path.join(GOLDEN, "ipqftest_pcm_mr.dat"), np.float32)
    ref = np.fromfile(os.path.join(GOLDEN, "ipqftest_pcm_out.dat"), np.float32)
    blocks = np.concatenate(
        [mr[i:i + 2048].reshape(16, 128) for i in range(0, 8192, 2048)], axis=1)
    assert np.abs(pqf.ipqf_np(blocks) - ref).max() < 1.0 / (1 << 26)


def test_mdct_frames_and_inverse():
    b = (0.3 * np.random.default_rng(3).standard_normal((2, 5, 16, 128))).astype(np.float32)
    spec = jmdct.mdct_frames(jnp.asarray(b))
    assert_close(spec, mdct.mdct_frames(t(b)), "mdct_frames", peak=PEAK)
    assert_close(jmdct.imdct_frames(spec), mdct.imdct_frames(t(np.asarray(spec))),
                 "imdct_frames", peak=PEAK)


def test_lane_spectrum_and_wave_sum():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((24, 128)).astype(np.float32)
    for r, g in zip(jgha._lane_spectrum(jnp.asarray(x)), gha._lane_spectrum(t(x))):
        assert_close(r, g, "lane_spectrum", peak=PEAK)
    # distinct frequencies per lane (the 20-bin guard), half the slots valid
    freq = np.stack([rng.choice(np.arange(0, 1024, 20), 8, replace=False)
                     for _ in range(24)]).astype(np.int32)
    ph = rng.integers(0, 32, (24, 8)).astype(np.int32)
    amp = np.where(rng.random((24, 8)) < 0.5,
                   rng.random((24, 8)) * 1000, 0).astype(np.float32)
    for off, length in ((0, 128), (-128, 128), (128, 64)):
        assert_close(jgha._wave_sum(jnp.asarray(freq), jnp.asarray(ph),
                                    jnp.asarray(amp), off, length),
                     gha._wave_sum(t(freq), t(ph), t(amp), off, length),
                     f"wave_sum {off}", peak=PEAK)


def test_detect_run():
    """The vectorised run detector gives the JAX scan's integers, on lanes
    whose block pattern covers empty, full, tied and split runs."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    scale = np.where(rng.random((64, 32)) < 0.6, 0.5, 2.0)
    scale[0], scale[1] = 2.0, 0.5                      # no run, one full run
    resid = (x.reshape(64, 32, 4) * scale[..., None]).reshape(64, 128)
    resid = resid.astype(np.float32)
    for r, g in zip(jgha._detect_run(jnp.asarray(x), jnp.asarray(resid)),
                    gha._detect_run(t(x), t(resid))):
        assert_equal(r, g, "detect_run")


def test_extract(bands, jax_planes):
    ref = jax_planes
    got = gha.extract(t(bands[1]))
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert_equal(ref[k], got[k], k)
    assert ref["valid"].any() and (ref["env_start"] >= 0).any()


@pytest.mark.parametrize("refine_raw", [False, True], ids=["subband", "raw"])
def test_extract_wideband(bands, refine_raw):
    pcm, b = bands
    raw = pcm.reshape(pcm.shape[0], -1, 2048)
    ref = jax.device_get(jgha.extract_wideband(jnp.asarray(b), jnp.asarray(raw),
                                               refine_raw=refine_raw))
    got = gha.extract_wideband(t(b), t(raw), refine_raw=refine_raw)
    for k in ref:
        assert_equal(ref[k], got[k], k)
    assert ref["valid"].any()


def test_synthesize_and_subtract(bands, jax_planes):
    """On the JAX package's own planes and bands."""
    _, b = bands
    planes = jax_planes
    assert_close(jgha.synthesize(_jax(planes)), gha.synthesize(_tensors(planes)),
                 "synthesize", peak=PEAK)
    assert_close(jgha.subtract(jnp.asarray(b), _jax(planes)),
                 gha.subtract(t(b), _tensors(planes)), "subtract", peak=PEAK)


def test_batched_streams_equal_single(bands):
    """The stream axis (S = 2, two different inputs) gives each stream's
    planes as alone: it only widens the lanes."""
    _, b = bands
    both = np.stack([b, b[..., ::-1, :].copy()])
    got = gha.extract(t(both))
    for s in range(2):
        alone = gha.extract(t(both[s]))
        for k in alone:
            assert_equal(alone[k], got[k][s], k)


def test_pack_device(coded):
    """JAX planes: the port's device packer equals its host frame.pack and
    the JAX device packer byte for byte."""
    planes, ref = coded
    got = device_pack.pack_device(_tensors(planes), 2)
    assert_equal(ref, got, "pack_device vs frame.pack")
    assert_equal(np.asarray(jdp.pack_device(_jax(planes), 2)), got,
                 "pack_device vs JAX pack_device")


def test_tonal_bits_equal_host_walk(coded):
    """The plane-wise tonal-block bits that the numQU shrink budgets with
    equal the per-frame host walk (WriteTonalBlock dry run)."""
    planes, _ = coded
    tones = planes["tones"]
    host = encoder._tonal_section_bits(tones, 2)
    dev = device_pack.tonal_fields_device({k: t(v) for k, v in tones.items()},
                                          2)[3]
    assert np.array_equal(dev.numpy().astype(np.int64), host)
    assert host.sum() > 0, "no tonal block: the test would be vacuous"


def test_decode_track(coded):
    _, frames = coded
    ref = jdec.decode_track(frames, 2)
    got = decoder.decode_track(frames, 2, device="cpu")
    assert ref.shape == got.shape and ref.dtype == got.dtype
    assert np.abs(ref - got).max() <= 1e-5
    assert np.abs(got).max() > 0.01
