"""The port's ATRAC3 QA decoder against the JAX package's, on the CPU.

Stage by stage on the same numpy inputs (IMDCT, windowed IMDCT with gain
demodulation, QMF synthesis, dequantisation), then whole tracks from the
reference containers in tests/golden, the quality-parity gate of
tests/test_at3_decoder.py on the port's own encode, and corrupt streams.

Tolerances: the dequantised planes are equal, dtypes included (the same
numpy code); matmul outputs within rtol=1e-5 plus 1e-6 of the output's
peak as absolute tolerance (testing.assert_close); decoded PCM within
1e-5 (measured: 0.0 on ref_c.{oma,at3,rm} and ref_js.oma).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atracdenc_tpu.containers import at3 as jat3, oma as joma, rm as jrm
from atracdenc_tpu.models.atrac3 import decoder as jdecoder
from atracdenc_tpu.models.atrac3 import filterbank as jfb
from atracdenc_tpu.models.atrac3 import frame as jframe
from atracdenc_tpu.models.atrac3 import mdct as jm3
from atracdenc_tpu.ops import mdct as jmdct
from atracdenc_tpu_torch.models.atrac3 import decoder, filterbank, frame
from atracdenc_tpu_torch.models.atrac3 import mdct as m3
from atracdenc_tpu_torch.models.atrac3.encoder import encode_track
from atracdenc_tpu_torch.ops import mdct
from atracdenc_tpu_torch.testing import assert_close, assert_equal, cpu_setup, t

cpu_setup()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PCM_TOL = 1e-5
CONTAINERS = {"ref_c.oma": joma, "ref_c.at3": jat3, "ref_c.rm": jrm,
              "ref_js.oma": joma}


def _read(name):
    frames, info = CONTAINERS[name].read(os.path.join(GOLDEN, name))
    return frames, info["channels"], info.get("joint_stereo", False)


@pytest.mark.parametrize("n", [256, 512])
def test_imdct(n):
    x = np.random.default_rng(n).standard_normal((3, 5, n // 2)).astype(np.float32)
    assert_close(jmdct.imdct(jnp.asarray(x)), mdct.imdct(t(x)), "imdct",
                 peak=1e-6)


def _valid_gain_points(seed, shape=(2, 5, 4)):
    """npoints 0..7 and strictly ascending locations, as a frame carries."""
    rng = np.random.default_rng(seed)
    npts = rng.integers(0, 8, shape).astype(np.int32)
    levels = rng.integers(0, 16, shape + (8,)).astype(np.int32)
    locs = np.sort(np.stack([rng.choice(32, 8, replace=False)
                             for _ in range(int(np.prod(shape)))]), axis=-1)
    return levels, locs.reshape(shape + (8,)).astype(np.int32), npts


def test_imdct_frames():
    levels, locs, npts = _valid_gain_points(11)
    specs = (0.05 * np.random.default_rng(12).standard_normal((2, 5, 1024))
             ).astype(np.float32)
    div = np.asarray(jm3.gain_divisors(*map(jnp.asarray, (levels, locs, npts))))
    scl = np.asarray(jm3.first_level_scale(jnp.asarray(levels), jnp.asarray(npts)))
    assert (npts > 0).any() and (npts == 0).any()
    assert_equal(div, m3.gain_divisors(t(levels), t(locs), t(npts)), "div")
    for kw in ({}, {"div": div, "scale": scl}):
        ref = jm3.imdct_frames(jnp.asarray(specs),
                               **{k: jnp.asarray(v) for k, v in kw.items()})
        got = m3.imdct_frames(t(specs), **{k: t(v) for k, v in kw.items()})
        assert_close(ref, got, f"imdct_frames {sorted(kw)}", peak=1e-6)


def test_synthesis():
    bands = (0.1 * np.random.default_rng(13).standard_normal((2, 4, 1280))
             ).astype(np.float32)
    assert_close(jfb.synthesis(jnp.asarray(bands)), filterbank.synthesis(t(bands)),
                 "synthesis", peak=1e-6)


def test_dequantize():
    frames, ch, js = _read("ref_c.oma")
    parsed = frame.unpack(frames, ch, js=js)
    ref = jdecoder.dequantize(jframe.unpack(frames, ch, js=js))
    got = decoder.dequantize(parsed)
    assert (got[1] > 0).any() or (got[0] != 0).any()
    for name, a, b in zip(("specs", "gain_np", "gain_lev", "gain_loc"), ref, got):
        assert_equal(a, b, name)


@pytest.mark.parametrize("name", sorted(CONTAINERS))
def test_decode_track(name):
    frames, ch, js = _read(name)
    ref = jdecoder.decode_track(frames, ch, js=js)
    got = decoder.decode_track(frames, ch, js=js, device="cpu")
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert np.abs(ref).max() > 0.1
    err = float(np.abs(got - ref).max())
    assert err <= PCM_TOL, f"{name}: max |port - jax| {err:.3g}"


def _psnr(x, y):
    e = x - y
    return 10 * np.log10((x ** 2).mean() / max((e ** 2).mean(), 1e-20))


def test_quality_parity_with_reference():
    """tests/test_at3_decoder.py's gate on the port's CPU encode: the PSNR
    of our frames within 0.05 dB of the reference encoder's, both decoded
    by the port's decoder over samples [1024, n - 2048)."""
    g = np.load(os.path.join(GOLDEN, "at3_golden.npz"))
    pcm, ref_frames = g["pcm_in"], g["ref_frames"]
    ours = frame.pack(encode_track(pcm, frame_bytes=384, device="cpu"), 384)
    dec_ref = decoder.decode_track(ref_frames, 2, device="cpu")
    dec_ours = decoder.decode_track(ours, 2, device="cpu")
    n = min(dec_ref.shape[1], pcm.shape[1]) - 2048
    x = pcm[:, 1024:n].astype(np.float64)
    p_ref = _psnr(x, dec_ref[:, 1024:n].astype(np.float64))
    p_ours = _psnr(x, dec_ours[:, 1024:n].astype(np.float64))
    assert p_ours > p_ref - 0.05, f"ours {p_ours:.2f} dB vs ref {p_ref:.2f} dB"


def _outcome(fn):
    try:
        return fn()
    except Exception as err:  # noqa: BLE001 — the outcome under test
        return type(err)


def test_corrupt_streams():
    """Seeded byte flips of ref_c.oma's frames: the port raises the error
    JAX raises, and otherwise decodes to finite PCM within +-1 that equals
    JAX's within the decoder's tolerance."""
    frames, ch, js = _read("ref_c.oma")
    raised = decoded = 0
    for seed in range(12):
        rng = np.random.default_rng(seed)
        bad = frames.copy()
        idx = rng.integers(0, bad.size, 1 + seed)
        bad.reshape(-1)[idx] ^= rng.integers(1, 256, idx.size).astype(np.uint8)
        ref = _outcome(lambda: jdecoder.decode_track(bad, ch, js=js))
        got = _outcome(lambda: decoder.decode_track(bad, ch, js=js, device="cpu"))
        if isinstance(ref, type):
            assert got is ref, (seed, ref, got)
            raised += 1
            continue
        assert isinstance(got, np.ndarray), (seed, got)
        assert np.isfinite(got).all() and np.abs(got).max() <= 1.0
        err = float(np.abs(got - ref).max())
        assert err <= PCM_TOL, f"seed {seed}: max |port - jax| {err:.3g}"
        decoded += 1
    assert raised and decoded, (raised, decoded)


def test_no_cpu_fallback():
    """The decoder's transforms run on CUDA unless the caller asks for the
    CPU: without a card the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    frames, ch, js = _read("ref_c.oma")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        decoder.decode_track(frames, ch, js=js)
