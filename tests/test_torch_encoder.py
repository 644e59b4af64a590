"""End to end, no gain control / no tonal (and joint stereo): the port's
ATRAC3 encoder on the CPU against the JAX encoder and the reference frames.

Bytes go through the JAX package's host packer (models/atrac3/frame.py).
Floors: port vs JAX bytes >= 0.99; port vs the reference oracle at the
floors the JAX package's own golden tests pin (tests/test_at3_codec.py:41,
tests/test_at3_js.py).  Chunked encoding must equal whole-track encoding
(integer planes and bytes; raw float planes within rtol=1e-5).  The
default mode (gain + tonal) is in tests/test_torch_encoder_default.py, a
separate file so the two JAX compiles run on separate test workers.
"""
import os

import jax
import numpy as np
import pytest

from atracdenc_tpu.models.atrac3 import frame
from atracdenc_tpu.models.atrac3.encoder import encode_track as jax_encode_track
from atracdenc_tpu.models.atrac3.encoder import init_state as jax_init_state
from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.models.atrac3.encoder import (encode_frames_chunk,
                                                       encode_track)
from atracdenc_tpu_torch.testing import cpu_setup, roll_jax_scans, t

cpu_setup()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True, scope="module")
def _rolled_jax_scans():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()                   # no rolled trace outlives the file


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "at3_golden.npz"))


def test_golden_vs_jax_and_reference(golden):
    pcm, ref = golden["pcm_in"], golden["ref_frames"]
    ours = encode_track(pcm, frame_bytes=384, device="cpu")
    theirs = jax_encode_track(pcm, frame_bytes=384)
    fo, fj = frame.pack(ours, 384), frame.pack(theirs, 384)
    assert fo.shape == ref.shape
    assert (fo == fj).mean() >= 0.99, f"vs JAX {(fo == fj).mean():.4f}"
    assert (fo == ref).mean() >= 0.99, f"vs reference {(fo == ref).mean():.4f}"
    for k in ("num_bfu", "coding_mode", "wordlen", "sfi", "gain_npoints"):
        assert ours[k].dtype == np.asarray(theirs[k]).dtype, k
        assert ours[k].shape == np.asarray(theirs[k]).shape, k


def test_joint_stereo_vs_reference():
    g = np.load(os.path.join(GOLDEN, "at3_js_golden.npz"))
    for pcm, ref, floor in ((g["pcm_in"], g["ref_frames"], 0.99),
                            (g["pcm_mono"], g["ref_mono"], 0.85)):
        planes = encode_track(pcm, frame_bytes=192, js=True,
                              no_gain_control=False, no_tonal=False,
                              device="cpu")
        ident = (frame.pack(planes, 192, js=True) == ref).mean()
        assert ident > floor, f"JS {pcm.shape[0]} ch: {ident:.4f}"


@pytest.mark.parametrize("no_gain", [True, False])
def test_chunked_matches_whole_track(no_gain):
    rng = np.random.default_rng(3)
    n = np.arange(1024 * 12)
    pcm = np.clip(0.4 * np.sin(2 * np.pi * 997 * n / 44100)[None] * [[1.0], [0.8]]
                  + 0.05 * rng.standard_normal((2, n.size)), -1, 1
                  ).astype(np.float32)
    opts = dict(no_gain_control=no_gain, no_tonal=no_gain, device="cpu")
    whole = encode_track(pcm, **opts)
    chunked = encode_track(pcm, chunk_frames=5, **opts)
    for k in whole:
        if k in ("clip_max", "loudness"):
            np.testing.assert_allclose(chunked[k], whole[k], rtol=1e-5)
        elif k != "clip_count":
            assert np.array_equal(whole[k], chunked[k]), k
    assert np.array_equal(frame.pack(whole, 384), frame.pack(chunked, 384))


def test_chunk_state_shares_the_jax_layout():
    """The JAX encoder's fresh chunk state, carried over through numpy,
    starts the port's chunk exactly like the port's own fresh state; the
    port's carried state keeps the JAX state's keys, shapes and dtypes."""
    jax_state = jax.device_get(jax_init_state(2))
    pcm = np.random.default_rng(4).uniform(-0.3, 0.3, (2, 4096)).astype(np.float32)
    opts = dict(no_gain_control=False, no_tonal=False)
    ref, st = encode_frames_chunk(t(pcm), None, None, **opts)
    got, _ = encode_frames_chunk(t(pcm), runtime.state_from_numpy(jax_state, "cpu"),
                                 None, **opts)
    for k in ref:
        assert np.array_equal(ref[k].numpy(), got[k].numpy()), k
    flat = lambda d: {k: v for k, v in d.items() if not isinstance(v, dict)} \
        | {f"gain.{k}": v for k, v in d["gain"].items()}
    ours, theirs = flat(runtime.state_to_numpy(st)), flat(jax_state)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert ours[k].shape == theirs[k].shape and ours[k].dtype == theirs[k].dtype, k


def test_cli_encodes_and_refuses_what_is_not_ported(tmp_path):
    from atracdenc_tpu.containers import oma
    from atracdenc_tpu.io import wav
    from atracdenc_tpu_torch import cli

    src, dst = str(tmp_path / "in.wav"), str(tmp_path / "out.oma")
    pcm = np.random.default_rng(5).uniform(-0.3, 0.3, (2, 5000)).astype(np.float32)
    wav.write(src, pcm, 44100)
    cli.main(["-e", "atrac3", "-i", src, "-o", dst, "--nostdout", "--device", "cpu"])
    frames, info = oma.read(dst)
    assert frames.shape == (5, 384) and info["codec"] == oma.CODEC_ATRAC3
    for extra in (["-e", "atrac1"], ["-d"]):
        with pytest.raises(SystemExit) as exc:
            cli.main(extra + ["-i", src, "-o", dst, "--device", "cpu"])
        assert exc.value.code not in (0, None), extra
    # ATRAC3+ is ported: it encodes (2048-byte frames)
    cli.main(["-e", "atrac3plus", "-i", src, "-o", dst, "--nostdout",
              "--device", "cpu"])
    frames, info = oma.read(dst)
    assert frames.shape == (3, 2048) and info["codec"] == oma.CODEC_ATRAC3PLUS
    # ATRAC3 --exact and --yaml-log are ported: they encode
    log = tmp_path / "g.yaml"
    for extra in (["--exact"], ["--yaml-log", str(log)]):
        cli.main(["-e", "atrac3", "-i", src, "-o", dst, "--nostdout",
                  "--device", "cpu"] + extra)
        assert oma.read(dst)[0].shape == (5, 384), extra
    assert log.read_text().count("---\n") == 5000 // 1024
