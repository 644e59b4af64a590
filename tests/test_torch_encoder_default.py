"""End to end, default mode (gain control + tonal components): the port's
ATRAC3 encoder on the CPU against the JAX encoder and the reference frames
of tests/golden/at3_default_golden.npz.

Floors: port vs JAX bytes >= 0.99; port vs the reference >= 0.98 on
pcm_in (tests/test_at3_gain.py:52) and > 0.85 on pcm_stress
(tests/test_at3_gain.py:62); gain curves equal to the JAX encoder's on
pcm_in.  Also a batched [streams, C, T] call equals per-stream calls.
"""
import os

import jax
import numpy as np
import pytest
import torch

from atracdenc_tpu.models.atrac3 import frame
from atracdenc_tpu.models.atrac3.encoder import encode_track as jax_encode_track
from atracdenc_tpu_torch.models.atrac3.encoder import encode_frames, encode_track
from atracdenc_tpu_torch.testing import cpu_setup, roll_jax_scans

cpu_setup()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DEFAULT = dict(no_gain_control=False, no_tonal=False)


@pytest.fixture(autouse=True, scope="module")
def _rolled_jax_scans():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()                   # no rolled trace outlives the file


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "at3_default_golden.npz"))


def test_default_mode_vs_jax_and_reference(golden):
    pcm, ref = golden["pcm_in"], golden["ref_frames"]
    ours = encode_track(pcm, device="cpu", **DEFAULT)
    theirs = jax_encode_track(pcm, **DEFAULT)
    fo, fj = frame.pack(ours, 384), frame.pack(theirs, 384)
    assert (fo == fj).mean() >= 0.99, f"vs JAX {(fo == fj).mean():.4f}"
    assert (fo == ref).mean() >= 0.98, f"vs reference {(fo == ref).mean():.4f}"
    for k in ("gain_npoints", "gain_levels", "gain_locs"):
        assert np.array_equal(ours[k], theirs[k]), k
    assert int(ours["gain_npoints"].sum()) > 0
    assert ours["tonal_active"].shape == np.asarray(theirs["tonal_active"]).shape


def test_stress_vs_reference(golden):
    ours = encode_track(golden["pcm_stress"], device="cpu", **DEFAULT)
    ident = (frame.pack(ours, 384) == golden["ref_stress"]).mean()
    assert ident > 0.85, f"vs reference {ident:.4f}"


def test_stream_batch_equals_single_streams(golden):
    pcm = np.stack([golden["pcm_in"], golden["pcm_stress"][:, :8192]])
    batched = encode_frames(torch.from_numpy(pcm), **DEFAULT)
    for s in range(2):
        single = encode_frames(torch.from_numpy(pcm[s]), **DEFAULT)
        fb = frame.pack({k: v[s].numpy() for k, v in batched.items()}, 384)
        fs = frame.pack({k: v.numpy() for k, v in single.items()}, 384)
        assert np.array_equal(fb, fs), s
