"""The port's selfcheck, the LP2 modes ``at3_full`` and ``at3_plain`` on the
CPU: their hashes against the port's ``cpu`` key, and stream 0's bytes
against the JAX encoder's ``encode_frames_bytes`` on the same numpy input.

The JAX tool's stored ``cpu`` key for these two modes
(tests/golden/selfcheck_hashes.json) was written in commit 70000a6, before
later commits changed the JAX encoder's LP2 bytes; ``tools/selfcheck.py``
itself reports MISMATCH for both on the CPU.  So these modes are held to the
JAX package's current output, not to that key.  The other three modes are
in tests/test_torch_selfcheck.py.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.models.atrac3.encoder import \
    encode_frames_bytes as jax_encode_frames_bytes
from atracdenc_tpu_torch import selfcheck
from atracdenc_tpu_torch.testing import cpu_setup, roll_jax_scans

cpu_setup()
MODES = ("at3_full", "at3_plain")


@pytest.fixture(autouse=True, scope="module")
def _rolled_jax_scans():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()                   # no rolled trace outlives the file


@pytest.fixture(scope="module")
def frames():
    return selfcheck.compute("cpu", MODES)


@pytest.mark.parametrize("mode", MODES)
def test_hash_equals_port_cpu_key(frames, mode):
    assert frames[mode].shape == (4, 64, 384)
    with open(selfcheck.HASH_FILE) as fp:
        assert selfcheck.digest(frames[mode]) == json.load(fp)["cpu"][mode]


@pytest.mark.parametrize("mode", MODES)
def test_stream0_equals_jax_encoder(frames, mode):
    """Byte for byte: the JAX tool's own call (encode_frames_bytes with the
    mode's options) on stream 0 of the same corpus."""
    pcm = selfcheck.corpus()[0]
    theirs = np.asarray(jax_encode_frames_bytes(jnp.asarray(pcm),
                                                **selfcheck.AT3_MODES[mode]))
    ours = frames[mode][0]
    assert theirs.shape == ours.shape
    assert np.array_equal(ours, theirs), \
        f"{int((ours != theirs).any(-1).sum())} of {len(ours)} frames differ"

