"""The slice end to end: the port's ATRAC3 encoder with the fused memo
(``fused_memo=True``: kernel D's plain version on the CPU) against the JAX
encoder traced with its fused Pallas memo (``bitalloc._PALLAS_QUANT_DEFAULT
= True``, the ``ATRACDENC_TPU_PALLAS_QUANT=1`` switch; the kernel runs in
interpret mode), default mode (gain control + tonal components), one
stereo stream of 4 frames.  Every integer plane must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atracdenc_tpu.models.atrac3 import bitalloc as jba
from atracdenc_tpu.models.atrac3.encoder import encode_frames as jax_encode_frames
from atracdenc_tpu_torch.models.atrac3.encoder import encode_frames
from atracdenc_tpu_torch.testing import assert_equal, cpu_setup, roll_jax_scans

cpu_setup()
DEFAULT = dict(no_gain_control=False, no_tonal=False)


@pytest.fixture(autouse=True, scope="module")
def _fused_jax_memo():
    jax.clear_caches()                   # no earlier trace of the XLA memo
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        mp.setattr(jba, "_PALLAS_QUANT_DEFAULT", True)
        yield
    jax.clear_caches()                   # no fused trace outlives the file


def _pcm():
    """A 997 Hz tone (tonal components), a decaying 3 kHz burst (gain
    control) and noise, 2 channels x 4 frames."""
    rng = np.random.default_rng(9)
    n = np.arange(4 * 1024)
    tone = 0.3 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
    burst = np.where(n > 2200, 0.5 * np.sin(2 * np.pi * 3000.0 * n / 44100.0)
                     * np.exp(-(n - 2200) / 600.0), 0.0)
    pcm = np.stack([tone + burst, 0.8 * tone - burst])
    return (pcm + 0.02 * rng.standard_normal(pcm.shape)).astype(np.float32)


def test_fused_memo_encoder_matches_jax():
    pcm = _pcm()
    theirs = jax_encode_frames(jnp.asarray(pcm), **DEFAULT)
    ours = encode_frames(torch.from_numpy(pcm), fused_memo=True, **DEFAULT)
    ints = [k for k, v in ours.items()
            if not torch.is_floating_point(v) and k in theirs]
    assert {"num_bfu", "coding_mode", "wordlen", "sfi", "mant",
            "gain_npoints", "tonal_active"} <= set(ints)
    for k in ints:
        assert_equal(theirs[k], ours[k], k)
    assert int(ours["gain_npoints"].sum()) > 0
    assert int(ours["tonal_active"].sum()) > 0
