"""The benchmark's plain model of the upstream ATRAC3+ encoder
(``portbench/reference/upstream/atrac3plus/``, through
``portbench/reference/atrac3plus.py``): the compiled upstream writer's
golden bytes with GHA off, the JAX package's bytes with GHA 7, its parser
and dequantiser, and what it loads."""
import os
import subprocess
import sys

import numpy as np
import pytest

from atracdenc_tpu.models.atrac3p import encoder as jenc
from atracdenc_tpu.models.atrac3p import frame as jframe
from portbench import manifest
from portbench.reference import atrac3plus
from portbench.reference.upstream.atrac3plus import encoder as model
from portbench.reference.upstream.atrac3plus import frame as frame_io
from portbench.reference.upstream.atrac3plus import tables as T
from test_torch_at3p_codec import random_pcm

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CFG = manifest.cell("atrac3plus.batch").config


@pytest.mark.parametrize("corpus", ["mixed", "loud"])
def test_gha_off_is_the_upstream_writer_byte_for_byte(corpus):
    """Both corpora of the compiled upstream writer (GHA off: its tree
    builds without libgha), every byte of all 8 frames; the loud one
    shrinks NumQuantUnits."""
    d = np.load(os.path.join(GOLDEN, "at3p_golden.npz"))
    rows = atrac3plus.encode_rows(dict(CFG, gha_mask=None),
                                  d[f"pcm_{corpus}"])
    ref = d[f"ref_{corpus}"]
    assert rows.shape == ref.shape == (8, 2048)
    assert (rows == ref).all()
    if corpus == "loud":
        planes = model.encode_track(d["pcm_loud"], None)
        assert (planes["num_qu"] < 32).any()


@pytest.mark.parametrize("channels", [2, 1], ids=["stereo", "mono"])
@pytest.mark.parametrize("seed", [1, 2])
def test_gha7_bytes_equal_the_jax_package(seed, channels):
    """GHA mask 7 on random_pcm: every frame's bytes equal the JAX
    package's ``encode_track`` + ``frame.pack`` (no float knife edge falls
    on these inputs; a frame that differed would have to be classified as
    one, as tests/test_torch_at3p_codec.py classifies the port's), and
    the tonal model codes waves in both."""
    pcm = random_pcm(seed, frames=5)[:channels]
    planes = model.encode_track(pcm, 7)
    jp = jenc.encode_track(pcm, use_gha=True)
    rows = frame_io.pack(planes, channels)
    np.testing.assert_array_equal(rows, jframe.pack(jp, channels))
    assert planes["tones"]["valid"].sum() == jp["tones"]["valid"].sum() > 0
    np.testing.assert_array_equal(planes["num_qu"], jp["num_qu"])


def test_frame_at_a_time_carries_state():
    """The model's state crosses frames: fed one frame at a time with the
    output drained at every frame, it gives the whole track's planes."""
    pcm = random_pcm(3, frames=4)
    enc = model.Encoder(2, 7)
    got = []
    for i in range(4):
        got += enc.feed(pcm[:, i * 2048:(i + 1) * 2048])
        assert len(got) == max(i, 1)          # one frame of look-ahead
    got += enc.flush()
    whole = model.encode_track(pcm, 7)
    stacked = model.stack(got, 2)
    for k in ("num_qu", "sfi", "mant", "spec_tab"):
        np.testing.assert_array_equal(stacked[k], whole[k])


def test_spectra_parse_and_dequantise():
    """``spectra`` reads rows back to the mantissas times their steps and
    scale factors; a row that does not parse raises ValueError."""
    pcm = random_pcm(4, frames=5)
    planes = model.encode_track(pcm, 7)
    rows = frame_io.pack(planes, 2)
    ref = atrac3plus.Reference(CFG)
    sp = ref.spectra(rows)
    assert sp.shape == (rows.shape[0], 2, 2048)
    want = np.zeros_like(sp)
    for f in range(rows.shape[0]):
        for q in range(int(planes["num_qu"][f])):
            s, n = T.SPECS_START[q], T.SPECS_PER_BLOCK[q]
            wl = T.FIXED_WORDLEN[q]
            want[f, :, s:s + n] = planes["mant"][:, f, q, :n] * (
                T.MANT_TAB[wl] * T.SCALE_TABLE[planes["sfi"][:, f, q]])[:, None]
    np.testing.assert_array_equal(sp, want)
    assert np.abs(sp).max() > 0
    p = frame_io.unpack_frame(rows[2], 2)
    assert p["num_qu"] == planes["num_qu"][2]
    np.testing.assert_array_equal(p["mant"], planes["mant"][:, 2])
    bad = rows[2:3].copy()
    bad[0, 0] ^= 0x80                          # the start bit
    with pytest.raises(ValueError):
        ref.spectra(bad)


def test_reference_loads_nothing_of_the_program():
    """The ATRAC3+ model and its adapter load numpy and the standard
    library only: not the program, not torch, not JAX."""
    code = ("import portbench.reference.atrac3plus\n"
            "import sys\n"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    loaded = set(p.stdout.split())
    assert "numpy" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "atracdenc_tpu",
                         "atracdenc_tpu_torch", "torch"}
