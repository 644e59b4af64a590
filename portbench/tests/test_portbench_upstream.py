"""The reference is the upstream encoder: on the repository's golden
corpora it codes the frames of the compiled dcherednik/atracdenc binary
byte for byte (``tests/golden/``, read only)."""
import os

import numpy as np
import pytest

from portbench import manifest
from portbench.reference import atrac1, atrac3

GOLDEN = os.path.join(manifest.ROOT, "tests", "golden")
AT3 = dict(frame_bytes=384, joint_stereo=False, bfu_idx_const=0)


@pytest.mark.parametrize("npz,pcm_key,ref_key,gain,tonal", [
    ("at3_default_golden.npz", "pcm_stress", "ref_stress", True, True),
    ("at3_tonal_golden.npz", "pcm_in", "ref_frames", False, True),
], ids=["gain_and_tonal", "tonal"])
def test_atrac3_frames_are_upstream_s(npz, pcm_key, ref_key, gain, tonal):
    d = np.load(os.path.join(GOLDEN, npz))
    cfg = dict(AT3, gain_control=gain, tonal_components=tonal)
    rows = atrac3.encode_rows(cfg, d[pcm_key])
    ref = d[ref_key]
    n = min(len(rows), len(ref))
    assert n >= 8
    assert (rows[:n] == ref[:n]).all()


def test_atrac1_units_are_upstream_s():
    """The AEA file holds a zero unit in place of the first one
    (``aea.cpp``'s first-write skip) after a 2048-byte header."""
    pcm = np.load(os.path.join(GOLDEN, "at1_stress_pcm.npz"))["pcm_in"]
    with open(os.path.join(GOLDEN, "at1_stress_ref.aea"), "rb") as fp:
        data = fp.read()
    ref = np.frombuffer(data[2048:], np.uint8).reshape(-1, 212)
    cfg = dict(bfu_idx_const=0, window_mode="auto", window_mask=0)
    rows = atrac1.encode_rows(cfg, pcm)
    rows[0] = 0
    n = min(len(rows), len(ref))
    assert n >= 16
    assert (rows[:n] == ref[:n]).all()


def test_spectra_of_upstream_rows():
    """Rows dequantise to spectra of the coded music's scale."""
    d = np.load(os.path.join(GOLDEN, "at3_default_golden.npz"))
    sp = atrac3.Reference(dict(AT3, gain_control=True,
                               tonal_components=True)).spectra(
        d["ref_stress"][:4])
    assert sp.shape == (4, 2, 1024) and np.abs(sp).max() > 0
