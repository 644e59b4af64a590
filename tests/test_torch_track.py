"""The shared track loop (``models/track.py``) over the three codecs on the
CPU: ``encode_track`` in chunks that do not divide the track, or in one
chunk that spans it, gives the planes and the device-packed bytes of the
track as one chunk of the codec's batched chunk call; ``progress`` is
called once a chunk and ends at 100; and ATRAC3+'s first chunk carries no
tone frame in output frame 0."""
import os

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.models import track
from atracdenc_tpu_torch.models.atrac1 import device_pack as at1_pack
from atracdenc_tpu_torch.models.atrac1 import encoder as at1_encoder
from atracdenc_tpu_torch.models.atrac3 import device_pack as at3_pack
from atracdenc_tpu_torch.models.atrac3 import encoder as at3_encoder
from atracdenc_tpu_torch.models.atrac3p import device_pack as at3p_pack
from atracdenc_tpu_torch.models.atrac3p import encoder as at3p_encoder
from atracdenc_tpu_torch.testing import assert_equal, cpu_setup, t

cpu_setup()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
AT3_OPTS = dict(no_gain_control=False, no_tonal=False)

# codec -> (golden file and key, samples a frame, frames, uneven chunk,
# encode_track's options, the one-chunk call, the device packer)
CODECS = {
    "atrac1": (
        ("at1_golden.npz", "pcm_in"), 512, 12, 5, {},
        at1_encoder.encode_frames,
        lambda p, c: at1_pack.pack_device(at1_pack.merge_channels(p))),
    "atrac3": (
        ("at3_golden.npz", "pcm_in"), 1024, 8, 3, AT3_OPTS,
        lambda x: at3_encoder.encode_frames(x, **AT3_OPTS),
        lambda p, c: at3_pack.pack_device(p, 384)),
    "atrac3plus": (
        ("at3p_golden.npz", "pcm_mixed"), 2048, 8, 3, {},
        lambda x: at3p_encoder.encode_chunk_device(x[None], None, None)[0],
        at3p_pack.pack_device),
}
ENCODERS = {"atrac1": at1_encoder, "atrac3": at3_encoder,
            "atrac3plus": at3p_encoder}


def _track(codec):
    """The golden cut 100 samples short of ``frames`` whole frames (the loop
    pads it), and the padded track."""
    (name, key), n, frames = CODECS[codec][:3]
    pcm = np.load(os.path.join(GOLDEN, name))[key][:, :n * frames - 100]
    return pcm, np.pad(pcm, ((0, 0), (0, 100)))


def _assert_planes(want, got, where=""):
    assert sorted(want) == sorted(got), where
    for k in want:
        if isinstance(want[k], dict):
            _assert_planes(want[k], got[k], f"{where}{k}.")
        else:
            assert_equal(want[k], got[k], where + k)


@pytest.mark.parametrize("chunk", ["uneven", "spanning"])
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_chunked_track_equals_one_chunk(codec, chunk):
    _, n, frames, uneven, opts, one, pack = CODECS[codec]
    pcm, padded = _track(codec)
    chunk_frames = uneven if chunk == "uneven" else frames + 1
    calls = []
    got = ENCODERS[codec].encode_track(pcm, chunk_frames=chunk_frames,
                                       progress=calls.append, device="cpu",
                                       **opts)
    want = runtime.state_to_numpy(one(t(padded)))
    _assert_planes(want, got)
    channels = pcm.shape[0]
    assert_equal(pack(runtime.state_from_numpy(want, "cpu"), channels),
                 pack(runtime.state_from_numpy(got, "cpu"), channels),
                 "bytes")
    assert len(calls) == -(-frames // chunk_frames)
    assert calls == sorted(calls) and calls[-1] == 100


def test_at3p_first_chunk_has_no_tone_frame():
    """Output frame p carries tone frame p - 1, so a track's output frame 0
    has none: every tone plane is zero there (the chunk window's context
    frame before the track is silence, not a tone frame), and tones are
    found in the frames after it."""
    _, padded = _track("atrac3plus")
    planes, _ = at3p_encoder.encode_chunk_device(t(padded)[None], None, None)
    tones = planes["tones"]
    assert tones["valid"][:, 1:].any()
    for k, v in tones.items():
        ax = track.frame_axis(f"tones.{k}", at3p_encoder.PER_FRAME)
        assert not torch.any(v.select(ax, 0) != 0), k
