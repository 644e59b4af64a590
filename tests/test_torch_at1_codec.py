"""The port's ATRAC1 codec end to end on the CPU, against the JAX package and
the reference's files.

Encoder: the integer planes (short_mask, bfu_idx, wordlen, sfi, mant) of
both goldens equal the JAX encoder's, whole-track and chunked; the bytes
(shared host packer) equal JAX's and reach the reference identities of
the JAX package: 0.93996 on at1_golden, 0.98019 on at1_stress (0.9400 and
0.9802 to four places), counted over every frame of the reference AEA,
the writer's zero dummy frame included.  Decoder: ``decode_frames`` within
1e-5 of JAX's and below 2e-4 of the reference decoder's PCM (the bound of
tests/test_at1_golden.py); the default ``decode_track`` equals the
reference decoder sample for sample.  CLI: encode, decode and the probes.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.containers import aea
from atracdenc_tpu.io import audio, wav
from atracdenc_tpu.models.atrac1 import decoder as jdec
from atracdenc_tpu.models.atrac1 import encoder as jenc
from atracdenc_tpu.models.atrac1 import frame
from atracdenc_tpu_torch import cli, runtime
from atracdenc_tpu_torch.models.atrac1 import decoder, device_pack, encoder
from atracdenc_tpu_torch.testing import (assert_close, assert_equal, cpu_setup,
                                         roll_jax_scans, t)

cpu_setup()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PLANES = ("short_mask", "bfu_idx", "wordlen", "sfi", "mant")
CASES = {"at1_golden": ("at1_ref.aea", 0.93995),
         "at1_stress_pcm": ("at1_stress_ref.aea", 0.98015)}


@pytest.fixture(autouse=True, scope="module")
def _rolled_jax_scans():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()                   # no rolled trace outlives the file


def _merge(planes):
    return {k: np.swapaxes(np.asarray(planes[k]), 0, 1).reshape(
        (-1,) + np.shape(planes[k])[2:]) for k in PLANES}


def _split(planes, channels):
    return {k: v.reshape((-1, channels) + v.shape[1:]).swapaxes(0, 1)
            for k, v in planes.items() if k != "valid"}


@pytest.mark.parametrize("name", sorted(CASES))
def test_encoder_vs_jax_and_reference(name):
    ref_file, floor = CASES[name]
    pcm = np.load(os.path.join(GOLDEN, f"{name}.npz"))["pcm_in"]
    theirs = jenc.encode_track(pcm)
    whole = encoder.encode_track(pcm, device="cpu")
    chunked = encoder.encode_track(pcm, chunk_frames=7, device="cpu")
    for k in PLANES:
        assert_equal(theirs[k], whole[k], f"{k} whole")
        assert_equal(theirs[k], chunked[k], f"{k} chunked")
    assert_equal(theirs["clip_count"], whole["clip_count"], "clip_count")
    assert_close(theirs["clip_max"], chunked["clip_max"], "clip_max")
    ours, jaxb = frame.pack(_merge(whole)), frame.pack(_merge(theirs))
    assert (ours == jaxb).mean() >= 0.99
    ref, _, _, _ = aea.read(os.path.join(GOLDEN, ref_file))
    assert ours.shape == ref.shape
    ident = (ours == ref).mean()
    assert ident >= floor, f"{name}: identity {ident:.5f} < {floor}"


def test_mono_fixed_windows_and_stream_axis():
    """Mono (the one-channel loudness rule), --notransient masks, and the
    leading stream axis: [S, C, T] equals S separate encodes, and the
    device packer's bytes equal the host packer's."""
    pcm = np.load(os.path.join(GOLDEN, "at1_golden.npz"))["pcm_in"][:, :512 * 12]
    mono = pcm[:1]
    assert_equal(jenc.encode_track(mono)["wordlen"],
                 encoder.encode_track(mono, device="cpu")["wordlen"], "mono")
    # chunked against chunked: on this cut the JAX package's own whole-track
    # and chunked mantissas differ in one value (an XLA float knife edge);
    # the port's whole and chunked planes are equal
    fixed = dict(window_mode="fixed", window_mask=5)
    theirs = jenc.encode_track(pcm, chunk_frames=5, **fixed)
    ours = encoder.encode_track(pcm, chunk_frames=5, device="cpu", **fixed)
    whole = encoder.encode_track(pcm, device="cpu", **fixed)
    for k in PLANES:
        assert_equal(theirs[k], ours[k], f"{k} fixed windows")
        assert_equal(whole[k], ours[k], f"{k} fixed windows, whole")
    batch = np.stack([pcm, pcm[::-1] * 0.5])
    planes = encoder.encode_frames(t(batch))
    for s in range(2):
        one = encoder.encode_frames(t(batch[s]))
        for k in PLANES:
            assert_equal(one[k], planes[k][s], f"{k} stream {s}")
    merged = {k: planes[k].transpose(1, 2).reshape((-1,) + planes[k].shape[3:])
              for k in PLANES}
    host = frame.pack({k: v.numpy() for k, v in merged.items()})
    assert_equal(host, device_pack.pack_device(merged), "pack_device")


def test_chunk_state_from_jax():
    """The JAX encoder's chunk carry {pcm_tail, loud}, brought over through
    numpy, continues the port's encode exactly like the port's own carry."""
    pcm = np.load(os.path.join(GOLDEN, "at1_stress_pcm.npz"))["pcm_in"][:, :512 * 16]
    head, rest = pcm[:, :512 * 8], pcm[:, 512 * 8:]
    _, jstate = jenc.encode_frames_chunk(head, None, rest[:, :512])
    _, state = encoder.encode_frames_chunk(t(head), None, t(rest[:, :512]))
    ported = runtime.state_from_numpy(jax.device_get(jstate), "cpu")
    assert_equal(jstate["pcm_tail"], state["pcm_tail"], "pcm_tail")
    assert_close(jstate["loud"], state["loud"], "loud")
    a, _ = encoder.encode_frames_chunk(t(rest), state)
    b, _ = encoder.encode_frames_chunk(t(rest), ported)
    for k in PLANES:
        assert_equal(a[k], b[k], k)
    assert runtime.state_to_numpy(state)["loud"].dtype == np.float32


def test_decoder_vs_jax_and_reference():
    g = np.load(os.path.join(GOLDEN, "at1_golden.npz"))
    frames, ch, _, _ = aea.read(os.path.join(GOLDEN, "at1_ref.aea"))
    planes = _split(frame.unpack(frames), ch)
    args = [planes[k] for k in ("short_mask", "wordlen", "sfi", "mant")]
    theirs = jdec.decode_frames(*(jnp.asarray(a) for a in args))
    ours = decoder.decode_frames(*(t(a) for a in args))
    assert_close(theirs, ours, "decode_frames", rtol=0, atol=1e-5)
    ref = g["ref_decoded"]
    n = min(ref.shape[1], ours.shape[1])
    assert np.abs(ours.numpy()[:, :n] - ref[:, :n]).max() < 2e-4
    exact = decoder.decode_track(planes)
    assert np.array_equal(exact[:, :n], ref[:, :n])
    batched = decoder.decode_track(planes, exact=False, device="cpu")
    assert_equal(ours, batched, "decode_track(exact=False)")


def test_cli_round_trip_and_probes(tmp_path):
    src = str(tmp_path / "in.wav")
    k = np.arange(512 * 30)
    sig = 0.4 * np.sin(2 * np.pi * 997 * k / 44100)
    sig[8000:8400] += 0.3 * np.random.default_rng(6).standard_normal(400)
    pcm = np.stack([sig, 0.7 * sig]).astype(np.float32)
    wav.write(src, pcm, 44100)
    enc, dec = str(tmp_path / "out.aea"), str(tmp_path / "out.wav")
    cli.main(["-e", "atrac1", "-i", src, "-o", enc, "--nostdout", "--device", "cpu"])
    frames, ch, _, length = aea.read(enc)
    assert frames.shape == (60, 212) and ch == 2
    cli.main(["-d", "-i", enc, "-o", dec, "--nostdout"])
    out, rate = audio.read(dec)
    assert rate == 44100 and out.shape == (2, length)
    rms = lambda x: np.sqrt(np.mean(np.square(x[:, 1024:length - 1024])))
    assert abs(20 * np.log10(rms(out) / rms(pcm))) < 1.0

    raw_out = str(tmp_path / "out.raw")
    cli.main(["-e", "atrac1", "--notransient=7", "--container", "raw", "-i", src,
              "-o", raw_out, "--nostdout", "--device", "cpu"])
    assert os.path.getsize(raw_out) == 60 * 212
    exact_out = str(tmp_path / "exact.aea")
    cli.main(["-e", "atrac1", "--exact", "-i", src, "-o", exact_out, "--nostdout"])
    assert aea.read(exact_out)[0].shape == (60, 212)

    bad = tmp_path / "bad.aea"
    bad.write_bytes(b"not an aea file" * 200)
    for argv in (["-e", "atrac1", "--bfuidxconst", "9", "-i", src, "-o", enc],
                 ["-e", "atrac1", "--container", "rm", "-i", src, "-o", enc],
                 ["-d", "-i", str(bad), "-o", dec]):
        with pytest.raises(SystemExit) as exc:
            cli.main(argv + ["--nostdout", "--device", "cpu"])
        assert exc.value.code not in (0, None), argv
