"""ATRAC3+ encoder and codec: the port against the JAX package, and the port
alone against the reference writer's frames and the JAX package's own
codec tests (CPU).

Against JAX (same numpy inputs): ``encode_track`` planes equal, dtypes
included (``sfi``, ``mant``, ``spec_tab``, ``num_qu`` and every tone
plane), for GHA masks 7 and 15 and GHA off, stereo and mono; the fused
``encode_frames_bytes`` bytes equal JAX's for C = 2 and 1.  No knife edge
flipped on these inputs (tests/test_torch_at3p_stages.py holds the stages
on the JAX stages' own inputs).  On two random inputs a mantissa flips at
a rounding edge; ``test_mantissa_flips_are_float_knife_edges`` names both
and shows the logic equal by input substitution.

The port alone: tests/test_at3p_codec.py's byte identity against the
reference writer (``at3p_golden.npz``), closed-loop PSNR and GHA gain, and
tests/test_at3p_chunked.py's chunked == whole-track cases.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from atracdenc_tpu.models.atrac3p import encoder as jenc
from atracdenc_tpu.models.atrac3p import gha as jgha, mdct as jmdct
from atracdenc_tpu_torch.models.atrac3p import decoder, device_pack, encoder
from atracdenc_tpu_torch.models.atrac3p import frame, gha, mdct
from atracdenc_tpu_torch.models.atrac3p import tables as T
from atracdenc_tpu_torch.ops import scale
from atracdenc_tpu_torch.testing import assert_equal, cpu_setup, t

cpu_setup()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def tonal_pcm(frames=4, channels=2, seed=0):
    """Two tones, quiet for the first half (envelopes), light noise."""
    n = np.arange(2048 * frames)
    x = (0.5 * np.sin(2 * np.pi * 689.0625 * n / 44100)
         + 0.2 * np.sin(2 * np.pi * 3000.5 * n / 44100))
    x[: n.size // 2] *= 0.05
    x = x + 0.01 * np.random.default_rng(seed).standard_normal(n.size)
    return np.clip(np.stack([x, 0.8 * x])[:channels], -1, 1).astype(np.float32)


def _assert_planes(ref, got):
    assert sorted(ref) == sorted(got)
    for k in ref:
        if isinstance(ref[k], dict):
            _assert_planes(ref[k], got[k])
        else:
            assert_equal(ref[k], got[k], k)


def _device_bytes(planes, channels):
    return device_pack.pack_device(
        {k: ({kk: t(vv) for kk, vv in v.items()} if isinstance(v, dict)
             else t(v)) for k, v in planes.items()}, channels).numpy()


@pytest.mark.parametrize("channels", [2, 1], ids=["stereo", "mono"])
@pytest.mark.parametrize("use_gha", [True, 15, False],
                         ids=["gha7", "gha15", "off"])
def test_encode_track_matches_jax(channels, use_gha):
    pcm = tonal_pcm(channels=channels)
    ref = jenc.encode_track(pcm, use_gha=use_gha)
    got = encoder.encode_track(pcm, use_gha=use_gha, device="cpu")
    _assert_planes(ref, got)
    if use_gha is not False:
        assert ref["tones"]["valid"].any()


def random_pcm(seed, frames=4):
    """Stereo: 1-4 tones of random frequency, amplitude and phase a
    channel, silent-ish before a random onset, random noise."""
    rng = np.random.default_rng(seed)
    n = np.arange(2048 * frames)
    x = np.zeros((2, n.size))
    for c in range(2):
        for _ in range(rng.integers(1, 5)):
            f, a = rng.uniform(50, 12000), rng.uniform(0.02, 0.4)
            x[c] += a * np.sin(2 * np.pi * f * n / 44100 + rng.uniform(0, 6.28))
        x[c, :rng.integers(0, n.size)] *= rng.uniform(0, 0.2)
        x[c] += rng.uniform(0.001, 0.05) * rng.standard_normal(n.size)
    return np.clip(x, -1, 1).astype(np.float32)


def _residual_spectra(pcm, jax_side):
    """The encoder's MDCT spectra of the GHA residual (mask 7), from the JAX
    package's stage functions or from the port's."""
    if jax_side:
        bands = jenc.band_frames(jnp.asarray(pcm))
        resid = jgha.subtract(bands, jgha.extract(bands))
        res = jnp.pad(resid[:, :-1], ((0, 0), (1, 0), (0, 0), (0, 0)))
        return np.asarray(jmdct.mdct_frames(res * T.RESIDUAL_SCALE))
    bands = encoder.band_frames(t(pcm))
    resid = gha.subtract(bands, gha.extract(bands))
    res = F.pad(resid[:, :-1], (0, 0, 0, 0, 1, 0))
    return mdct.mdct_frames(res * T.RESIDUAL_SCALE)


@pytest.mark.parametrize("seed", [1, 6])
def test_mantissa_flips_are_float_knife_edges(seed):
    """On random_pcm(1) and random_pcm(6) (GHA 7) one mantissa of 16,384
    differs from JAX's by 1: channel 1, frame 1, QU 2, line 6 (seed 1:
    pre-round value -8.499976 in JAX, -8.500011 here) and QU 22, line 116
    (seed 6: 0.50000495 in JAX, 0.49999565 here).  The residual's MDCT
    input differs in its last ulps (XLA and torch sum in other orders).
    Input substitution shows the logic equal: the port's spectral tail on
    the JAX package's own residual spectra gives JAX's sfi, mant and
    spec_tab exactly; and every end-to-end difference is a mantissa off by
    one whose pre-round value lies within 1e-4 of a half-integer, with
    every other plane equal."""
    pcm = random_pcm(seed)
    ref = jenc.encode_track(pcm, use_gha=True)
    sfi, mant, spec_tab, _ = encoder._spectral_planes(
        t(_residual_spectra(pcm, jax_side=True)))
    for name, got in (("sfi", sfi), ("mant", mant), ("spec_tab", spec_tab)):
        assert_equal(ref[name], got, name)

    got = encoder.encode_track(pcm, use_gha=True, device="cpu")
    _assert_planes({k: v for k, v in ref.items() if k != "mant"},
                   {k: v for k, v in got.items() if k != "mant"})
    k = encoder._consts(torch.device("cpu"))
    blocks = encoder.gather_qu_blocks(_residual_spectra(pcm, jax_side=False))
    pre = (scale.scale_blocks(blocks, k["mask"], k["scale"])[1]
           * k["inv_mant"]).numpy()
    diff = ref["mant"] != got["mant"]
    assert diff.sum() <= 1
    assert (np.abs(ref["mant"] - got["mant"])[diff] == 1).all()
    assert (np.abs(np.abs(pre[diff]) % 1.0 - 0.5) < 1e-4).all()


@pytest.mark.parametrize("channels", [2, 1], ids=["stereo", "mono"])
def test_encode_frames_bytes_matches_jax(channels):
    """Equal to the JAX fused path, to the port's host tail + device packer
    and to frame.pack; and a stream axis of 2 equals each stream alone."""
    pcm = tonal_pcm(channels=channels)
    ref = np.asarray(jenc.encode_frames_bytes(jnp.asarray(pcm), channels,
                                              gha_mask=7))
    got = encoder.encode_frames_bytes(t(pcm), channels)
    assert_equal(ref, got, "encode_frames_bytes")
    planes = encoder.encode_track(pcm, device="cpu")
    assert_equal(frame.pack(planes, channels), got, "frame.pack")
    assert_equal(_device_bytes(planes, channels), got, "pack_device")
    two = np.stack([pcm, tonal_pcm(channels=channels, seed=9)])
    both = encoder.encode_frames_bytes(t(two), channels)
    assert both.shape == (2,) + tuple(got.shape)
    assert_equal(got, both[0], "stream 0")
    assert_equal(encoder.encode_frames_bytes(t(two[1]), channels), both[1],
                 "stream 1")


def test_byte_identity_vs_reference_writer():
    """tests/test_at3p_codec.py's golden case: GHA off, every byte of the
    reference writer's frames, and the loud corpus shrinks numQU."""
    data = np.load(os.path.join(GOLDEN, "at3p_golden.npz"))
    for pcm_key, ref_key in (("pcm_mixed", "ref_mixed"),
                             ("pcm_loud", "ref_loud")):
        planes = encoder.encode_track(data[pcm_key], use_gha=False,
                                      device="cpu")
        ours, ref = frame.pack(planes, 2), data[ref_key]
        n = min(len(ours), len(ref))
        assert n == 8 and (ours[:n] == ref[:n]).all(), pcm_key
        if pcm_key == "pcm_loud":
            assert (planes["num_qu"] < 32).any()


def _chunk_pcm(frames, seed=5):
    """tests/test_at3p_chunked.py's corpus: two tones, noise, a burst."""
    n = np.arange(T.NUM_SAMPLES * frames)
    rng = np.random.default_rng(seed)
    sig = (0.35 * np.sin(2 * np.pi * 997 * n / 44100)
           + 0.15 * np.sin(2 * np.pi * 3163 * n / 44100)
           + 0.02 * rng.standard_normal(n.size))
    sig[n.size // 3: n.size // 3 + 400] += 0.3 * rng.standard_normal(400)
    return np.stack([sig, 0.8 * sig]).astype(np.float32)


@pytest.mark.parametrize("channels,use_gha", [(2, True), (2, False), (1, 15)],
                         ids=["gha", "off", "mono_wideband"])
def test_chunked_equals_whole_track(channels, use_gha):
    """Bytes equal, and every plane that reaches them: the spectral planes,
    and the tone waves where valid.  (A tone slot that is not valid is
    never written; in the JAX package output frame 0's tone planes are the
    whole track's zero padding but a silent context frame's analysis in a
    chunk.  Here both are chunks of one call, which zeroes output frame 0's
    tone planes in a track's first chunk, so every tone plane is equal.)"""
    pcm = _chunk_pcm(6)[:channels]
    whole = encoder.encode_track(pcm, use_gha=use_gha, chunk_frames=0,
                                 device="cpu")
    chunked = encoder.encode_track(pcm, use_gha=use_gha, chunk_frames=2,
                                   device="cpu")
    assert_equal(_device_bytes(whole, channels),
                 _device_bytes(chunked, channels), "bytes")
    _assert_planes({k: v for k, v in whole.items() if k != "tones"},
                   {k: v for k, v in chunked.items() if k != "tones"})
    if use_gha:
        w, c = whole["tones"], chunked["tones"]
        assert_equal(w["valid"], c["valid"], "valid")
        assert w["valid"].any()
        for k in ("freq", "amp_sf", "phase"):
            assert_equal(np.where(w["valid"], w[k], 0),
                         np.where(c["valid"], c[k], 0), k)
        _assert_planes(w, c)


@pytest.fixture(scope="module")
def closed_loop():
    rng = np.random.default_rng(0)
    n = np.arange(2048 * 6)
    pcm = np.stack([
        0.5 * np.sin(2 * np.pi * 997 * n / 44100)
        + 0.02 * rng.standard_normal(n.size),
        0.4 * np.sin(2 * np.pi * 1503 * n / 44100)]).astype(np.float32)
    dec = {}
    for gha in (False, True):
        frames = frame.pack(encoder.encode_track(pcm, use_gha=gha,
                                                 device="cpu"), 2)
        dec[gha] = (frames, decoder.decode_track(frames, 2, device="cpu"))
    return pcm, dec


def _psnr(pcm, y):
    d = 2 * T.NUM_SAMPLES       # look-ahead + OLA latency (PQF compensated)
    m = pcm.shape[1] - d - 2048
    x = pcm[:, :m].astype(np.float64)
    e = x - y[:, d:d + m].astype(np.float64)
    return 10 * np.log10((x ** 2).mean() / (e ** 2).mean())


def test_closed_loop_quality(closed_loop):
    """tests/test_at3p_codec.py: the fixed wordlen-7 ladder bounds the SNR
    near 28 dB; the port must pass 25 dB."""
    pcm, dec = closed_loop
    assert _psnr(pcm, dec[False][1]) > 25.0


def test_gha_tonal_model_improves_quality(closed_loop):
    """Tones survive the wire, and GHA beats the plain transform by 3 dB."""
    pcm, dec = closed_loop
    p = frame.unpack_frame(dec[True][0][3], 2)
    assert p["tones"] is not None and p["tones"]["valid"].any()
    assert _psnr(pcm, dec[True][1]) > _psnr(pcm, dec[False][1]) + 3.0


def test_encoder_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError):
        encoder.encode_track(tonal_pcm(frames=1))
    with pytest.raises(RuntimeError):
        decoder.decode_track(np.zeros((1, 2048), np.uint8), 2)
