"""The port's copies of the JAX package's numpy-only host modules against
the originals on the same inputs: table arrays equal; the ATRAC3+ format
data byte-identical; the ATRAC3, ATRAC1 and ATRAC3+ frame packers, the bit packer (native and numpy forms), the
containers and the audio writers byte-identical; the ATRAC1 exact encoder
and decoder and the ATRAC3 exact encoder equal; the operator messages the
same text.  The copies that name their package (the ATRAC3 exact encoder's
imports, the tools' imports and usage line) equal the originals' bytes
once the port's package name reads as the original's."""
import contextlib
import io
import os

import numpy as np
import pytest

from atracdenc_tpu.containers import aea as jaea, at3 as jat3, oma as joma
from atracdenc_tpu.containers import raw as jraw, rm as jrm
from atracdenc_tpu.io import audio as jaudio, wav as jwav
from atracdenc_tpu.models.atrac1 import exact_enc as jexact_enc
from atracdenc_tpu.models.atrac1 import exact_synth as jexact_synth
from atracdenc_tpu.models.atrac1 import frame as jframe1, tables as jtables1
from atracdenc_tpu.models.atrac3 import exact_enc as jexact_enc3
from atracdenc_tpu.models.atrac3 import frame as jframe3, tables as jtables3
from atracdenc_tpu.models.atrac3p import frame as jframe3p, tables as jtables3p
from atracdenc_tpu.utils import bitpack as jbitpack
from atracdenc_tpu.utils import operator_log as jlog, progress as jprogress
from atracdenc_tpu_torch.containers import aea, at3, oma, raw, rm
from atracdenc_tpu_torch.io import audio, wav
from atracdenc_tpu_torch.models.atrac1 import exact_enc, exact_synth
from atracdenc_tpu_torch.models.atrac1 import frame as frame1, tables as tables1
from atracdenc_tpu_torch.models.atrac3 import exact_enc as exact_enc3
from atracdenc_tpu_torch.models.atrac3 import frame as frame3, tables as tables3
from atracdenc_tpu_torch.models.atrac3p import frame as frame3p
from atracdenc_tpu_torch.models.atrac3p import tables as tables3p
from atracdenc_tpu_torch.models.atrac3.encoder import encode_track
from atracdenc_tpu_torch.testing import cpu_setup
from atracdenc_tpu_torch.utils import bitpack, native, operator_log, progress

cpu_setup()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def _same(a, b, name):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), name
        for k in a:
            _same(a[k], b[k], f"{name}.{k}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), name
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{name}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), name
    else:
        assert a == b, name


@pytest.mark.parametrize("port,ref", [(tables3, jtables3), (tables1, jtables1),
                                      (tables3p, jtables3p)],
                         ids=["atrac3", "atrac1", "atrac3plus"])
def test_tables_equal(port, ref):
    names = [k for k, v in vars(ref).items() if not k.startswith("_")
             and isinstance(v, (np.ndarray, int, float, tuple))]
    assert len(names) > 10
    for k in names:
        _same(getattr(ref, k), getattr(port, k), k)
    if ref is jtables3:
        _same(ref.ath_per_bfu(), port.ath_per_bfu(), "ath_per_bfu")


@pytest.mark.parametrize("js", [False, True])
def test_atrac3_frame_pack_unpack(js):
    """Planes of the port's encoder (default mode: gain points and tonal
    groups) packed by both; reference frames unpacked by both."""
    g = np.load(os.path.join(GOLDEN, "at3_js_golden.npz" if js
                             else "at3_default_golden.npz"))
    fb = 192 if js else 384
    planes = encode_track(g["pcm_in"][:, :8 * 1024], frame_bytes=fb, js=js,
                          no_gain_control=False, no_tonal=False, device="cpu")
    packed = frame3.pack(planes, fb, js=js)
    assert np.array_equal(packed, jframe3.pack(planes, fb, js=js))
    _same(jframe3.unpack(g["ref_frames"], 2, js=js),
          frame3.unpack(g["ref_frames"], 2, js=js), "unpack")


@pytest.mark.parametrize("channels", [2, 1])
def test_atrac3plus_frame_pack_unpack(channels):
    """Planes with tones (sharing and envelopes) packed by both, and the
    frames unpacked by both; the tonal-block field walk and the frequency
    pack of both on every frame."""
    from atracdenc_tpu_torch.models.atrac3p.encoder import (_num_tone_bands,
                                                            encode_track)
    n = np.arange(2048 * 4)
    x = 0.5 * np.sin(2 * np.pi * 689.0625 * n / 44100)
    x[: n.size // 2] *= 0.05
    pcm = np.stack([x, 0.8 * x])[:channels].astype(np.float32)
    planes = encode_track(pcm, device="cpu")
    packed = frame3p.pack(planes, channels)
    assert np.array_equal(packed, jframe3p.pack(planes, channels))
    tones = planes["tones"]
    assert tones["valid"].any()
    for fi in range(packed.shape[0]):
        _same(jframe3p.unpack_frame(packed[fi], channels),
              frame3p.unpack_frame(packed[fi], channels), f"unpack {fi}")
        nb = int(_num_tone_bands(tones)[fi])
        if not nb:
            continue
        assert frame3p.tonal_block_fields(tones, fi, channels, nb) == \
            jframe3p.tonal_block_fields(tones, fi, channels, nb)
        for freq, valid in zip(tones["freq"][:, fi].reshape(-1, 8),
                               tones["valid"][:, fi].reshape(-1, 8)):
            if valid.any():
                f = [int(v) for v in freq[valid]]
                assert frame3p.create_freq_bit_pack(f) == \
                    jframe3p.create_freq_bit_pack(f)


def test_atrac1_frame_pack_unpack():
    frames, _, _, _ = jaea.read(os.path.join(GOLDEN, "at1_ref.aea"))
    planes = jframe1.unpack(frames)
    _same(planes, frame1.unpack(frames), "unpack")
    planes = {k: v for k, v in planes.items() if k != "valid"}
    assert np.array_equal(frame1.pack(planes), jframe1.pack(planes))


@pytest.mark.parametrize("form", ["native", "numpy"])
def test_bitpack(form, monkeypatch):
    if form == "numpy":        # no compiler: the numpy path, same bytes
        monkeypatch.setattr(native, "load", lambda: None)
    else:
        assert native.load() is not None, "the native packer did not build"
    rng = np.random.default_rng(5)
    widths = rng.integers(0, 17, (40, 60)).astype(np.int32)
    values = jbitpack.mask_sign(rng.integers(-40000, 40000, widths.shape), widths)
    out = bitpack.pack_frames(values, widths, 128)
    assert np.array_equal(out, jbitpack._pack_frames_np(values, widths, 128))
    assert np.array_equal(out, jbitpack.pack_frames(values, widths, 128))
    offsets = np.zeros(widths.shape, np.int64)
    np.cumsum(widths[:, :-1], axis=1, out=offsets[:, 1:])
    got = bitpack.unpack_frames(out, offsets, widths)
    assert np.array_equal(got, jbitpack.unpack_frames(out, offsets, widths))
    assert np.array_equal(got, values)
    assert np.array_equal(bitpack.make_sign(got, widths),
                          jbitpack.make_sign(got, widths))


def _bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


@pytest.mark.parametrize("fmt", ["at3", "oma", "rm", "raw", "aea"])
def test_containers(fmt, tmp_path):
    p, j = str(tmp_path / f"port.{fmt}"), str(tmp_path / f"jax.{fmt}")
    if fmt == "aea":
        src = os.path.join(GOLDEN, "at1_ref.aea")
        _same(jaea.read(src), aea.read(src), "read")
        frames, ch, _, length = aea.read(src)
        aea.write(p, frames, ch, length)
        jaea.write(j, frames, ch, length)
    elif fmt == "raw":
        src = os.path.join(GOLDEN, "ref_c.raw")
        _same(jraw.read(src, 384), raw.read(src, 384), "read")
        raw.write(p, raw.read(src, 384))
        jraw.write(j, raw.read(src, 384))
    else:
        mod, jmod = {"at3": (at3, jat3), "oma": (oma, joma), "rm": (rm, jrm)}[fmt]
        src = os.path.join(GOLDEN, f"ref_c.{fmt}")
        _same(jmod.read(src), mod.read(src), "read")
        frames, info = mod.read(src)
        if fmt == "at3":
            at3.write_at3(p, frames, info["frame_size"])
            jat3.write_at3(j, frames, info["frame_size"])
        elif fmt == "oma":
            oma.write(p, frames, info["codec"], info["frame_size"])
            joma.write(j, frames, info["codec"], info["frame_size"])
        else:
            rm.write(p, frames, info["frame_size"])
            jrm.write(j, frames, info["frame_size"])
    assert _bytes(p) == _bytes(j)


@pytest.mark.parametrize("ext", ["wav", "au", "aiff"])
def test_audio_write_read(ext, tmp_path):
    pcm = (0.5 * np.sin(np.arange(2 * 3000) / 7.0)).reshape(2, 3000).astype(np.float32)
    p, j = str(tmp_path / f"port.{ext}"), str(tmp_path / f"jax.{ext}")
    audio.write(p, pcm, 44100)
    jaudio.write(j, pcm, 44100)
    assert _bytes(p) == _bytes(j)
    _same(jaudio.read(p), audio.read(p), "read")
    if ext == "wav":
        wav.write(p, pcm, 44100)
        jwav.write(j, pcm, 44100)
        assert _bytes(p) == _bytes(j)
        _same(jwav.read(p), wav.read(p), "wav.read")


def test_atrac1_exact_encoder_and_decoder():
    rng = np.random.default_rng(8)
    n = np.arange(512 * 6)
    pcm = np.stack([0.4 * np.sin(2 * np.pi * 440.0 * n / 44100.0),
                    0.1 * rng.standard_normal(n.size)]).astype(np.float32)
    planes = exact_enc.encode_track_exact(pcm)
    _same(jexact_enc.encode_track_exact(pcm), planes, "encode_track_exact")
    _same(jexact_synth.decode_track_exact(planes),
          exact_synth.decode_track_exact(planes), "decode_track_exact")


def test_operator_messages():
    planes = {"clip_count": np.array([0, 3]), "clip_max": np.array([1.0, 2.5])}
    outs = []
    for mod in (operator_log, jlog):
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            mod.warn_clipping(dict(planes))
        outs.append(err.getvalue())
    assert outs[0] == outs[1] and "3 clipped" in outs[0]
    for mod in (progress, jprogress):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            mod.print_progress(50)
        assert "50% done" in out.getvalue()


@pytest.mark.parametrize("path", ["models/atrac3p/tables.py",
                                  "models/atrac3p/frame.py",
                                  "models/atrac3p/format_data.npz",
                                  "models/atrac3/yaml_log.py",
                                  "models/atrac3/exact_gain.py",
                                  "models/atrac3/exact_enc.py",
                                  "tools/__init__.py", "tools/omainfo.py",
                                  "tools/omacp.py"])
def test_copied_source(path):
    """Byte-equal to the original once ``atracdenc_tpu_torch`` reads
    ``atracdenc_tpu``: only the import lines (and omainfo's usage line)
    differ."""
    port = _bytes(os.path.join(ROOT, "atracdenc_tpu_torch", path))
    ref = _bytes(os.path.join(ROOT, "atracdenc_tpu", path))
    assert port.replace(b"atracdenc_tpu_torch", b"atracdenc_tpu") == ref


@pytest.mark.parametrize("npz,pcm_key,ref_key,frame_bytes,js", [
    ("at3_default_golden.npz", "pcm_in", "ref_frames", 384, False),
    ("at3_js_golden.npz", "pcm_in", "ref_frames", 192, True)],
    ids=["default", "js"])
def test_atrac3_exact_encoder(npz, pcm_key, ref_key, frame_bytes, js):
    """tests/test_at3_exact.py's default and js cases: the port's planes
    equal JAX's, and pack to the reference encoder's frames byte for
    byte."""
    g = np.load(os.path.join(GOLDEN, npz))
    pcm, ref = g[pcm_key], g[ref_key]
    opts = dict(frame_bytes=frame_bytes, no_tonal=False, no_gain=False, js=js)
    planes = exact_enc3.encode_track_exact(pcm, **opts)
    _same(jexact_enc3.encode_track_exact(pcm, **opts), planes,
          "encode_track_exact")
    ours = frame3.pack(planes, frame_bytes, js=js)
    n = min(ours.shape[0], ref.shape[0])
    assert n == 8 and np.array_equal(ours[:n], ref[:n])
