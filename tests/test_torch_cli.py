"""The port's CLI against the JAX CLI on the same files.

Where the port once differed: an unexpected exception becomes
``Encode/Decode error: ...`` and a non-zero exit, and ``--bfuidxfast`` is
accepted as a deprecated no-op with the JAX CLI's notice.  ATRAC3: ``-d``
of OMA, RIFF and RealMedia files (joint stereo included) gives WAVs within
1 LSB of 16 bits of the JAX CLI's (measured: equal) and the same header
lines; ``--exact`` writes the same bytes; ``--yaml-log`` writes the same
text, every number equal as printed.  ATRAC3+: ``-e atrac3plus`` writes
the same OMA and RIFF bytes (GHA on, and with ``--advanced
ghadbg=15,ghawbrefine=1``, with the same stderr lines), ``-d`` of both
gives WAVs within 1 LSB (measured: equal), out-of-range ``--advanced``
values exit with the same messages, ``--advanced`` is accepted (and
ignored) by ATRAC3, and a corrupt ATRAC3+ OMA fails with the same
``Encode/Decode error``.  Encoding runs the port's CPU path."""
import os

import jax
import numpy as np
import pytest

from atracdenc_tpu import cli as jax_cli
from atracdenc_tpu.io import audio as jaudio, wav
from atracdenc_tpu_torch import cli as torch_cli
from atracdenc_tpu_torch.containers import oma
from atracdenc_tpu_torch.testing import cpu_setup, roll_jax_scans

cpu_setup()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CLIS = {"jax": jax_cli, "torch": torch_cli}
NOTICE = "--bfuidxfast option is deprecated and will be removed."
LSB = 1.0 / 32768


@pytest.fixture(autouse=True, scope="module")
def _rolled_jax_scans():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()                   # no rolled trace outlives the file


@pytest.fixture(scope="module")
def at3_files(tmp_path_factory):
    """An 8-frame stereo WAV (tone, noise and a loud burst, so that gain
    points and tonal components occur) and the port's ATRAC3 encodes of
    it in each container, and in joint stereo (atrac3_lp4)."""
    d = tmp_path_factory.mktemp("at3cli")
    k = np.arange(1024 * 8)
    rng = np.random.default_rng(21)
    x = 0.3 * np.sin(2 * np.pi * 997 * k / 44100)[None] * [[1.0], [0.7]]
    x = x + 0.02 * rng.standard_normal((2, k.size))
    x[:, 4000:4300] *= 3.0
    src = str(d / "in.wav")
    wav.write(src, np.clip(x, -1, 1).astype(np.float32), 44100)
    files = {}
    for codec, ext in (("atrac3", "oma"), ("atrac3", "at3"), ("atrac3", "rm"),
                       ("atrac3_lp4", "oma")):
        out = str(d / f"{codec}.{ext}")
        torch_cli.main(["-e", codec, "-i", src, "-o", out, "--nostdout",
                        "--device", "cpu"])
        files[f"{codec}.{ext}"] = out
    return src, files


@pytest.mark.parametrize("name", sorted(CLIS))
def test_truncated_aea_exits_with_a_message(tmp_path, name):
    """A whole 2048-byte AEA header and 5 bytes: no complete sound unit, so
    the decoder's reshape fails past the header."""
    with open(os.path.join(GOLDEN, "at1_ref.aea"), "rb") as fp:
        head = fp.read(2048 + 5)
    src = tmp_path / "truncated.aea"
    src.write_bytes(head)
    with pytest.raises(SystemExit) as exc:
        CLIS[name].main(["-d", "-i", str(src), "-o", str(tmp_path / "out.wav"),
                         "--nostdout"])
    assert exc.value.code == ("Encode/Decode error: cannot reshape array of "
                              "size 0 into shape (0,newaxis)")
    assert not (tmp_path / "out.wav").exists()


@pytest.mark.parametrize("name", sorted(CLIS))
def test_bfuidxfast_notice_comes_before_the_mode_check(tmp_path, name, capsys):
    with pytest.raises(SystemExit) as exc:
        CLIS[name].main(["--bfuidxfast", "-i", str(tmp_path / "in.wav"),
                         "-o", str(tmp_path / "out.aea")])
    assert exc.value.code == "Select mode: encode or decode"
    assert capsys.readouterr().out == NOTICE + "\n"


def test_bfuidxfast_encodes_as_without_it(tmp_path, capsys):
    src = str(tmp_path / "in.wav")
    k = np.arange(512 * 6)
    sig = 0.4 * np.sin(2 * np.pi * 997 * k / 44100)
    wav.write(src, np.stack([sig, 0.7 * sig]).astype(np.float32), 44100)
    outs = []
    for extra in ([], ["--bfuidxfast"]):
        out = tmp_path / f"out{len(outs)}.aea"
        torch_cli.main(["-e", "atrac1", "-i", src, "-o", str(out), "--nostdout",
                        "--device", "cpu"] + extra)
        outs.append(out.read_bytes())
    assert capsys.readouterr().out == NOTICE + "\n"
    assert outs[0] == outs[1] and len(outs[0]) == 2048 + 12 * 212


@pytest.mark.parametrize("name", ["atrac3.oma", "atrac3.at3", "atrac3.rm",
                                  "atrac3_lp4.oma"])
def test_atrac3_decode_matches_jax(at3_files, tmp_path, capsys, name):
    _, files = at3_files
    pcm, text = {}, {}
    for cli in sorted(CLIS):
        out = str(tmp_path / f"{cli}.wav")
        args = ["-d", "-i", files[name], "-o", out]
        CLIS[cli].main(args + (["--device", "cpu"] if cli == "torch" else []))
        text[cli] = capsys.readouterr().out
        pcm[cli], rate = jaudio.read(out)
        assert rate == 44100
    assert text["torch"] == text["jax"] and "Codec: atrac3" in text["torch"]
    # the decoder drops its 1162-sample delay, which trimming to the
    # containers' total_samples (RIFF, RM) does not reach
    assert pcm["torch"].shape == pcm["jax"].shape == (2, 1024 * 8 - 1162)
    assert np.abs(pcm["jax"]).max() > 0.1
    assert np.abs(pcm["torch"] - pcm["jax"]).max() <= LSB


@pytest.mark.parametrize("codec", ["atrac3", "atrac3_lp4"])
def test_atrac3_exact_matches_jax(at3_files, tmp_path, codec):
    src, _ = at3_files
    outs = {}
    for cli in sorted(CLIS):
        out = tmp_path / f"{cli}.oma"
        CLIS[cli].main(["-e", codec, "--exact", "-i", src, "-o", str(out),
                        "--nostdout"])
        outs[cli] = out.read_bytes()
    assert len(outs["torch"]) > 8 * 192 and outs["torch"] == outs["jax"]


def test_atrac3_yaml_log_matches_jax(at3_files, tmp_path):
    src, _ = at3_files
    logs = {}
    for cli in sorted(CLIS):
        log = tmp_path / f"{cli}.yaml"
        CLIS[cli].main(["-e", "atrac3", "-i", src, "-o",
                        str(tmp_path / f"{cli}.oma"), "--nostdout",
                        "--yaml-log", str(log)]
                       + (["--device", "cpu"] if cli == "torch" else []))
        logs[cli] = log.read_text()
    assert logs["torch"].count("---\n") == 8
    assert "curve_final:\n          - {level:" in logs["torch"]
    assert logs["torch"].splitlines() == logs["jax"].splitlines()


def test_atrac3_yaml_log_whole_frames_only(at3_files, tmp_path):
    """A track with a partial last frame: one document per whole frame (the
    JAX CLI cannot reshape such a track and exits with an error)."""
    src, _ = at3_files
    pcm, _ = jaudio.read(src)
    part = str(tmp_path / "part.wav")
    wav.write(part, np.concatenate([pcm, pcm[:, :700]], axis=1), 44100)
    log = tmp_path / "part.yaml"
    torch_cli.main(["-e", "atrac3", "-i", part, "-o", str(tmp_path / "p.oma"),
                    "--nostdout", "--device", "cpu", "--yaml-log", str(log)])
    assert log.read_text().count("---\n") == 8


def test_atrac3plus_decode_exits_with_a_message(tmp_path):
    """A corrupt ATRAC3+ OMA (zero frames: no valid start bit) fails in the
    frame parser with the same message from both CLIs, and writes no WAV."""
    src = str(tmp_path / "plus.oma")
    oma.write(src, np.zeros((2, 1488), np.uint8), oma.CODEC_ATRAC3PLUS, 1488)
    for cli in sorted(CLIS):
        with pytest.raises(SystemExit) as exc:
            CLIS[cli].main(["-d", "-i", src, "-o", str(tmp_path / "out.wav"),
                            "--nostdout"]
                           + (["--device", "cpu"] if cli == "torch" else []))
        assert exc.value.code == "Encode/Decode error: AssertionError", cli
        assert not (tmp_path / "out.wav").exists()


def _at3p_wav(path, frames=4):
    n = np.arange(2048 * frames)
    x = (0.5 * np.sin(2 * np.pi * 689.0625 * n / 44100)
         + 0.2 * np.sin(2 * np.pi * 3000.5 * n / 44100))
    x[: n.size // 2] *= 0.05
    x = x + 0.01 * np.random.default_rng(3).standard_normal(n.size)
    wav.write(path, np.clip(np.stack([x, 0.8 * x]), -1, 1).astype(np.float32),
              44100)


@pytest.fixture(scope="module")
def at3p_files(tmp_path_factory):
    """A 4-frame stereo WAV (two tones with an onset) and each CLI's
    ATRAC3+ encodes of it as OMA and RIFF."""
    d = tmp_path_factory.mktemp("at3pcli")
    src = str(d / "in.wav")
    _at3p_wav(src)
    files = {}
    for cli in sorted(CLIS):
        for ext in ("oma", "at3"):
            out = str(d / f"{cli}.{ext}")
            CLIS[cli].main(["-e", "atrac3plus", "-i", src, "-o", out,
                            "--nostdout"]
                           + (["--device", "cpu"] if cli == "torch" else []))
            files[cli, ext] = out
    return src, files


@pytest.mark.parametrize("ext", ["oma", "at3"])
def test_atrac3plus_encode_matches_jax(at3p_files, ext):
    _, files = at3p_files
    with open(files["jax", ext], "rb") as a, open(files["torch", ext], "rb") as b:
        ref, got = a.read(), b.read()
    assert len(got) > 4 * 2048 and got == ref


@pytest.mark.parametrize("ext", ["oma", "at3"])
def test_atrac3plus_decode_matches_jax(at3p_files, tmp_path, capsys, ext):
    _, files = at3p_files
    pcm, text = {}, {}
    for cli in sorted(CLIS):
        out = str(tmp_path / f"{cli}.wav")
        CLIS[cli].main(["-d", "-i", files["torch", ext], "-o", out]
                       + (["--device", "cpu"] if cli == "torch" else []))
        text[cli] = capsys.readouterr().out
        pcm[cli], rate = jaudio.read(out)
        assert rate == 44100
    assert text["torch"] == text["jax"] and "Codec: atrac3plus" in text["torch"]
    assert pcm["torch"].shape == pcm["jax"].shape
    assert np.abs(pcm["jax"]).max() > 0.01
    assert np.abs(pcm["torch"] - pcm["jax"]).max() <= LSB


def test_atrac3plus_advanced_wideband_matches_jax(at3p_files, tmp_path, capsys):
    src, _ = at3p_files
    outs, errs = {}, {}
    for cli in sorted(CLIS):
        out = tmp_path / f"{cli}.oma"
        CLIS[cli].main(["-e", "atrac3plus", "--advanced",
                        "ghadbg=15,ghawbrefine=1", "-i", src, "-o", str(out),
                        "--nostdout"]
                       + (["--device", "cpu"] if cli == "torch" else []))
        outs[cli], errs[cli] = out.read_bytes(), capsys.readouterr().err
    assert outs["torch"] == outs["jax"]
    assert errs["torch"] == errs["jax"] == (
        "GHA_PASS_INPUT\nGHA_WRITE_TONAL\nGHA_WRITE_RESIUDAL\nGHA_WIDEBAND\n"
        "GHA_WIDEBAND_REFINE=raw\n")


@pytest.mark.parametrize("advanced,message", [
    ("ghadbg=16", "invalud value of GHA processing mask"),
    ("ghawbrefine=2", "invalid ghawbrefine value (expected 0=subband or 1=raw)")])
def test_atrac3plus_advanced_out_of_range(at3p_files, tmp_path, capsys,
                                          advanced, message):
    src, _ = at3p_files
    seen = {}
    for cli in sorted(CLIS):
        out = tmp_path / f"{cli}.oma"
        with pytest.raises(SystemExit) as exc:
            CLIS[cli].main(["-e", "atrac3plus", "--advanced", advanced, "-i",
                            src, "-o", str(out)]
                           + (["--device", "cpu"] if cli == "torch" else []))
        seen[cli] = (exc.value.code, capsys.readouterr())
        assert not out.exists()
    assert seen["torch"] == seen["jax"] and seen["torch"][0] == message


def test_advanced_is_ignored_by_atrac3(at3_files, tmp_path):
    """Both CLIs take --advanced with -e atrac3 and write what they write
    without it (JAX: the host --exact path, no compile; the port: its
    default device path too)."""
    src, _ = at3_files
    outs = {}
    for cli, extra in (("jax", ["--exact"]), ("torch", ["--exact"]),
                       ("torch", ["--device", "cpu"])):
        for adv in ([], ["--advanced", "ghadbg=15"]):
            out = tmp_path / f"{cli}{len(outs)}.oma"
            CLIS[cli].main(["-e", "atrac3", "-i", src, "-o", str(out),
                            "--nostdout"] + extra + adv)
            outs[cli, extra[0], bool(adv)] = out.read_bytes()
    for (cli, mode, adv), data in outs.items():
        assert data == outs[cli, mode, False], (cli, mode)
    assert outs["jax", "--exact", True] == outs["torch", "--exact", True]
