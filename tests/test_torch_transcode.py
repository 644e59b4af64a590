"""The port's batch transcoder (atracdenc_tpu_torch/tools/transcode.py)
against the JAX package's (atracdenc_tpu/tools/transcode.py) on the CPU:
the same files byte for byte for ATRAC1, ATRAC3 and ATRAC3+; the resume and
atomic-output contract that tests/test_tools.py pins for the JAX tool; and
--hosts 2 as two processes, each writing its round-robin share once."""
import os
import sys

import jax
import numpy as np
import pytest

from atracdenc_tpu.tools import transcode as jax_transcode
from atracdenc_tpu_torch.io import wav
from atracdenc_tpu_torch.parallel import distributed as D
from atracdenc_tpu_torch.testing import cpu_setup, roll_jax_scans
from atracdenc_tpu_torch.tools import transcode

cpu_setup()
EXT = {"atrac1": ".aea", "atrac3": ".oma", "atrac3plus": ".oma"}


@pytest.fixture(autouse=True, scope="module")
def _rolled_jax_scans():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()                   # no rolled trace outlives the file


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Three short stereo WAVs (8 ATRAC3 frames, 4 ATRAC3+, 16 ATRAC1 sound
    units a channel); the third has a partial last frame."""
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(11)
    paths = []
    for i, (f0, n) in enumerate(((997, 8192), (440, 8192), (1503, 7000))):
        k = np.arange(n)
        sig = 0.4 * np.sin(2 * np.pi * f0 * k / 44100)
        pcm = np.clip(np.stack([sig, 0.7 * sig])
                      + 0.03 * rng.standard_normal((2, n)), -1, 1)
        path = d / f"track{i}.wav"
        wav.write(str(path), pcm.astype(np.float32), 44100)
        paths.append(str(path))
    return paths


def _files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("codec", sorted(EXT))
def test_files_equal_the_jax_transcoder(codec, corpus, tmp_path, capsys):
    """One short WAV through both transcoders: the same container bytes,
    and the same "->" and closing lines (but the time)."""
    src = corpus[:1]
    assert jax_transcode.main(src + ["--codec", codec, "--out-dir",
                                     str(tmp_path / "jax")]) == 0
    theirs = capsys.readouterr().out.splitlines()
    assert transcode.main(src + ["--codec", codec, "--out-dir",
                                 str(tmp_path / "torch"),
                                 "--device", "cpu"]) == 0
    ours = capsys.readouterr().out.splitlines()
    jax_files, our_files = _files(tmp_path / "jax"), _files(tmp_path / "torch")
    assert list(our_files) == ["track0" + EXT[codec]]
    assert our_files == jax_files
    assert ours[0] == theirs[0].replace("/jax/", "/torch/")
    assert ours[1].split(" in ")[0] == theirs[1].split(" in ")[0]
    assert ours[1].endswith("x realtime)")


def test_transcode_resume_and_atomic_output(corpus, tmp_path, capsys):
    """tests/test_tools.py::test_transcode_resume_and_atomic_output on the
    port."""
    src = corpus[0]
    out_dir = tmp_path / "enc"
    transcode.main([src, "--codec", "atrac3", "--out-dir", str(out_dir),
                    "--device", "cpu"])
    final = out_dir / (os.path.splitext(os.path.basename(src))[0] + ".oma")
    assert final.exists() and final.stat().st_size > 96
    first = final.read_bytes()
    # no temp leftovers (atomic rename)
    assert [p for p in os.listdir(out_dir)] == [final.name]
    # --resume skips the existing output
    mtime = final.stat().st_mtime_ns
    transcode.main([src, "--codec", "atrac3", "--out-dir", str(out_dir),
                    "--resume", "--device", "cpu"])
    assert "skip" in capsys.readouterr().out
    assert final.stat().st_mtime_ns == mtime
    assert final.read_bytes() == first


def test_local_devices_rehearses_on_the_cpu(corpus, tmp_path, capsys):
    """--local-devices (the JAX command line) runs on the CPU and writes
    what --device cpu writes; with --device cuda it is an error."""
    for name, extra in (("local", ["--local-devices", "8"]),
                        ("cpu", ["--device", "cpu"])):
        transcode.main(corpus[:1] + ["--codec", "atrac1", "--out-dir",
                                     str(tmp_path / name)] + extra)
    assert _files(tmp_path / "local") == _files(tmp_path / "cpu")
    with pytest.raises(SystemExit) as e:
        transcode.main(corpus[:1] + ["--out-dir", str(tmp_path / "x"),
                                     "--local-devices", "2",
                                     "--device", "cuda"])
    assert e.value.code == 2
    assert "--local-devices" in capsys.readouterr().err


def test_two_hosts_split_the_corpus(corpus, tmp_path):
    """--hosts 2: two processes in one gloo group, each encoding its
    round-robin share once; their union equals the one-process run."""
    args = ["--codec", "atrac1", "--device", "cpu"]
    assert transcode.main(corpus + args + ["--out-dir",
                                           str(tmp_path / "one")]) == 0
    env = dict(os.environ, OMP_NUM_THREADS="1")
    outs = D.launch(lambda r, coord: [
        sys.executable, "-m", "atracdenc_tpu_torch.tools.transcode"] + corpus
        + args + ["--out-dir", str(tmp_path / "two"), "--hosts", "2",
                  "--host-id", str(r), "--coordinator", coord],
        2, timeout=300, env=env)
    for r, out in enumerate(outs):
        written = [line.split(" -> ")[0] for line in out.splitlines()
                   if " -> " in line]
        assert written == corpus[r::2], (r, out)
    assert _files(tmp_path / "two") == _files(tmp_path / "one")
    assert len(_files(tmp_path / "one")) == 3

