"""The port's scaling harness (``python -m atracdenc_tpu_torch.scaling_bench``)
on the CPU: ``make_pcm`` against ``tools/scaling_bench.py``'s, 1, 2 and 4
gloo rank processes at the JAX tool's 8 streams x 8 stereo frames with
byte-equal rows, the 1-rank bytes against ``encode_frames_bytes``, ``--dp``
with an sp chain, and no fallback without a card."""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import scaling_bench
from atracdenc_tpu_torch.models.atrac3 import encoder
from atracdenc_tpu_torch.testing import cpu_setup

cpu_setup()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def printed():
    """main() on the CPU: what it printed, and its JSON last line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert scaling_bench.main(["--device", "cpu"]) == 0
    lines = out.getvalue().strip().splitlines()
    return lines, json.loads(lines[-1])


def test_make_pcm_is_the_jax_tools():
    spec = importlib.util.spec_from_file_location(
        "jax_scaling_tool", os.path.join(ROOT, "tools", "scaling_bench.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)          # imports JAX only in its worker
    want = tool.make_pcm(tool.STREAMS, tool.FRAMES)
    got = scaling_bench.make_pcm(*scaling_bench.SHAPES["cpu"])
    assert got.dtype == np.float32 and got.shape == (8, 2, 8192)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("ranks", scaling_bench.RANKS)
def test_rows_byte_equal_to_one_rank(printed, ranks):
    """Each configuration is all dp by default; its rows, concatenated,
    equal the 1-rank bytes (run() asserts it; the row records it)."""
    _, line = printed
    row, = [r for r in line["rows"] if r["ranks"] == ranks]
    assert (row["dp"], row["sp"]) == (ranks, 1)
    assert row["identity"] == 1.0 and row["differing"] == []
    assert row["frames_per_s"] > 0
    assert row["kept"] == row["frames_per_s"] / line["rows"][0]["frames_per_s"]


def test_table(printed):
    lines, line = printed
    head = lines.index(f"{'config':22s} {'ranks':>5s} {'frames/s':>12s}   "
                       f"throughput kept")
    assert len(lines) == head + 1 + len(scaling_bench.RANKS) + 1
    assert lines[head + 1].endswith("100.0%")
    assert any("device cpu; torch.cuda.device_count() = 0" in ln
               for ln in lines)
    assert not any("time-slice" in ln for ln in lines)


def test_one_rank_and_sp_chain_bytes(tmp_path):
    """1 rank gives ``encode_frames_bytes`` of the whole batch (default
    mode, LP2); --dp 2 on 4 ranks (2 dp x 2 sp, the carry chain) the same
    bytes."""
    streams, frames = scaling_bench.SHAPES["cpu"]
    pcm = scaling_bench.make_pcm(streams, frames)
    want = encoder.encode_frames_bytes(torch.from_numpy(pcm),
                                       no_gain_control=False,
                                       no_tonal=False).numpy()
    _, mesh, one = scaling_bench.run_config(1, "cpu", None, str(tmp_path / "1"))
    assert mesh == (1, 1) and one.shape == (streams, frames, 384)
    assert np.array_equal(one, want)
    _, mesh, chain = scaling_bench.run_config(4, "cpu", 2, str(tmp_path / "4"))
    assert mesh == (2, 2)
    assert np.array_equal(chain, want)


def test_dp_rows():
    assert [scaling_bench.rank_dp(r, None) for r in (1, 2, 4)] == [1, 2, 4]
    assert [scaling_bench.rank_dp(r, 2) for r in (1, 2, 4)] == [1, 2, 2]
    with pytest.raises(ValueError, match="do not divide"):
        scaling_bench.rank_dp(4, 3)
    with pytest.raises(SystemExit):
        scaling_bench.main(["--device", "cpu", "--dp", "0"])
    with pytest.raises(SystemExit):                 # no shape options
        scaling_bench.main(["--device", "cpu", "--streams", "2"])


def test_refuses_without_cuda():
    """Without a GPU and without --device cpu the harness exits non-zero
    with runtime.device's message, starts no rank and prints no line."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the harness would run")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m",
                          "atracdenc_tpu_torch.scaling_bench"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env=env)
    assert res.returncode != 0
    assert "CUDA requested" in res.stderr
    assert "{" not in res.stdout
