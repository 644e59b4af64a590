"""The port's batch-shape sweeps and perf campaign
(``python -m atracdenc_tpu_torch.{sweep_at3_batch,sweep_at1_batch,perf_campaign}``)
on the CPU at tiny shapes: their rows and last JSON line with the JAX
tools' keys, no fallback without a card, ``torch.cuda.OutOfMemoryError``
recorded as ``"oom"`` (and nothing else caught), ATRAC1's tensor-op rate
route against the JAX encoder's XLA route, and a sweep point's bytes
against the JAX package's batched encode + device packer."""
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from atracdenc_tpu.models.atrac1 import encoder as jenc1
from atracdenc_tpu.models.atrac3.device_pack import pack_device_batch
from atracdenc_tpu.models.atrac3.encoder import encode_frames as jencode3
from atracdenc_tpu_torch import bench, perf_campaign, sweep_at1_batch, \
    sweep_at3_batch
from atracdenc_tpu_torch.models.atrac1 import encoder as enc1
from atracdenc_tpu_torch.testing import (assert_equal, cpu_setup,
                                         roll_jax_scans, t)

cpu_setup()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"sweep_at3_batch": sweep_at3_batch,
         "sweep_at1_batch": sweep_at1_batch,
         "perf_campaign": perf_campaign}
TINY = {"sweep_at3_batch": ["--grid", "1x4,2x4"],
        "sweep_at1_batch": ["--grid", "1x4,2x4"],
        "perf_campaign": ["--seconds", "0.2", "--streams", "1,2"]}
ROW_KEYS = {"status", "spread", "vs_ref", "peak_gib", "mem_share",
            "sha256"}


@pytest.fixture(scope="module")
def rolled():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()


def run(tool, *extra):
    """``main`` of ``tool`` on the CPU at its tiny shape, one window of one
    call a point: (returned line, printed lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        line = TOOLS[tool].main(["--device", "cpu", "--repeats", "1",
                                 "--iters", "1", *TINY[tool], *extra])
    return line, out.getvalue().strip().splitlines()


@pytest.mark.parametrize("tool", ["sweep_at3_batch", "sweep_at1_batch"])
def test_sweep_prints_rows_and_a_json_line(tool):
    """One line a point, as the JAX tool prints it ("S x F (N frames|units):
    R frames|units/s (X ref)"), then the JSON line: the backend, the route,
    the card (None on the CPU) and every row with its shape, median rate,
    x ref, peak memory and SHA-256."""
    line, printed = run(tool)
    unit = "frames_per_s" if tool == "sweep_at3_batch" else "units_per_s"
    word = unit.split("_")[0]
    assert printed[0].startswith("backend: cpu  pallas=False")
    assert json.loads(printed[-1]) == line
    assert line["tool"] == tool and line["backend"] == "cpu"
    assert line["pallas"] is False
    assert line["name"] is None and line["power.limit"] is None
    assert [(r["streams"], r["frames"]) for r in line["rows"]] == \
        [(1, 4), (2, 4)]
    for text, r in zip(printed[1:-1], line["rows"]):
        assert set(r) == ROW_KEYS | {"streams", "frames", "items", unit}
        assert r["status"] == "ok"
        assert r["spread"][0] <= r[unit] <= r["spread"][1]
        ref = (bench.REF_FRAMES_PER_S if word == "frames"
               else bench.REF_AT1_UNITS_PER_S)
        assert r["vs_ref"] == r[unit] / ref
        assert f" ({r['items']:7d} {word}): " in text
        assert f" {word}/s " in text and "x ref)" in text


def test_campaign_keys_are_the_jax_tools():
    """The report's keys are tools/perf_campaign.py's (``platform``,
    ``device``, ``at3.s{N}_{xla,pallas}`` with ``frames_per_s`` and
    ``vs_ref``, ``at1.{xla,pallas}`` with ``units_per_s`` and ``vs_ref``),
    and both routes' bytes are equal."""
    line, printed = run("perf_campaign")
    assert json.loads(printed[-1]) == line
    assert {"platform", "device", "at3", "at1"} <= set(line)
    assert line["platform"] == "cpu" and line["frames_per_stream"] == 8
    assert set(line["at3"]) == {"s1_xla", "s1_pallas", "s2_xla", "s2_pallas"}
    assert set(line["at1"]) == {"xla", "pallas"}
    for r in line["at3"].values():
        assert {"frames_per_s", "vs_ref"} <= set(r) and r["status"] == "ok"
    for r in line["at1"].values():
        assert {"units_per_s", "vs_ref"} <= set(r) and r["status"] == "ok"
    assert line["at3"]["s2_xla"]["sha256"] == line["at3"]["s2_pallas"]["sha256"]
    assert line["at1"]["xla"]["sha256"] == line["at1"]["pallas"]["sha256"]
    assert sum(p.startswith("at3 s=") for p in printed) == 4


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_refuses_without_cuda(tool):
    """Without a GPU and without --device cpu a tool exits non-zero with
    runtime.device's message and prints no JSON."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would run")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", f"atracdenc_tpu_torch.{tool}",
                          *TINY[tool]], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env=env)
    assert res.returncode != 0
    assert "CUDA requested" in res.stderr
    assert "{" not in res.stdout


def test_out_of_memory_point_is_recorded(monkeypatch):
    """A point whose encode raises ``torch.cuda.OutOfMemoryError`` is
    ``"oom"``; the next point is measured."""
    orig = bench.at3_encode

    def encode(x, **kw):
        if x.shape[0] == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return orig(x, **kw)

    monkeypatch.setattr(bench, "at3_encode", encode)
    line, printed = run("sweep_at3_batch", "--pallas")
    first, second = line["rows"]
    assert first == {"streams": 1, "frames": 4, "items": 4, "status": "oom"}
    assert printed[1].endswith(": oom")
    assert second["status"] == "ok" and second["frames_per_s"] > 0


@pytest.mark.parametrize("tool", ["sweep_at1_batch", "perf_campaign"])
def test_other_errors_propagate(monkeypatch, tool):
    """Only running out of device memory is caught: any other error ends
    the run."""
    def broken(x, **kw):
        raise RuntimeError("not a memory error")
    monkeypatch.setattr(bench, "at1_encode", broken)
    monkeypatch.setattr(bench, "at3_encode", broken)
    with pytest.raises(RuntimeError, match="not a memory error"):
        run(tool)


def test_at1_tensor_op_route_equals_jax_xla(rolled):
    """``encode_frames(..., use_rate_kernel=False)`` (``bitalloc.allocate``
    as tensor ops) gives the JAX ``encode_frames(..., use_pallas=False)``
    planes at 2 channels x 8 sound units, and the default route's."""
    pcm = bench.corpus(1, 4)[0]                    # [2, 4096] = 8 units
    theirs = jenc1.encode_frames(pcm, use_pallas=False)
    ours = enc1.encode_frames(t(pcm), use_rate_kernel=False)
    default = enc1.encode_frames(t(pcm))
    for k in ("short_mask", "bfu_idx", "wordlen", "sfi", "mant", "clip_count"):
        assert_equal(theirs[k], ours[k], k)
        assert_equal(default[k], ours[k], f"{k} (default route)")


def test_sweep_point_bytes_equal_jax(rolled):
    """The SHA-256 of a sweep point (2 streams x 4 stereo frames, tensor-op
    route) equals that of the JAX package's
    ``pack_device_batch(vmap(encode_frames))`` on the same
    ``bench.corpus``, as tools/sweep_at3_batch.py encodes it."""
    line, _ = run("sweep_at3_batch")
    point = line["rows"][1]
    assert (point["streams"], point["frames"]) == (2, 4)
    batched = jax.jit(lambda xs: pack_device_batch(
        jax.vmap(lambda p: jencode3(
            p, frame_bytes=384, js=False, no_gain_control=False,
            no_tonal=False, use_pallas_rate=False))(xs), 384, False))
    theirs = np.asarray(batched(bench.corpus(2, 4)))
    assert theirs.shape == (2, 4, 384)
    assert point["sha256"] == hashlib.sha256(theirs.tobytes()).hexdigest()
