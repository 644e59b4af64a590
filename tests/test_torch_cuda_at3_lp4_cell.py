"""The ``atrac3-lp4.batch`` cell on the card at its own size (64 tracks,
512-frame chunks, 520 checked frames) with a short window, through the
benchmark's own run: a sound run comes out correct; the program with TF32
on (the control) and the program whose carry comes back unchanged (frames
512-519 of each sampled track coded from a fresh state) not correct.

Needs a GPU, so every test is marked ``cuda`` and skips elsewhere.  The
machine with the card has no JAX, and tests/conftest.py imports it, so run
this file there without the conftest; ``-s`` prints each run's numbers:

    python -m pytest --noconftest -m cuda -s tests/test_torch_cuda_at3_lp4_cell.py
"""
import contextlib
import json
import time

import pytest
import torch

from portbench import control, manifest, run

pytestmark = pytest.mark.cuda

CELL = "atrac3-lp4.batch"
SEED = 2 ** 31 + 7654321


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def carry_unchanged(ctx):
    """The codec's carry comes back as it went in."""
    orig = ctx.codec.encode_chunk

    def f(pcm, state, nxt):
        rows, _ = orig(pcm, state, nxt)
        return rows, state
    ctx.codec.encode_chunk = f
    return contextlib.nullcontext()


@pytest.mark.parametrize("case,alter,correct",
                         [("sound", None, True),
                          ("tf32", control.alter, False),
                          ("carry_unchanged", carry_unchanged, False)],
                         ids=["sound", "tf32", "carry_unchanged"])
def test_cell_run(case, alter, correct, cuda_device, tmp_path):
    cell = manifest.cell(CELL)
    assert cell.config["check_frames"] > cell.traffic["chunk_frames"]
    r = run.run_cell(cell, SEED, 6.0, 0, cuda_device, time.perf_counter(),
                     str(tmp_path), alter=alter)
    print(json.dumps({"case": case, "seed": SEED, "correct": r["correct"],
                      "numbers": r["numbers"]}), flush=True)
    assert r["correct"] is correct, r["numbers"]
    assert r["failed"] == 0
