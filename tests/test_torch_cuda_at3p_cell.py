"""The ``atrac3plus.batch`` cell on the card at its own size (64 tracks,
512-frame chunks, 520 checked frames) with a short window, through the
benchmark's own run: a sound run comes out correct, and the carry returned
unchanged and the program with TF32 on (the control) come out not correct.

Needs a GPU, so every test is marked ``cuda`` and skips elsewhere.  The
machine with the card has no JAX, and tests/conftest.py imports it, so run
this file there without the conftest; ``-s`` prints each run's numbers:

    python -m pytest --noconftest -m cuda -s tests/test_torch_cuda_at3p_cell.py
"""
import contextlib
import json
import time

import pytest
import torch

from portbench import control, manifest, run

pytestmark = pytest.mark.cuda

CELL = "atrac3plus.batch"
SEED = 2 ** 31 + 1234567


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
                          ("carry_unchanged", carry_unchanged, False),
                          ("tf32", control.alter, False)],
                         ids=["sound", "carry_unchanged", "tf32"])
def test_cell_run(case, alter, correct, cuda_device, tmp_path):
    r = run.run_cell(manifest.cell(CELL), SEED, 6.0, 0, cuda_device,
                     time.perf_counter(), str(tmp_path), alter=alter)
    print(json.dumps({"case": case, "seed": SEED, "correct": r["correct"],
                      "numbers": r["numbers"]}), flush=True)
    assert r["correct"] is correct, r["numbers"]
