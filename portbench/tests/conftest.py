"""Shared fixtures: cells cut to sizes a CPU test run can hold."""
import itertools
import time
import types

import pytest
import torch

from portbench import manifest, run
from portbench.drivers import batch

SMALL = dict(streams=4, chunk_frames=4, track_seconds=[0.3, 0.4],
             check_tracks=4, profile_seconds=0.5)
SMALL_CHECK_FRAMES = 10        # past the first chunk: the carry is checked


def small_cell(name):
    cell = manifest.cell(name)
    cell.traffic.update(SMALL)
    cell.config["check_frames"] = SMALL_CHECK_FRAMES
    return cell


def run_small(name, seed, tmp_path, alter=None, seconds=4.0):
    """One run of a cut-down cell on the CPU, past the look for a card.
    The batch driver's window runs on a clock that ticks once a reading,
    so that it spans a few calls however slow the CPU is."""
    clock = itertools.count()
    saved = batch.time
    batch.time = types.SimpleNamespace(perf_counter=lambda: next(clock))
    try:
        return run.run_cell(small_cell(name), seed, seconds, 0,
                            torch.device("cpu"), time.perf_counter(),
                            str(tmp_path), alter=alter)
    finally:
        batch.time = saved


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, not on import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
