"""The comparison's arithmetic."""
import numpy as np
import pytest
import torch

from portbench.reference import compare


def spectra(rows):
    if (rows[:, 0] == 255).any():
        raise ValueError("does not parse")
    return rows.astype(np.float32)[:, None, :]


def test_equal_rows():
    t = compare.Tally()
    x = torch.randint(0, 200, (10, 8), dtype=torch.uint8)
    t.add(x, x.clone())
    assert t.numbers(spectra) == {"frames_differ": 0.0,
                                  "worst_frame_err": 0.0,
                                  "mean_frame_err": 0.0}


def test_one_row_differs():
    t = compare.Tally()
    x = torch.full((4, 8), 10, dtype=torch.uint8)
    y = x.clone()
    y[2, 3] = 11
    t.add(y, x)
    n = t.numbers(spectra)
    assert n["frames_differ"] == 0.25
    e = 1.0 / (8 * 100 + compare.EPS)
    assert np.isclose(n["worst_frame_err"], e)
    assert np.isclose(n["mean_frame_err"], e / 4)


def test_repeated_pairs_count_each_time():
    """A pair delivered in two generations is dequantised once and
    counted twice."""
    t = compare.Tally()
    x = torch.full((2, 8), 10, dtype=torch.uint8)
    y = x.clone()
    y[0, 3] = 11
    t.add(y, x)
    t.add(y, x)
    assert len(t.pairs) == 1
    n = t.numbers(spectra)
    assert n["frames_differ"] == 0.5
    assert np.isclose(n["mean_frame_err"], 1.0 / (8 * 100 + compare.EPS) / 2)


def test_unparseable_and_lost():
    t = compare.Tally()
    x = torch.full((4, 8), 10, dtype=torch.uint8)
    y = x.clone()
    y[0, 0] = 255
    y[1, 1] = 11
    t.add(y, x)
    n = t.numbers(spectra)
    assert n["worst_frame_err"] == compare.BROKEN
    assert n["mean_frame_err"] == pytest.approx(
        (compare.BROKEN + 1.0 / (800 + compare.EPS)) / 4)
    t2 = compare.Tally()
    t2.lost(5)
    assert t2.numbers(spectra) == {"frames_differ": 1.0,
                                   "worst_frame_err": compare.BROKEN,
                                   "mean_frame_err": compare.BROKEN}
    assert t2.lost_units == 1
