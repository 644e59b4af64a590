"""The control on the card, at the cells' own sizes with a short window:
the program with TF32 on comes out not correct, and the same run with
TF32 off comes out correct (``python3 -m portbench.control`` reads more
seeds)."""
import time

import pytest

from portbench import control, manifest, run


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["atrac3-lp2.batch", "atrac1-sp.batch"])
def test_tf32_control_is_not_correct(name, cuda_device, tmp_path):
    cell = manifest.cell(name)
    r = run.run_cell(cell, 2 ** 31 + 5, 6.0, 0, cuda_device,
                     time.perf_counter(), str(tmp_path), alter=control.alter)
    assert not r["correct"], r["numbers"]
    sound = run.run_cell(cell, 2 ** 31 + 5, 6.0, 0, cuda_device,
                         time.perf_counter(), str(tmp_path))
    assert sound["correct"], sound["numbers"]
