"""``encode_many`` runs each task in a process of its own and leaves no
process behind, on success and on failure."""
import glob
import operator
import os

import numpy as np
import pytest

from portbench.reference import encode_many


def children():
    """Pids of this process's living children."""
    pids = []
    for path in glob.glob(f"/proc/{os.getpid()}/task/*/children"):
        with open(path) as f:
            pids += f.read().split()
    return pids


@pytest.mark.skipif(not os.path.isdir("/proc/self/task"),
                    reason="reads children from /proc")
def test_answers_in_order_and_nothing_left():
    before = children()
    pcms = [np.full(4, i, np.float32) for i in range(5)]
    out = encode_many(np.add, np.float32(0.5), pcms)
    assert [o.tolist() for o in out] == [[i + 0.5] * 4 for i in range(5)]
    assert children() == before


@pytest.mark.skipif(not os.path.isdir("/proc/self/task"),
                    reason="reads children from /proc")
def test_a_failed_task_raises_and_nothing_left():
    before = children()
    with pytest.raises(RuntimeError, match="exited with code"):
        encode_many(operator.getitem, {}, [np.zeros(2)] * 3)
    assert children() == before
