"""The port's bitonic network (atracdenc_tpu_torch/ops/sort.py) against the
JAX package's (atracdenc_tpu/ops/sort.py) on an [8, 128] key with payloads:
keys and payloads equal, ties included, and the unsort restores them."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atracdenc_tpu.ops import sort as jsort
from atracdenc_tpu_torch.ops import sort
from atracdenc_tpu_torch.testing import assert_equal, cpu_setup, t

cpu_setup()


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_bitonic_sort_matches_jax(ties):
    rng = np.random.default_rng(3)
    key = rng.standard_normal((8, 128)).astype(np.float32)
    if ties:
        key = np.round(key * 2) / 2             # few distinct values
    order = np.broadcast_to(np.arange(128, dtype=np.int32), key.shape).copy()
    vals = rng.integers(-1000, 1000, key.shape).astype(np.int32)
    jk, jp = jsort.bitonic_sort(jnp.asarray(key),
                                (jnp.asarray(order), jnp.asarray(vals)))
    k, p = sort.bitonic_sort(t(key), (t(order), t(vals)))
    assert_equal(np.asarray(jk), k, "key")
    for name, a, b in zip(("order", "payload"), jp, p):
        assert_equal(np.asarray(a), b, name)
    assert_equal(np.sort(key, axis=-1), k, "sorted")
    # the iota payload inverts the permutation, in both packages
    back = sort.bitonic_unsort(p[0], [k, p[1]])
    jback = jsort.bitonic_unsort(jp[0], [jk, jp[1]])
    assert_equal(key, back[0], "unsorted key")
    assert_equal(vals, back[1], "unsorted payload")
    assert_equal(np.asarray(jback[1]), back[1], "unsort vs JAX")


def test_bitonic_sort_needs_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        sort.bitonic_sort(torch.zeros(3, 96))
