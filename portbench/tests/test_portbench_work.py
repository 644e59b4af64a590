"""The yardstick counts a stage's work from its inputs and outputs, so the
same stage gets the same work on every route."""
import numpy as np
import torch

from atracdenc_tpu_torch.models.atrac1 import bitalloc as at1_bitalloc
from atracdenc_tpu_torch.models.atrac3 import bitalloc as at3_bitalloc
from atracdenc_tpu_torch.models.atrac3 import tables as T3
from atracdenc_tpu_torch.ops.at1_alloc import at1_allocate_block
from portbench import work


def test_memo_work_equal_for_fused_memo():
    g = torch.Generator().manual_seed(0)
    scaled = torch.rand((2, 3, 32, 128), generator=g) * 2 - 1
    mask = torch.as_tensor(T3.GATHER_MASK)
    out = {}
    for fused in (False, True):
        res = at3_bitalloc.quant_tensors(scaled, mask, fused)
        out[fused] = work.quant_memo((scaled, mask, fused), {}, res)
    assert out[False] == out[True]
    ops, nbytes = out[False]
    assert ops == 6 * 1024 * work.MEMO_WORDLENS * work.MEMO_OPS_PER_VALUE
    assert nbytes == 6 * 32 * 128 * 4 + 32 * 128 + 2 * 6 * 32 * 8 * 4


def test_at1_alloc_work_equal_on_both_routes():
    g = torch.Generator().manual_seed(1)
    sfi = torch.randint(0, 64, (2, 2, 3, 52), generator=g, dtype=torch.int32)
    energy = torch.rand((2, 2, 3, 52), generator=g)
    flags = torch.zeros((2, 2, 3, 3), dtype=torch.bool)
    loud = torch.ones((2, 1, 3)).expand(2, 2, 3)
    args = (sfi, energy, flags, loud)
    a = work.at1_alloc(args, {}, at1_allocate_block(*args))
    b = work.at1_alloc(args, {}, at1_bitalloc.allocate(*args))
    assert a == b
    assert a[0] == 12 * 52 * work.AT1_OPS_PER_BFU


def test_broadcast_view_counts_its_storage():
    base = torch.ones((4, 1, 8))
    assert work.tensor_bytes(base.expand(4, 16, 8)) == base.numel() * 4


def test_least_seconds():
    assert work.least_seconds(1, 1, "no such card") is None
    s = work.least_seconds(67e12, 0, "NVIDIA H100 80GB HBM3")
    assert np.isclose(s, 1.0)
    s = work.least_seconds(0, 3.35e12, "NVIDIA H100 80GB HBM3")
    assert np.isclose(s, 1.0)
