"""Spectrum <-> padded-BFU-block views (``atracdenc_tpu/models/atrac3/
specblocks.py``).  The 32 BFUs tile the 1024 lines with contiguous ranges,
so both directions are static index maps."""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch.shared import tables as T

_FLAT_IDX = np.concatenate([b * 128 + np.arange(int(T.SPECS_PER_BLOCK[b]))
                            for b in range(32)])


@functools.lru_cache(maxsize=None)
def _consts(dev):
    return {"idx": torch.as_tensor(T.GATHER_IDX.astype(np.int64), device=dev),
            "mask": torch.as_tensor(T.GATHER_MASK, device=dev),
            "flat": torch.as_tensor(_FLAT_IDX, device=dev)}


def to_blocks(specs):
    """[..., 1024] -> [..., 32, 128] (zero-padded per BFU)."""
    c = _consts(specs.device)
    g = specs[..., c["idx"]]
    return torch.where(c["mask"], g, 0.0)


def from_blocks(blocks):
    """[..., 32, 128] -> [..., 1024] (inverse of to_blocks)."""
    flat = blocks.reshape(blocks.shape[:-2] + (32 * 128,))
    return flat[..., _consts(blocks.device)["flat"]]
