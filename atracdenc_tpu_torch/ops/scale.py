"""Block-floating scaler: per-BFU scale-factor search.

Port of ``atracdenc_tpu/ops/scale.py::scale_blocks`` (reference
src/atrac/atrac_scale.cpp:134-188): the scale-factor index is a lower_bound
over the 64-entry float32 scale table, written as a comparison count.
"""
import torch

__all__ = ["scale_blocks"]


def scale_blocks(values, valid_mask, scale_table):
    """values [..., n_bfu, maxlen], valid_mask [n_bfu, maxlen] bool,
    scale_table [64] f32 ascending.

    Returns (sfi [..., n_bfu] int32, scaled [..., n_bfu, maxlen], energy
    [..., n_bfu]).  Scaled values are clipped to +/-0.99999 like the
    reference; max|spec| is clamped to 1.0."""
    mask = valid_mask.to(values.dtype)
    absx = torch.abs(values) * mask
    maxabs = torch.clamp(torch.amax(absx, dim=-1), max=1.0)
    sfi = torch.sum(scale_table[:-1] < maxabs[..., None], dim=-1,
                    dtype=torch.int32)
    sf = scale_table[sfi.long()]
    scaled = values / sf[..., None]
    clipped = torch.clamp(scaled, -0.99999, 0.99999)
    scaled = torch.where(torch.abs(scaled) >= 1.0, clipped, scaled)
    energy = torch.sum(values * values * mask, dim=-1)
    return sfi, scaled * mask, energy
