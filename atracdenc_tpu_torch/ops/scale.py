"""Block-floating scaler: per-BFU scale-factor search and mantissas.

Port of ``atracdenc_tpu/ops/scale.py`` (reference
src/atrac/atrac_scale.cpp:134-188): the scale-factor index is a lower_bound
over the 64-entry float32 scale table, written as a comparison count.
"""
import torch

from atracdenc_tpu_torch import trace

__all__ = ["scale_blocks", "quant_mantissas"]


@trace.span("scale_blocks")
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


@trace.span("quant_mantissas")
def quant_mantissas(scaled, wordlen):
    """Round-half-even mantissas (lrint under FE_TONEAREST, reference
    src/util.h:98-109, atrac1_bitalloc.cpp:307-317); ``torch.round`` rounds
    half to even like ``jnp.round``.

    scaled [..., n_bfu, maxlen] in (-1, 1), wordlen [..., n_bfu] int 0 /
    2..16 -> int32 mantissas, zero where wordlen < 2."""
    multiple = ((1 << (torch.clamp(wordlen, min=1) - 1)) - 1).to(scaled.dtype)
    mant = torch.round(scaled * multiple[..., None]).to(torch.int32)
    return torch.where((wordlen >= 2)[..., None], mant, 0)
