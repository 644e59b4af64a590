"""MSB-first bitstream assembly on the device, in integers.

Port of ``atracdenc_tpu/ops/bitdeposit.py::deposit_fields`` (reference
semantics: src/lib/bitstream/bitstream.cpp:40-91).  Field k of frame f
deposits ``widths[f, k]`` bits of ``values[f, k]`` at the absolute bit
offset ``offsets[f, k]``.  A field spans at most two 32-bit words; its
share of each word splits into four byte lanes, and every lane is added
into the frame's byte plane with one integer ``scatter_add_``.  The fields
do not overlap, so the byte sums equal the bitwise OR and stay below 256.
Integer atomics are order-free, so the result is the same on every run.
The JAX form writes the same scatter as a bf16 one-hot einsum; here there
is no float arithmetic at all.
"""
import torch

from atracdenc_tpu_torch import trace

__all__ = ["deposit_fields"]

_U32 = 0xFFFFFFFF


def _byte_lanes(x):
    """[..., K] words (low 32 bits of int64) -> [..., K, 4] bytes, MSB first."""
    return torch.stack([(x >> 24) & 0xFF, (x >> 16) & 0xFF, (x >> 8) & 0xFF,
                        x & 0xFF], dim=-1)


@trace.span("deposit_fields")
def deposit_fields(values, widths, offsets, total_bytes):
    """values / widths / offsets [F, K] (any integer dtype) -> [F,
    total_bytes] uint8 frames.  Values must be pre-masked to their widths
    (a value is taken as its low 32 bits, like the JAX package's uint32),
    fields must not overlap and must be at most 32 bits wide.  Words past
    ``total_bytes`` are dropped, as the JAX one-hot drops them."""
    f, k = values.shape
    n_words = (total_bytes + 3) // 4
    w = widths.to(torch.int64)
    present = w > 0
    val = torch.where(present, values.to(torch.int64) & _U32, 0)
    off = torch.where(present, offsets.to(torch.int64), 0)

    w0 = off >> 5                                   # first word of the field
    shift = 32 - w - (off & 31)
    pos_s = torch.clamp(shift, min=0)
    neg_s = torch.clamp(-shift, min=0)
    hi = torch.where(shift >= 0, val << pos_s, val >> neg_s)
    lo = torch.where(shift < 0, val << (32 - neg_s), 0)

    # one sink word past the frame takes the out-of-range lanes
    lane = torch.arange(4, device=values.device)
    idx_hi = torch.clamp(w0, max=n_words)[..., None] * 4 + lane
    idx_lo = torch.clamp(w0 + 1, max=n_words)[..., None] * 4 + lane
    src = torch.cat([_byte_lanes(hi), _byte_lanes(lo)], dim=-1).to(torch.int32)
    idx = torch.cat([idx_hi, idx_lo], dim=-1)
    out = torch.zeros((f, (n_words + 1) * 4), dtype=torch.int32,
                      device=values.device)
    out.scatter_add_(1, idx.reshape(f, -1), src.reshape(f, -1))
    return out[:, :total_bytes].to(torch.uint8)
