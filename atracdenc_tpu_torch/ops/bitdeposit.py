"""MSB-first bitstream assembly on the device, in integers.

Port of ``atracdenc_tpu/ops/bitdeposit.py::deposit_fields`` (reference
semantics: src/lib/bitstream/bitstream.cpp:40-91).  Field k of frame f
deposits ``widths[f, k]`` bits of ``values[f, k]`` at the absolute bit
offset ``offsets[f, k]``.  A field spans at most two 32-bit words.

Two routes with the same bytes.  A CUDA tensor goes to the kernel
``csrc/bitdeposit.cu``: one block a frame (or a few, where K is small), the
frame's words in shared memory, each field OR-ed into them and the words
written out as bytes.  It replaces no TPU kernel (the JAX package deposits
with a bf16 one-hot einsum); it is bound by one read of the three field
planes, which it reads once, in the callers' dtypes, building the bytes in
shared memory.  A CPU tensor takes the plain version,
``deposit_fields_torch``: each field's share of each word splits into four
byte lanes, and every lane is added into the frame's byte plane with one
integer ``scatter_add_``.  The fields do not overlap, so the byte sums
equal the bitwise OR and stay below 256; integer atomics and the kernel's
OR are both order-free, so the result is the same on every run.
"""
import torch

from atracdenc_tpu_torch import kernels, trace

__all__ = ["deposit_fields", "deposit_fields_torch"]

_U32 = 0xFFFFFFFF
_PLANE_DTYPES = (torch.int32, torch.int64)


def _byte_lanes(x):
    """[..., K] words (low 32 bits of int64) -> [..., K, 4] bytes, MSB first."""
    return torch.stack([(x >> 24) & 0xFF, (x >> 16) & 0xFF, (x >> 8) & 0xFF,
                        x & 0xFF], dim=-1)


def deposit_fields_torch(values, widths, offsets, total_bytes):
    """Plain version; arguments and result as ``deposit_fields``."""
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


def _plane(x):
    """x as the kernel reads it: int32 or int64 (any other dtype as int64),
    row-major.  The callers' planes pass with no copy."""
    if x.dtype not in _PLANE_DTYPES:
        x = x.to(torch.int64)
    return x.contiguous()


@trace.span("deposit_fields")
def deposit_fields(values, widths, offsets, total_bytes):
    """values / widths / offsets [F, K] (any integer dtype) -> [F,
    total_bytes] uint8 frames.  Values must be pre-masked to their widths
    (a value is taken as its low 32 bits, like the JAX package's uint32),
    fields must not overlap and must be at most 32 bits wide.  Words past
    ``total_bytes`` are dropped, as the JAX one-hot drops them.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises: also when a frame's words do not fit a block's
    shared memory, past 232,444 bytes).  Nothing is read back from the
    device."""
    if values.device.type == "cpu":
        return deposit_fields_torch(values, widths, offsets, total_bytes)
    lib = kernels.library()
    total_bytes = int(total_bytes)
    if values.dim() != 2 or widths.shape != values.shape \
            or offsets.shape != values.shape:
        raise ValueError("deposit_fields: expected values, widths and offsets "
                         f"of one [F, K] shape, got {tuple(values.shape)}, "
                         f"{tuple(widths.shape)}, {tuple(offsets.shape)}")
    f, k = values.shape
    v, w, o = (_plane(x) for x in (values, widths, offsets))
    out = torch.empty((f, total_bytes), dtype=torch.uint8, device=values.device)
    if out.numel() == 0:
        return out
    # the kernel reads scalars: element alignment is enough
    kernels.require_cuda("deposit_fields", v, w, o, out, align=1)
    kernels.check(lib.deposit_fields(
        v.data_ptr(), v.element_size(), w.data_ptr(), w.element_size(),
        o.data_ptr(), o.element_size(), out.data_ptr(), f, k, total_bytes,
        kernels.stream_ptr(v)), "deposit_fields")
    trace.count("launch.deposit")
    return out
