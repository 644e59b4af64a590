"""ATRAC1 sound-unit serialization on the device.

Port of ``atracdenc_tpu/models/atrac1/device_pack.py``: the field planes of
the host packer ``frame.pack`` (the AT1 layout has no data-dependent
interleave, so the offsets are a plain prefix sum), deposited into 212-byte
units by ``ops/bitdeposit.deposit_fields``.  Layout per the reference writer
(atrac1_bitalloc.cpp:279-327).  Byte-identical to ``frame.pack``
(tests/test_torch_device_pack.py).
"""
import torch

from atracdenc_tpu_torch import runtime, trace
from atracdenc_tpu_torch.models.atrac1 import tables as T
from atracdenc_tpu_torch.ops.bitdeposit import deposit_fields

__all__ = ["pack_device", "merge_channels"]

PLANES = ("short_mask", "bfu_idx", "wordlen", "sfi", "mant")
_HEADER_WIDTHS = (2, 2, 2, 2, 3, 2, 3)


def merge_channels(planes):
    """Encoder planes [..., C, F, ...] (numpy arrays or tensors, with or
    without a stream axis in front) -> the packers' one frame axis [N, ...]
    in sound-unit order: streams one after another, each frame's channels
    side by side.  Only the wire planes (``PLANES``) are kept."""
    lead = planes["bfu_idx"].ndim - 2
    return {k: planes[k].swapaxes(lead, lead + 1).reshape(
        (-1,) + tuple(planes[k].shape[lead + 2:])) for k in PLANES}


@trace.span("at1.pack")
def pack_device(planes):
    """Planes with one merged frame axis (channel-interleaved, as
    ``frame.pack`` takes them): short_mask [N, 3], bfu_idx [N], wordlen /
    sfi [N, 52], mant [N, 52, 20] -> [N, 212] uint8."""
    i64 = torch.int64
    short = planes["short_mask"].bool()
    bfu_idx = planes["bfu_idx"].to(i64)
    wl = planes["wordlen"].to(i64)
    sfi = planes["sfi"].to(i64)
    mant = planes["mant"].to(i64)
    n, dev = bfu_idx.shape[0], bfu_idx.device
    bfu_num = runtime.from_host(T.BFU_AMOUNT_TAB, dev).to(i64)[bfu_idx]
    in_use = torch.arange(T.MAX_BFUS, device=dev)[None, :] < bfu_num[:, None]
    zero = torch.zeros(n, dtype=i64, device=dev)

    head_v = torch.stack([
        torch.where(short[:, 0], 0, 2), torch.where(short[:, 1], 0, 2),
        torch.where(short[:, 2], 0, 3), zero, bfu_idx, zero, zero], dim=1)
    head_w = runtime.from_host(_HEADER_WIDTHS, dev).expand(n, -1)

    wl_v = torch.where(wl > 0, wl - 1, 0)
    wl_w = torch.where(in_use, 4, 0)
    sfi_w = torch.where(in_use, 6, 0)

    spec_valid = runtime.from_host(T.GATHER_MASK, dev)[None]
    mant_w = torch.where(spec_valid & (wl >= 2)[:, :, None]
                         & in_use[:, :, None], wl[:, :, None], 0)
    # two's-complement truncation to the field width (int64: wl <= 16)
    mant_v = mant & ((1 << torch.clamp(mant_w, min=1)) - 1)

    with trace.span("field_cat"):
        values = torch.cat([head_v, wl_v, sfi, mant_v.reshape(n, -1)], 1)
        widths = torch.cat([head_w, wl_w, sfi_w, mant_w.reshape(n, -1)], 1)
    with trace.span("offset_scan"):
        offsets = torch.cumsum(widths, -1) - widths
    return deposit_fields(values, widths, offsets, T.SOUND_UNIT_SIZE)
