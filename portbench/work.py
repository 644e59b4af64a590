"""The yardstick of the roofline metrics: each stage's least work, and the
card's published peaks.

A stage's operations and bytes are computed from the shapes of its own
inputs and outputs, each input read once and each output written once, so
the same stage gets the same work whichever kernels compute it (kernels A
and B or the fused kernel D for the ATRAC3 memo; kernel E or the tensor
ops for the ATRAC1 rate control).  A tensor that is a broadcast view
counts the bytes of its storage, not of its view.

``least_seconds`` is the larger of operations over the float32 peak
(CUDA cores, no tensor cores: these stages are integer and f32 scalar
work) and bytes over the HBM bandwidth.  The peaks are NVIDIA's data sheet
for the H100 SXM5 (dense, at the full 700 W power limit); ``PEAKS`` is keyed
by ``torch.cuda.get_device_name()``, and a card not in it gets no roofline.
"""
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_ops_per_s": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}

MEMO_WORDLENS = 8           # the memo's lanes: wordlens 0..7
MEMO_OPS_PER_VALUE = 5      # scale, round, square-accumulate, VLC index, bits
AT1_OPS_PER_BFU = 10        # one evaluation of the allocation per BFU

_VALID = {}                 # valid values of each mask seen


def tensor_bytes(t):
    """Bytes of ``t`` as stored: a broadcast (stride 0) view counts once."""
    span = 1
    for size, stride in zip(t.shape, t.stride()):
        if size > 1 and stride != 0:
            span *= size
    return span * t.element_size()


def quant_memo(args, kwargs, result):
    """``bitalloc.quant_tensors(scaled [..., 32, 128], valid_mask [32, 128],
    fused_memo)`` -> {"err", "clc", "vlc"} [..., 32, 8]: every valid value
    quantised at every wordlen (``MEMO_OPS_PER_VALUE`` operations each);
    ``scaled`` and the mask read, ``err`` and ``vlc`` written (``clc`` is a
    broadcast table)."""
    scaled, mask = args[0], args[1]
    rows = scaled.numel() // (32 * 128)
    key = (mask.data_ptr(), tuple(mask.shape))
    if key not in _VALID:                 # one read of the constant mask
        _VALID[key] = int(mask.sum())
    valid = _VALID[key]
    ops = rows * valid * MEMO_WORDLENS * MEMO_OPS_PER_VALUE
    nbytes = (tensor_bytes(scaled) + tensor_bytes(mask)
              + tensor_bytes(result["err"]) + tensor_bytes(result["vlc"]))
    return ops, nbytes


def at1_alloc(args, kwargs, result):
    """``at1_allocate_block`` / ``bitalloc.allocate(sfi [..., 52], energy
    [..., 52], short_flags [..., 3], loudness [...])`` -> (bfu_idx [...],
    wordlen [..., 52]): one evaluation per BFU (``AT1_OPS_PER_BFU``); the
    four inputs read, the two outputs written."""
    sfi, energy, flags, loud = args[:4]
    ops = sfi.numel() * AT1_OPS_PER_BFU
    nbytes = sum(tensor_bytes(t) for t in (sfi, energy, flags, loud)) \
        + sum(tensor_bytes(t) for t in result)
    return ops, nbytes


def least_seconds(ops, nbytes, device_name):
    """The least time the card could take, or None for a card not in
    ``PEAKS``."""
    peak = PEAKS.get(device_name)
    if peak is None:
        return None
    return max(ops / peak["f32_ops_per_s"], nbytes / peak["hbm_bytes_per_s"])

