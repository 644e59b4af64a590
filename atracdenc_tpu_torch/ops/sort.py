"""Bitonic sorting network over the last axis, as elementwise stages.

Port of ``atracdenc_tpu/ops/sort.py``.  Nothing in either package calls
it: the JAX package wrote it because XLA's sort was slow on the TPU for its
shapes, and the port's encoders use ``torch.sort`` / ``torch.argsort``.  It
is kept so that every JAX module has its counterpart.  The log2(n) *
(log2(n) + 1) / 2 compare-exchange stages are roll + min / max / select;
payloads ride along with the key (a multi-operand sort), and sorting an
iota payload by itself restores the original order (``bitonic_unsort``).
"""
import torch

__all__ = ["bitonic_sort", "bitonic_unsort"]


def _stages(n):
    """The (k, j) schedule of the network."""
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            yield k, j
            j //= 2
        k *= 2


def bitonic_sort(key, payloads=()):
    """Sort ``key`` ascending along the last axis (a power-of-two length),
    permuting each payload identically.  Returns (key_sorted, payloads)."""
    n = key.shape[-1]
    if n & (n - 1):
        raise ValueError(f"bitonic sort needs a power-of-two length, not {n}")
    idx = torch.arange(n, device=key.device)
    payloads = tuple(payloads)
    for k, j in _stages(n):
        low = (idx & j) == 0
        take_min = ((idx & k) == 0) == low

        def partner(x):
            return torch.where(low, torch.roll(x, -j, dims=-1),
                               torch.roll(x, j, dims=-1))

        pk = partner(key)
        new_key = torch.where(take_min, torch.minimum(key, pk),
                              torch.maximum(key, pk))
        take_p = torch.where(take_min, pk < key, pk > key)
        payloads = tuple(torch.where(take_p, partner(p), p) for p in payloads)
        key = new_key
    return key, list(payloads)


def bitonic_unsort(order, payloads):
    """Invert a permutation: ``order`` is the iota payload that
    ``bitonic_sort`` produced; sorting by it restores original positions."""
    _, out = bitonic_sort(order.to(torch.int32), payloads)
    return out
