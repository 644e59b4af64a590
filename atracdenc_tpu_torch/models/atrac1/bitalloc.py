"""ATRAC1 bit allocation as a fixed-schedule batched search.

Port of the XLA path of ``atracdenc_tpu/models/atrac1/bitalloc.py``
(reference src/lib/bs_encode/encode.cpp:57-129,
src/atrac/at1/atrac1_bitalloc.cpp): every frame runs an 11-step lambda
bisection, up to 7 BFU-shrink rounds (auto mode), then the leftover-bit
booster.  ``allocate`` here is the plain version of kernel E
(``ops/at1_alloc.py``, ``csrc/at1_alloc.cu``), and both are bit-equal:
each float op is elementwise in the XLA order and every sum is an integer
sum.

Float order, held by the kernel too: the allocation is
``trunc(((0.4f * (sfi / 3.2f) + 0.6f * fix) - shift) + bias)`` with the f32
roundings of the Python constants; the divisor 3.2 is a device tensor, so
CUDA's division by a host scalar (a multiply by its reciprocal) never
applies.
"""
import functools

import numpy as np
import torch

from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.models.atrac1 import tables as T
from atracdenc_tpu_torch.ops import psy

BISECT_STEPS = 11     # w_k = 18.02 / 2^k - 0.02 <= 0 at k = 10
SHRINK_ROUNDS = 8

# leftover-bit boost walk: (bits, position) sorted by bits, then position
# (multimap construction, atrac1_bitalloc.cpp:69-78)
BOOST_ENTRIES = sorted((int(T.SPECS_PER_BLOCK[i]), i)
                       for i in range(T.MAX_BFUS) if T.BIT_BOOST_MASK[i])
BOOST_MIN_KEY = BOOST_ENTRIES[0][0]
BOOST_MAX_PER_IT = BOOST_ENTRIES[-1][0]


def ath_long() -> np.ndarray:
    """Per-BFU ATH floor [52] f32: min ATH power over each BFU's
    long-window lines (atrac1_bitalloc.cpp:118-135)."""
    ath_spec = psy.calc_ath(512, 44100)
    out = np.empty(T.MAX_BFUS, dtype=np.float64)
    for b in range(T.MAX_BFUS):
        s, n = T.SPECS_START_LONG[b], T.SPECS_PER_BLOCK[b]
        out[b] = 10.0 ** (0.1 * ath_spec[s: s + n].min())
    return out.astype(np.float32)


@functools.lru_cache(maxsize=None)
def consts(dev):
    """The allocation tables on ``dev`` (kernel E takes them from here)."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    def i32(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=dev)
    return {"ath": f32(ath_long()), "fix_long": f32(T.FIXED_BIT_ALLOC_LONG),
            "fix_short": f32(T.FIXED_BIT_ALLOC_SHORT),
            "band": i32(T.BFU_TO_BAND), "specs": i32(T.SPECS_PER_BLOCK),
            "amount": i32(T.BFU_AMOUNT_TAB),
            "boost_bits": i32([b for b, _ in BOOST_ENTRIES]),
            "boost_pos": i32([p for _, p in BOOST_ENTRIES]),
            "iota": torch.arange(T.MAX_BFUS, device=dev),
            "sfi_div": f32(3.2)}


def _round_inputs(sfi, energy, short_flags, loudness, bfu_num):
    """The lambda-free parts of CalcBitsAllocation at one bfu_num
    (atrac1_bitalloc.cpp:147-205): (base, bias, dead, in_use), where the
    allocation is trunc((base - shift) + bias) and dead BFUs get 0."""
    c = consts(sfi.device)
    band = c["band"].long()
    in_use = c["iota"] < bfu_num[..., None]
    short_per_bfu = short_flags[..., band]

    # low -> mid tilt (atrac1_bitalloc.cpp:147-161)
    is_low = (band == 0) & in_use
    is_mid = (band == 1) & in_use
    n_low = torch.sum(is_low, dim=-1, dtype=torch.int32)
    n_mid = torch.sum(is_mid, dim=-1, dtype=torch.int32)
    sum_low = torch.sum(torch.where(is_low, sfi, 0), dim=-1).to(torch.float32)
    sum_mid = torch.sum(torch.where(is_mid, sfi, 0), dim=-1).to(torch.float32)
    tilt = torch.where((n_low > 0) & (n_mid > 0),
                       sum_low / torch.clamp(n_low, min=1)
                       - sum_mid / torch.clamp(n_mid, min=1), 0.0)
    mid_bias = torch.clamp(T.BAND_BIAS_GAIN * torch.clamp(
        tilt - T.BAND_BIAS_TILT_FLOOR, min=0.0), max=T.BAND_BIAS_MAX)
    band_bias = torch.stack([torch.zeros_like(mid_bias), mid_bias,
                             mid_bias * T.BAND_BIAS_HIGH_RATIO], dim=-1)
    bias = band_bias[..., band]

    fix = torch.where(short_per_bfu, c["fix_short"], c["fix_long"])
    gated = ~short_per_bfu & (energy < c["ath"] * loudness[..., None])
    spread = T.BIT_ALLOC_SPREAD
    base = spread * (sfi.to(torch.float32) / c["sfi_div"]) + (1.0 - spread) * fix
    return base, bias, gated | ~in_use, in_use


def _trunc_alloc(base, bias, dead, shift):
    tmp = torch.trunc(base - shift[..., None] + bias)   # C's int cast
    wl = torch.where(tmp > 16, 16.0, torch.where(tmp < 2, 0.0, tmp))
    return torch.where(dead, 0, wl.to(torch.int32))


def calc_bits_allocation(sfi, energy, short_flags, loudness, shift, bfu_num):
    """CalcBitsAllocation (atrac1_bitalloc.cpp:163-205): sfi [..., 52]
    int, energy [..., 52] f32, short_flags [..., 3] bool, loudness [...]
    (Loudness / LoudFactor), shift [...] f32, bfu_num [...] int ->
    wordlens [..., 52] int32 (zero past bfu_num)."""
    base, bias, dead, _ = _round_inputs(sfi, energy, short_flags, loudness,
                                        bfu_num)
    return _trunc_alloc(base, bias, dead, shift)


def _bits_used(wl, in_use, specs):
    return torch.sum(torch.where(in_use, specs * wl, 0), dim=-1,
                     dtype=torch.int32)


def _bisect(sfi, energy, short_flags, loudness, bfu_num):
    """Fixed-step lambda bisection (encode.cpp:57-98) -> final wordlens."""
    base, bias, dead, in_use = _round_inputs(sfi, energy, short_flags,
                                             loudness, bfu_num)
    specs = consts(sfi.device)["specs"]
    target = T.available_bits(bfu_num)
    min_l = torch.full(bfu_num.shape, -3.0, device=sfi.device)
    max_l = torch.full(bfu_num.shape, 15.0, device=sfi.device)
    last_l = torch.full(bfu_num.shape, 15.0, device=sfi.device)
    for _ in range(BISECT_STEPS):
        active = max_l > min_l
        cur = (max_l + min_l) * 0.5
        bits = _bits_used(_trunc_alloc(base, bias, dead, cur), in_use, specs)
        under = bits < target
        over = bits > target
        exact = ~under & ~over
        last_l = torch.where(active & (under | exact), cur, last_l)
        max_l = torch.where(active & under, cur - 0.01, max_l)
        min_l = torch.where(active & over, cur + 0.01, min_l)
        # an exact hit ends the search: collapse the interval
        max_l = torch.where(active & exact, min_l, max_l)
    return _trunc_alloc(base, bias, dead, last_l)


def _apply_boost(wl, bfu_num):
    """Spend leftover bits on the whitelisted BFUs
    (atrac1_bitalloc.cpp:80-114)."""
    c = consts(wl.device)
    in_use = c["iota"] < bfu_num[..., None]
    surplus = T.available_bits(bfu_num) - _bits_used(wl, in_use, c["specs"])
    key = torch.clamp(surplus, max=BOOST_MAX_PER_IT)
    # frames whose initial surplus is below every entry never boost
    enabled = surplus >= BOOST_MIN_KEY
    wl = wl.clone()                     # boosted in place below

    def one_pass(surplus):
        changed = torch.zeros(surplus.shape, dtype=torch.bool, device=wl.device)
        for bits, pos in BOOST_ENTRIES:
            w = wl[..., pos]
            nbps = torch.where(w > 0, 1, 2)
            # the reference breaks the pass at the first pos >= bfuNum; the
            # walk visits positions in increasing order within equal keys
            # and keys only grow, so a mask is the same for this table
            ok = (enabled & (surplus >= BOOST_MIN_KEY) & (bits <= key)
                  & (pos < bfu_num) & (w != 16)
                  & ~((w == 0) & (bits * 2 > surplus))
                  & (bits * nbps <= surplus))
            inc = torch.where(ok, nbps, 0).to(wl.dtype)
            wl[..., pos] = w + inc
            surplus = surplus - inc * bits
            changed = changed | ok
        return surplus, changed

    surplus, changed = one_pass(surplus)
    while runtime.host_bool(torch.any(changed & (surplus >= BOOST_MIN_KEY))):
        surplus, changed = one_pass(surplus)
    return wl


def allocate(sfi, energy, short_flags, loudness, bfu_idx_const=0):
    """Full ATRAC1 rate control for a batch of frames: kernel E's plain
    version (the JAX package's XLA ``allocate``).

    sfi [..., 52] int, energy [..., 52] f32, short_flags [..., 3] bool,
    loudness [...] f32 (Loudness / LoudFactor); bfu_idx_const 0 (auto) or
    1..8 (--bfuidxconst).  Returns (bfu_idx [...] int32, wordlen [..., 52]
    int32)."""
    amount = consts(sfi.device)["amount"]
    iota = consts(sfi.device)["iota"]
    auto = bfu_idx_const == 0
    bfu_idx = torch.full(loudness.shape, 7 if auto else bfu_idx_const - 1,
                         dtype=torch.int32, device=sfi.device)
    wl = _bisect(sfi, energy, short_flags, loudness, amount[bfu_idx.long()])
    for _ in range(SHRINK_ROUNDS - 1 if auto else 0):
        bfu_num = amount[bfu_idx.long()]
        last_nz = torch.amax(torch.where((wl > 0) & (iota < bfu_num[..., None]),
                                         iota, -1), dim=-1)
        # lower_bound over the 8-entry table as a comparison count
        used_idx = torch.sum(amount < (last_nz + 1)[..., None], dim=-1,
                             dtype=torch.int32)
        repeat = used_idx < bfu_idx
        if not runtime.host_bool(torch.any(repeat)):
            break                       # a round that repeats nothing is a fixed point
        bfu_idx = torch.where(repeat, bfu_idx - 1, bfu_idx)
        new_wl = _bisect(sfi, energy, short_flags, loudness,
                         amount[bfu_idx.long()])
        wl = torch.where(repeat[..., None], new_wl, wl)
    return bfu_idx, _apply_boost(wl, amount[bfu_idx.long()])
