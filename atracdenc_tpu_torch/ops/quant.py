"""Mantissa quantisation with energy-adjusted rounding ("EA").

Port of ``atracdenc_tpu/ops/quant.py``: round-half-even quantisation plus,
in EA mode, a greedy pass over borderline values (|frac - 0.5| < 0.25)
sorted by distance to the rounding boundary, flipping roundings while that
moves the quantised block energy toward the original energy (reference
QuantMantisas, src/atrac/atrac_scale.cpp:40-130).

The candidate order is a stable sort by |delta| (ties by element index);
the sequential accept recurrence is kernel B (``ops/greedy.py``) by
default, or any function with its signature.

The original energy e1 is summed in one fixed order (``lane_sum``): the
accept decisions compare against it, so the fused memo kernel
(``csrc/quant_full.cu``) has to see the same bits as this module.
"""
import torch

from atracdenc_tpu_torch.ops.greedy import greedy_scan

__all__ = ["lane_sum", "quant_blocks"]


def lane_sum(v):
    """Sum over the last axis (a multiple of 32 long) in the order a CUDA
    warp sums it: lane i adds elements i, i+32, i+64, ... in turn, then the
    32 partial sums fold in halves (16, 8, 4, 2, 1).  Only elementwise adds,
    so the result is the same on every backend."""
    L = v.shape[-1]
    parts = v.reshape(v.shape[:-1] + (L // 32, 32))
    s = parts[..., 0, :]
    for j in range(1, L // 32):
        s = s + parts[..., j, :]
    for o in (16, 8, 4, 2, 1):
        s = s[..., :o] + s[..., o:2 * o]
    return s[..., 0]


def _round_energy(scaled, valid, mul):
    """Plain ToInt quantisation + energies.

    scaled [..., L] (L a multiple of 32); valid [..., L] bool; mul [...]
    multiplier.  Returns (mant int32 [..., L], e1 [...], e2 [...]); e2 is
    a sum of integers, exact in any order."""
    t = scaled * mul[..., None]
    mant = torch.where(valid, torch.round(t).to(torch.int32), 0)
    inv2 = 1.0 / (mul * mul)
    e1 = lane_sum(torch.where(valid, scaled * scaled, 0.0))
    m2 = (mant * mant).to(scaled.dtype)
    e2 = torch.sum(torch.where(valid, m2, 0.0), dim=-1) * inv2
    return mant, e1, e2


def _flip_up(m, tpos):
    """Mantissa rounded one step away from zero (sign of t at m == 0)."""
    return torch.where(m > 0, m + 1, torch.where(
        m < 0, m - 1, torch.where(tpos, 1, -1).to(m.dtype)))


def _flip_dn(m):
    return torch.where(m > 0, m - 1, torch.where(m < 0, m + 1, m))


def quant_blocks(scaled, valid, mul, ea_mask, aux=None, scan=greedy_scan):
    """Quantise padded blocks at a multiplier, with EA where masked.

    scaled [..., L] (padding 0), valid [..., L] bool, mul [...] f32
    (MaxQuant[wordlen]; 0 -> all-zero output), ea_mask [...] bool.
    aux: optional [..., L] int32 per-candidate weights; then COST mode:
    returns (err [...], aux summed over accepted flips [...] int32).
    Without aux returns (mant [..., L] int32, err [...]).  err = e1/e2 in
    f32 (inf / nan propagate like the reference).  scan runs the accept
    recurrence: ``greedy_scan`` (kernel B on a CUDA tensor) or its plain
    version ``greedy_torch``.
    """
    valid = valid.expand(scaled.shape)
    t = scaled * mul[..., None]
    mant0, e1, e2 = _round_energy(scaled, valid, mul)
    inv2 = torch.where(mul > 0, 1.0 / (mul * mul), 0.0)

    # EA candidates: |t - (trunc(t) + 0.5)| < 0.25 (atrac_scale.cpp:66-73)
    delta = t - (torch.trunc(t) + 0.5)
    cand = valid & (torch.abs(delta) < 0.25) & ea_mask[..., None] \
        & (mul > 0)[..., None]

    batch_shape = scaled.shape[:-1]
    L = scaled.shape[-1]
    t = t.reshape(-1, L)
    mant = mant0.reshape(-1, L)
    cand = cand.reshape(-1, L)
    e1f = e1.reshape(-1)
    e2f = e2.reshape(-1)
    mulf = mul.expand(batch_shape).reshape(-1)
    inv2f = inv2.expand(batch_shape).reshape(-1)
    abs_t = torch.abs(t)
    abs_m = torch.abs(mant).to(scaled.dtype)

    up = e2f < e1f        # branch fixed before the pass (atrac_scale.cpp:85,107)
    dn = e2f > e1f
    tpos = t > 0
    m_new = torch.where(up[:, None], _flip_up(mant, tpos), _flip_dn(mant))
    elig_up = (abs_m < abs_t) & (abs_m < (mulf - 1.0)[:, None])
    elig_dn = abs_m > abs_t
    elig = cand & torch.where(up[:, None], elig_up,
                              torch.where(dn[:, None], elig_dn, False))

    # candidates in |delta|-ascending order; the stable sort reproduces the
    # JAX package's index tie-break
    key = torch.where(cand, torch.abs(delta.reshape(-1, L)), torch.inf)
    _, order = torch.sort(key, dim=-1, stable=True)
    m_s = torch.gather(mant, 1, order)
    elig_s = torch.gather(elig, 1, order)
    tpos_s = torch.gather(tpos, 1, order)
    mn_s = torch.where(up[:, None], _flip_up(m_s, tpos_s), _flip_dn(m_s))
    a = (m_s * m_s).to(scaled.dtype) * inv2f[:, None]
    b = (mn_s * mn_s).to(scaled.dtype) * inv2f[:, None]

    # e2 update terms in the reference's float order:
    # ex = (e2 - m^2*inv2) + m'^2*inv2 (atrac_scale.cpp:96-98,118-121)
    e2_fin, accept_s = scan(a, b, elig_s, e1f, e2f)
    err = (e1f / e2_fin).reshape(batch_shape)

    if aux is not None:
        aux_s = torch.gather(aux.reshape(-1, L), 1, order)
        aux_sum = torch.sum(torch.where(accept_s, aux_s, 0), dim=-1,
                            dtype=torch.int32)
        return err, aux_sum.reshape(batch_shape)

    accept = torch.zeros_like(accept_s)
    accept.scatter_(1, order, accept_s)
    mant = torch.where(accept, m_new, mant).reshape(batch_shape + (L,))
    return torch.where(valid, mant, 0), err
