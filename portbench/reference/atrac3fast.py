"""ATRAC3 reference fast enough to check past the first carry: the frames of
``atrac3.py``, byte for byte, in about a quarter of its time.

``upstream/atrac3/`` replays the upstream encoder's float32 decision chain
in scalar Python, about 0.2 s a frame.  Its hot loops are float32 sums
taken one term after another and per-BFU arithmetic repeated at every step
of the rate control's bisection.  While ``encode_rows`` runs, the
functions below stand in for those loops.  Each gives the same float32
values in the same order:

* a sequential float32 sum is ``np.add.accumulate`` (which adds term after
  term, unlike ``np.sum``'s pairwise order), read at its last element;
* element-wise float32 operations on arrays round once per operation, as
  the scalar ones do;
* the bisection's per-BFU terms that do not depend on its shift are
  computed once a channel-frame, its energy-boost loop once for each
  allocation it starts from, and the tonal components' bit count once for
  each set of word lengths it depends on.

Everything else, the branches included, is the model's own code.  The
stand-ins take what the model passes them: float32 arrays of its shapes.
``portbench/tests/test_portbench_lp4.py`` holds these frames against
``atrac3.py``'s.
"""
import contextlib

import numpy as np

from portbench.reference import atrac3 as plain
from portbench.reference.upstream.atrac3 import exact_enc as E
from portbench.reference.upstream.atrac3 import exact_gain as G
from portbench.reference.upstream.atrac3 import frame as frame_io
from portbench.reference.upstream.atrac3 import tables as T

f32 = np.float32
SAMPLES_PER_FRAME = plain.SAMPLES_PER_FRAME
ROWS_PER_FRAME = plain.ROWS_PER_FRAME

_B2B = np.asarray(T.BFU_TO_BAND, np.int64)
_XS = np.asarray([E._x_of(i) for i in range(32)], f32)
_FIXF = E._FIX.astype(f32)
_STARTS = E._BLOCK_TAB[:32].tolist()                 # each BFU's lines
_ENDS = (E._BLOCK_TAB[:32] + E._SPECS).tolist()


def _last_sum(terms):
    """``s = f32(s + t)`` over ``terms`` [..., n] f32 from 0, per row."""
    return np.add.accumulate(terms, axis=-1)[..., -1]


def _rms_rows(sq):
    """``exact_gain._rms`` of each row, from its squares [..., n] f32."""
    s = (_last_sum(sq) / f32(sq.shape[-1])).astype(f32)
    return np.sqrt(s).astype(f32)


def analyze_gain(sig, max_points, want_quantiles):
    """``exact_gain.analyze_gain`` (AnalyzeGain with RMS and quantiles)."""
    step = len(sig) // max_points
    chunk = max(1, step // 8)
    sq = np.asarray(sig * sig).astype(f32).reshape(max_points, step)
    res = _rms_rows(sq)
    if not want_quantiles:
        return res, None, None
    micro = np.sort(_rms_rows(sq.reshape(max_points, step // chunk, chunk)),
                    axis=-1)
    n = step // chunk
    return res, micro[:, n // 4].copy(), micro[:, (n * 3) // 4].copy()


def calc_gain_energy_scale(prev_overlap, cur_input, pts, prev_scale, enc_win):
    """``exact_gain.calc_gain_energy_scale`` (CalcGainEnergyScale)."""
    div = G.build_sample_divisors(pts)
    if not np.isfinite(prev_scale) or prev_scale <= 0.0:
        prev_scale = f32(1.0)
    prev_div = G.GAIN_LEVEL[pts[0][0]] if pts else f32(1.0)
    pse = _last_sum(prev_overlap * prev_overlap)
    prev_orig = f32(pse * prev_scale)
    prev_mod = f32(pse / f32(prev_div * prev_div))
    mod = cur_input / div
    wc = enc_win[255::-1]
    wn = enc_win[:256]
    cw, mcw = cur_input * wc, mod * wc
    nw, mnw = cur_input * wn, mod * wn
    cur_o, cur_m = _last_sum(cw * cw), _last_sum(mcw * mcw)
    nxt_o, nxt_m = _last_sum(nw * nw), _last_sum(mnw * mnw)
    scale = G._safe_energy_scale
    return (scale(prev_orig, prev_mod), scale(cur_o, cur_m),
            scale(f32(prev_orig + cur_o), f32(prev_mod + cur_m)),
            scale(nxt_o, nxt_m))


def _bits_base(sfi, energy, spread, loudness, gain_frame_scale):
    """The shift-free part of ``_calc_bits_allocation`` for all 32 BFUs:
    (``tmp_f`` before the shift is taken off, the BFUs above the ATH)."""
    gs = np.asarray(gain_frame_scale, f32)[_B2B]
    live = ~((np.asarray(energy, f32) * gs) < (E._ATH * f32(loudness)))
    off_band = np.asarray([f32(f32(1.5) * f32(E._libm.log2f(float(g))))
                           for g in np.asarray(gain_frame_scale, f32)], f32)
    csfi = np.maximum(f32(0.0), np.minimum(
        f32(63.0), np.asarray(sfi).astype(f32) + off_band[_B2B]))
    tmp_f = spread * (csfi / _XS) + (f32(1.0) - spread) * _FIXF
    return tmp_f.astype(f32), live


def _bits(base, live, num_bfu, shift, tonal_bfus):
    """``_calc_bits_allocation`` at ``shift`` from ``_bits_base``."""
    tmp = np.trunc(base[:num_bfu] - f32(shift)).astype(np.int64)
    bits = np.where(tmp == 0, 1, np.clip(tmp, 0, 7)) * live[:num_bfu]
    for bfu in tonal_bfus:
        if bfu < num_bfu and bits[bfu] > 2:
            bits[bfu] -= 1
    return bits


class _Costs:
    """``_QuantCache`` read a whole allocation at a time: err, CLC and VLC
    bits per (BFU, word length), each computed once by the model's own
    ``_QuantCache.get``; word length 0 costs nothing."""

    def __init__(self, vals):
        self.cache = E._QuantCache(vals)
        self.have = np.zeros(32 * 8, bool)
        self.have[::8] = True
        self.err = np.zeros(32 * 8, f32)
        self.bits = np.zeros((2, 32 * 8), np.int64)     # CLC, VLC
        self.rows = np.arange(32) * 8

    def of(self, alloc):
        """-> (err [n] f32, nonzero count, CLC bits, VLC bits)."""
        k = self.rows[:len(alloc)] + alloc
        if not self.have.take(k).all():
            for kk in k[~self.have.take(k)]:
                _, e, cb, vb = self.cache.get(int(kk) // 8, int(kk) % 8)
                self.err[kk], self.bits[0, kk], self.bits[1, kk] = e, cb, vb
                self.have[kk] = True
        clc, vlc = self.bits.take(k, axis=1).sum(axis=1).tolist()
        return self.err.take(k), np.count_nonzero(alloc), clc, vlc


def quant_mantissas(vals, mul, ea):
    """``exact_enc.quant_mantissas_exact`` (QuantMantisas, EA rounding):
    the first pass as arrays, the candidates' pass as the model writes
    it."""
    inv2 = f32(np.float64(1.0) / np.float64(f32(mul * mul)))
    t_all = (vals * mul).astype(f32)
    e1 = _last_sum(vals * vals)
    mant = np.rint(t_all).astype(np.int64)
    e2 = _last_sum((mant * mant).astype(f32) * inv2)
    if not ea:
        return mant, E._err_div(e1, e2)
    adelta = np.abs(t_all - (np.trunc(t_all) + f32(0.5)))
    cand = np.flatnonzero(adelta < 0.25)
    if not len(cand):
        return mant, E._err_div(e1, e2)
    # std::sort by |delta|, insertion order on ties (as the model)
    order = cand[np.argsort(adelta[cand], kind="stable")].tolist()
    if e2 < e1:
        for j in order:
            t = t_all[j]
            if (f32(abs(mant[j])) < abs(t)
                    and f32(abs(mant[j])) < f32(mul - 1.0)):
                m = mant[j]
                if m > 0:
                    m += 1
                if m < 0:
                    m -= 1
                if m == 0:
                    m = 1 if t > 0 else -1
                ex = f32(f32(e2 - f32(f32(mant[j] * mant[j]) * inv2))
                         + f32(f32(m * m) * inv2))
                if abs(f32(ex - e1)) < abs(f32(e2 - e1)):
                    mant[j] = m
                    e2 = ex
    elif e2 > e1:
        for j in order:
            t = t_all[j]
            if f32(abs(mant[j])) > abs(t):
                m = mant[j]
                if m > 0:
                    m -= 1
                if m < 0:
                    m += 1
                ex = f32(f32(e2 - f32(f32(mant[j] * mant[j]) * inv2))
                         + f32(f32(m * m) * inv2))
                if abs(f32(ex - e1)) < abs(f32(e2 - e1)):
                    mant[j] = m
                    e2 = ex
    return mant, E._err_div(e1, e2)


def _scale_frame(spec):
    """``exact_enc._scale_frame`` (TScaler::Scale per BFU)."""
    mx = np.minimum(np.maximum.reduceat(np.abs(spec), _STARTS), f32(1.0))
    sfi = np.searchsorted(E._SCALE_TABLE, mx, side="left").astype(np.int32)
    sv = spec / np.repeat(E._SCALE_TABLE[sfi], E._SPECS)
    sv = np.where(np.abs(sv) >= 1.0,
                  np.where(sv > 0, f32(0.99999), f32(-0.99999)), sv)
    sq = spec * spec
    energy = np.asarray([_last_sum(sq[a:b]) for a, b in zip(_STARTS, _ENDS)],
                        f32)
    return sfi, [sv[a:b] for a, b in zip(_STARTS, _ENDS)], energy


def _flatness_per_bfu(energy_spec):
    """``exact_enc._flatness_per_bfu`` (CalcSpectralFlatnessPerBfu): the
    double sums as arrays, the rest the model's."""
    floor = float(f32(1e-12))
    e = np.maximum(energy_spec, f32(0.0)).astype(np.float64)
    logs = np.log(np.maximum(e, floor))
    flat = np.ones(32, f32)
    for b, (lo, hi) in enumerate(zip(_STARTS, _ENDS)):
        am = float(_last_sum(e[lo:hi])) / (hi - lo)
        ml = float(_last_sum(logs[lo:hi])) / (hi - lo)
        if am <= floor:
            continue
        flat[b] = f32(min(1.0, max(0.0, np.exp(ml) / am)))
    return flat


def _allocate_channel(sfi, vals, energy, target_bits, loudness,
                      gain_frame_scale, tonal_bfus=(), tonal_cost_fn=None,
                      bfu_idx_const=0):
    """``exact_enc._allocate_channel`` (TConfigure + TAlloc), the same
    loops over ``_bits`` and ``_Costs``."""
    costs = _Costs(vals)
    spread = E._spread(sfi)
    num_bfu = bfu_idx_const if bfu_idx_const else 32
    if target_bits < 101:
        lim = max(1, (target_bits - 5) // 3) if target_bits > 5 else 1
        num_bfu = min(num_bfu, lim)
    num_bfu = max(1, num_bfu)
    base, live = _bits_base(sfi, energy, spread, loudness, gain_frame_scale)
    tonal_bfus = [int(b) for b in tonal_bfus]
    tonal_memo = {}
    boosted = {}          # first allocation -> (boosted, bits used, mode)

    def tonal_cost(alloc):
        # the tonal bit count reads alloc only at the tonal BFUs
        key = (len(alloc),) + tuple(int(alloc[b]) for b in tonal_bfus
                                    if b < len(alloc))
        if key not in tonal_memo:
            tonal_memo[key] = (tonal_cost_fn(alloc) if tonal_cost_fn
                               else 5)        # empty tonal header
        return tonal_memo[key]

    while True:                                      # BFU-shrink restarts
        min_l, max_l = f32(-8.0), f32(20.0)
        last_l = f32(20.0)
        while True:                                  # lambda bisection
            if max_l <= min_l:
                shift = last_l
                final = True
            else:
                shift = f32(f32(max_l + min_l) / f32(2.0))
                final = False
            alloc = _bits(base, live, num_bfu, shift, tonal_bfus)
            key = alloc.tobytes()
            if key not in boosted:
                while True:                          # energy-boost loop
                    err, used_bfus, clc_sum, vlc_sum = costs.of(alloc)
                    used = num_bfu * 3 + 6 * used_bfus
                    mode = 1 if clc_sum <= vlc_sum else 0
                    bits_used = used + (clc_sum if mode else vlc_sum)
                    if not E._consider_energy_err(err, alloc):
                        break
                boosted[key] = alloc, bits_used, mode
            alloc, bits_used, mode = boosted[key]
            total = bits_used + tonal_cost(alloc)
            if final:
                break
            if total < target_bits:
                last_l = shift
                max_l = f32(shift - f32(0.01))
            elif total > target_bits:
                min_l = f32(shift + f32(0.01))
            else:
                break
        if bfu_idx_const == 0 and num_bfu > 1 and alloc[num_bfu - 1] == 0:
            num_bfu -= 1
            continue
        mants = [costs.cache.get(i, int(alloc[i]))[0] if alloc[i] else
                 np.zeros(int(E._SPECS[i]), np.int64) for i in range(num_bfu)]
        wl = np.zeros(32, np.int64)
        wl[:num_bfu] = alloc
        return num_bfu, mode, wl, mants


_STAND_INS = [(G, "analyze_gain", analyze_gain),
              (G, "calc_gain_energy_scale", calc_gain_energy_scale),
              (E, "_allocate_channel", _allocate_channel),
              (E, "quant_mantissas_exact", quant_mantissas),
              (E, "_scale_frame", _scale_frame),
              (E, "_flatness_per_bfu", _flatness_per_bfu)]


@contextlib.contextmanager
def _stand_ins():
    """The functions above in place of the model's, for one encode."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in _STAND_INS]
    for mod, name, fn in _STAND_INS:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, orig in saved:
            setattr(mod, name, orig)


def encode_rows(cfg, pcm):
    """``atrac3.encode_rows``: f32 [2, T] (whole frames, from a track's
    start) -> the upstream encoder's frames, uint8 [T / 1024,
    frame_bytes]."""
    opts = plain.options(cfg)
    with _stand_ins():
        planes = E.encode_track_exact(pcm, **opts)
    return frame_io.pack(planes, opts["frame_bytes"], opts["js"])


class Reference(plain.Reference):
    encode_rows = staticmethod(encode_rows)
