"""The GHA tonal model of the upstream ATRAC3+ encoder (``-e atrac3plus``,
GHA_ENABLED), one frame at a time, in float32 NumPy.

Upstream (src/atrac/at3p/at3p_gha.cpp) runs a round-based accept / refine
protocol around the libgha sinusoid estimator.  This model follows the JAX
package's formulation of it (``atracdenc_tpu/models/atrac3p/gha.py``),
written here as plain NumPy over the lanes of one frame (a lane is one
channel's subband, channel-major):

  * ``greedy``: per lane ``MAX_WAVES`` rounds on the zero-padded 2048-point
    spectrum (a [128, 1024] cos / sin product, whose bins are the 10-bit
    FreqIndex grid): the strongest bin past DC, its amplitude on the 6-bit
    ladder 2^((sf-3)/4) (AmplitudeToSf, at3p_gha.cpp:1667-1676) and its
    phase on the 5-bit grid; a wave is kept while it removes at least 10% of
    the lane's energy, lies above the subband ATH and 23 dB below the lane's
    strongest kept wave (PsyPreCheck, at3p_gha.cpp:955-973) and 20 bins from
    every kept wave (DoRound, at3p_gha.cpp:920-940); the first failure ends
    the lane;
  * ``analyse``: the 48-tone budget of a frame (ApplyFilter,
    at3p_gha.cpp:629), the envelope as the longest run of 4-sample blocks
    the fit lowers (CheckResuidalAndApply, at3p_gha.cpp:492-579), a refit on
    the truncated window and the rejection of runs shorter than 4 blocks;
  * ``finish``: the next-frame continuation check (CheckNextFrame,
    at3p_gha.cpp:780-812) on the next frame's first 64 samples, the wire
    envelope (AdjustEnvelope, at3p_gha.cpp:1499-1521) and the stereo
    leader / follower sharing (FillResultBuf / FillFolowerRes,
    at3p_gha.cpp:1522-1664);
  * ``block`` and ``synth_frame``: the decoder's tone synthesis
    (ff_atrac3p_generate_tones and waves_synth, atrac3plusdsp.c:77-204,
    amplitude mode 1): content frame c receives the falling half of block
    c's waves and the rising half of block c+1's, with the envelope fades
    at 4-sample steps and the cross-frame envelope of generate_tones, so the
    residual subtracts what a decoder adds back.

Planes of one frame: freq / amp_sf / phase / valid [C, 8, MAX_WAVES],
env_start / env_stop [C, 8] (-1 = point absent), sharing [8] bool, leader
int.  They are wire-effective: a shared subband carries the leader's waves
in both channels.
"""
import numpy as np

F32 = np.float32
NUM_TONE_SUBBANDS = 8       # upstream analyses subbands 0..7
MAX_WAVES = 8               # rounds a subband (the wire allows 15)
MIN_FREQ_DIST = 20          # DoRound's minFreqDistanse
MAX_TOTAL_TONES = 48        # ApplyFilter's limit of waves a frame
ACCEPT_RATIO = F32(0.9)     # a wave stays if it removes >= 10% of the energy
TWO_PI = 2.0 * np.pi

# Absolute threshold of hearing, millibel re 20 uPa, 4 points a third from
# 10 Hz (atrac_psy_common.cpp:33-95).
_FRANK_TAB = np.array([
    9669, 9669, 9626, 9512, 9353, 9113, 8882, 8676,
    8469, 8243, 7997, 7748, 7492, 7239, 7000, 6762,
    6529, 6302, 6084, 5900, 5717, 5534, 5351, 5167,
    5004, 4812, 4638, 4466, 4310, 4173, 4050, 3922,
    3723, 3577, 3451, 3281, 3132, 3036, 2902, 2760,
    2658, 2591, 2441, 2301, 2212, 2125, 2018, 1900,
    1770, 1682, 1594, 1512, 1430, 1341, 1260, 1198,
    1136, 1057, 998, 943, 887, 846, 744, 712,
    693, 668, 637, 606, 580, 555, 529, 502,
    475, 448, 422, 398, 375, 351, 327, 322,
    312, 301, 291, 268, 246, 215, 182, 146,
    107, 61, 13, -35, -96, -156, -179, -235,
    -295, -350, -401, -421, -446, -499, -532, -535,
    -513, -476, -431, -313, -179, 8, 203, 403,
    580, 736, 881, 1022, 1154, 1251, 1348, 1421,
    1479, 1399, 1285, 1193, 1287, 1519, 1914, 2369,
    3352, 4352, 5352, 6352, 7352, 8352, 9352, 9999,
    9999, 9999, 9999, 9999,
], dtype=np.float64)


def _calc_ath(length, sample_rate):
    """ATH in dB a spectral line (atrac_psy_common.cpp:126-140)."""
    f_khz = (np.arange(length, dtype=np.float64) + 1.0) \
        * (sample_rate / 2000.0) / length
    f = np.clip(1.0e3 * f_khz, 10.0, 29853.0)
    freq_log = 40.0 * np.log10(0.1 * f)
    index = freq_log.astype(np.int64)
    frac = freq_log - index
    trh = 0.01 * (_FRANK_TAB[index] * (1.0 - frac)
                  + _FRANK_TAB[index + 1] * frac) - 100.0
    return trh - f_khz * f_khz * 0.015


def _subband_ath():
    """[8] power gates at 0 dB = 32768 (FillSubbandAth,
    at3p_gha.cpp:453-465)."""
    m = _calc_ath(16 * 1024, 44100).reshape(16, 1024).min(axis=1)
    return np.power(10.0, 0.1 * (m[:NUM_TONE_SUBBANDS] + 90.0)).astype(F32)


SUBBAND_ATH = _subband_ath()


def _tables():
    n = np.arange(128)[:, None]
    k = np.arange(1024)[None, :]
    ang = TWO_PI * n * k / 2048.0
    dft = (np.cos(ang).astype(F32), np.sin(ang).astype(F32))
    waves = {}
    for length in (128, 64):
        f = np.arange(1024, dtype=np.int64)[:, None]
        i = np.arange(length, dtype=np.int64)[None, :]
        a = TWO_PI * ((f * i) % 2048) / 2048.0
        waves[length] = (np.cos(a).astype(F32), np.sin(a).astype(F32))
    return dft, waves


(_DFT_C, _DFT_S), _WAVES = _tables()
_BINS = np.arange(1024) >= 1                 # DC out
_I128 = np.arange(128, dtype=np.int32)
_HANN = ((F32(1.0) - np.cos(F32(TWO_PI) * np.arange(256, dtype=F32)
                            / F32(256.0))) * F32(0.5)).astype(F32)
_RISE, _FALL = _HANN[:128], _HANN[128:]
_HQ = ((1.0 - np.cos(TWO_PI * np.arange(256) / 256.0)) * 0.5)[
    [0, 32, 64, 96]].astype(F32)             # the fade's rising quarter


def ladder(sf):
    """2^((sf - 3) / 4) in float32."""
    return np.power(F32(2.0), (sf.astype(F32) - F32(3.0)) / F32(4.0))


def quantize_wave(amp, phi_steps):
    """Amplitude -> 6-bit sf (floor), phase steps -> 5-bit index."""
    lg = np.log2(np.maximum(amp, F32(1e-20)))
    sf = np.clip(np.floor(F32(4.0) * lg + F32(3.0)), 0, 63).astype(np.int32)
    ph = np.round(phi_steps / F32(64.0)).astype(np.int32) & 31
    return sf, ladder(sf), ph


def wave_sum(freq, ph, amp, i_offset, length=128):
    """Sum of a lane's waves over samples [0, length): wave w at sample i
    is amp_w sin(2 pi ((ph_w << 6) + (i + i_offset) f_w) / 2048).
    freq / ph int32, amp f32 [L, W] -> [L, length]."""
    base = np.mod((ph << 6) + i_offset * freq, 2048)
    alpha = F32(TWO_PI / 2048.0) * base.astype(F32)
    lanes = freq.shape[0]
    coef_a = np.zeros((lanes, 1024), F32)
    coef_b = np.zeros((lanes, 1024), F32)
    rows = np.repeat(np.arange(lanes), freq.shape[1])
    np.add.at(coef_a, (rows, freq.ravel()), (amp * np.sin(alpha)).ravel())
    np.add.at(coef_b, (rows, freq.ravel()), (amp * np.cos(alpha)).ravel())
    cos_t, sin_t = _WAVES[length]
    return coef_a @ cos_t + coef_b @ sin_t


def synth_own(freq, ph, sf, valid):
    return wave_sum(freq, ph, np.where(valid, ladder(sf), F32(0.0)), 0)


def greedy(x, fit_mask, max_keep, sb_ath):
    """x [L, 128] f32, fit_mask [L, 128] bool, max_keep [L], sb_ath [L] ->
    freq, sf, ph [L, MAX_WAVES] int32 and valid [L, MAX_WAVES] bool."""
    lanes = x.shape[0]
    x = np.where(fit_mask, x, F32(0.0))
    n_fit = np.maximum(fit_mask.sum(-1), 1).astype(F32)
    freq = np.zeros((lanes, MAX_WAVES), np.int32)
    sf = np.zeros_like(freq)
    ph = np.zeros_like(freq)
    valid = np.zeros((lanes, MAX_WAVES), bool)
    done = np.zeros(lanes, bool)
    max_amp = np.zeros(lanes, F32)
    rows = np.arange(lanes)
    for k in range(MAX_WAVES):
        re = x @ _DFT_C
        im = -(x @ _DFT_S)
        mag2 = np.where(_BINS, re * re + im * im, F32(0.0))
        b = np.argmax(mag2, axis=-1).astype(np.int32)
        re_b, im_b = re[rows, b], im[rows, b]
        amp = F32(2.0) * np.sqrt(re_b * re_b + im_b * im_b) / n_fit
        phi = np.arctan2(im_b, re_b) + F32(np.pi / 2.0)
        phi_steps = np.mod(phi * F32(2048.0 / TWO_PI), F32(2048.0))
        sf_k, amp_q, ph_k = quantize_wave(amp, phi_steps)
        pos = ((ph_k[:, None] << 6) + _I128 * b[:, None]) & 2047
        tone = np.where(fit_mask, amp_q[:, None] * np.sin(
            F32(TWO_PI) * pos.astype(F32) / F32(2048.0)), F32(0.0))
        e_old = np.sum(x * x, axis=-1)
        resid = x - tone
        e_new = np.sum(resid * resid, axis=-1)
        dist = np.where(valid, np.abs(freq - b[:, None]), 1 << 20)
        gates = ((e_new < e_old * ACCEPT_RATIO)
                 & (amp * amp > sb_ath)
                 & (amp > max_amp / F32(10.0))
                 & (dist.min(-1) >= MIN_FREQ_DIST)
                 & (k < max_keep))
        accept = ~done & gates
        done |= ~gates
        x = np.where(accept[:, None], resid, x)
        freq[:, k] = np.where(accept, b, 0)
        sf[:, k] = np.where(accept, sf_k, 0)
        ph[:, k] = np.where(accept, ph_k, 0)
        valid[:, k] = accept
        max_amp = np.where(accept, np.maximum(max_amp, amp), max_amp)
    return freq, sf, ph, valid


def detect_run(x, resid):
    """The first longest run of 4-sample blocks where the input's rms is
    at least the residual's -> (start, end) in samples, (0, 0) if none."""
    ei = np.sqrt(np.sum((x * x).reshape(-1, 32, 4), -1) / F32(4.0))
    eo = np.sqrt(np.sum((resid * resid).reshape(-1, 32, 4), -1) / F32(4.0))
    ok = ei >= eo
    lanes = x.shape[0]
    cur_len = np.zeros(lanes, np.int32)
    cur_start = np.zeros(lanes, np.int32)
    best_len = np.zeros(lanes, np.int32)
    best_start = np.zeros(lanes, np.int32)
    for i in range(32):
        o = ok[:, i]
        cur_start = np.where(o & (cur_len == 0), i, cur_start)
        cur_len = np.where(o, cur_len + 1, 0)
        better = cur_len > best_len
        best_len = np.where(better, cur_len, best_len)
        best_start = np.where(better, cur_start, best_start)
    return best_start * 4, (best_start + best_len) * 4


def analyse(bands):
    """One frame's band samples [C, 16, 128] -> the waves and envelope runs
    of its lanes, before the continuation check (dict)."""
    c = bands.shape[0]
    x = np.ascontiguousarray(bands[:, :NUM_TONE_SUBBANDS]).reshape(-1, 128)
    lanes = x.shape[0]
    sb_ath = np.tile(SUBBAND_ATH, c)
    full = np.ones((lanes, 128), bool)
    cap = np.full(lanes, MAX_WAVES, np.int32)
    freq, sf, ph, valid = greedy(x, full, cap, sb_ath)

    # the frame's 48-tone budget: the strongest waves of all lanes stay
    amp = np.where(valid, ladder(sf), F32(0.0)).reshape(-1)
    order = np.argsort(-amp, kind="stable")
    ranks = np.empty_like(order)
    ranks[order] = np.arange(order.size)
    valid = valid & (ranks < MAX_TOTAL_TONES).reshape(lanes, MAX_WAVES)

    s1, e1 = detect_run(x, x - synth_own(freq, ph, sf, valid))
    has = valid.any(-1)
    reject1 = has & (e1 - s1 < 16)
    truncate = has & ~reject1 & (e1 < 128)
    start, end = s1, np.full(lanes, 128, np.int32)
    reject = reject1
    if truncate.any():
        # refit the truncated lanes on their window (FrameSz = end, Repeat)
        t = np.flatnonzero(truncate)
        fit = np.arange(128)[None, :] < e1[t, None]
        f2, sf2, ph2, v2 = greedy(x[t], fit, valid[t].sum(-1), sb_ath[t])
        freq[t], sf[t], ph[t], valid[t] = f2, sf2, ph2, v2
        s2, e2 = detect_run(x[t], x[t] - synth_own(f2, ph2, sf2, v2))
        reject = reject1 & ~truncate
        reject[t] = v2.any(-1) & (e2 - s2 < 16)
        start, end = start.copy(), end.copy()
        start[t], end[t] = s2, e2
    valid = valid & ~reject[:, None]
    amp_q = np.where(valid, ladder(sf), F32(0.0))
    return {"freq": freq, "sf": sf, "ph": ph, "valid": valid,
            "start": start, "end": end, "channels": c,
            "ext": wave_sum(freq, ph, amp_q, 128, 64)}


def finish(a, next_bands, prev_stop):
    """Analysis ``a`` of frame j, frame j+1's band samples [C, 16, 128]
    (zeros past the track's end) and frame j's predecessor's stop points
    before the stereo merge ([C * 8] bool) -> (the frame's wire planes,
    its own stop points for frame j+1)."""
    c = a["channels"]
    valid = a["valid"]
    has = valid.any(-1)
    nxt = np.ascontiguousarray(
        next_bands[:, :NUM_TONE_SUBBANDS, :64]).reshape(-1, 64)
    diff = nxt - a["ext"]
    cont = np.sum(diff * diff, -1) < np.sum(nxt * nxt, -1)
    end, start = a["end"], a["start"]
    gapless = has & (end == 128) & cont
    env_stop = np.where(has & ~gapless, end // 4 - 1, -1).astype(np.int32)
    stop_present = env_stop >= 0
    start_present = has & ((start > 0) | prev_stop)
    env_start = np.where(start_present, start // 4, -1).astype(np.int32)
    sh = (c, NUM_TONE_SUBBANDS, MAX_WAVES)
    planes = {"freq": a["freq"].reshape(sh), "amp_sf": a["sf"].reshape(sh),
              "phase": a["ph"].reshape(sh), "valid": valid.reshape(sh),
              "env_start": env_start.reshape(sh[:2]),
              "env_stop": env_stop.reshape(sh[:2])}
    return merge_stereo(planes), stop_present


def merge_stereo(p):
    """Leader / follower and tone sharing of one frame's planes."""
    c = p["valid"].shape[0]
    sb = np.arange(NUM_TONE_SUBBANDS)
    if c == 1:
        p["sharing"] = np.zeros(NUM_TONE_SUBBANDS, bool)
        p["leader"] = 0
        return p
    nb_used = np.where(p["valid"].any(-1), sb + 1, 0).max(-1)     # [2]
    leader = int(nb_used[1] > nb_used[0])
    nb = nb_used[leader]
    p["valid"] = p["valid"] & (sb < nb)[None, :, None]
    keys = ("freq", "amp_sf", "phase", "valid", "env_start", "env_stop")
    lead = {k: p[k][leader] for k in keys}
    fol = {k: p[k][1 - leader] for k in keys}
    fol_freq = np.where(fol["valid"], fol["freq"], -1)
    lead_freq = np.where(lead["valid"], lead["freq"], -2)
    match = (fol_freq[:, :, None] == lead_freq[:, None, :]).any(-1)
    covered = np.all(match | ~fol["valid"], axis=-1)
    sharing = covered & fol["valid"].any(-1) & lead["valid"].any(-1)
    out = {}
    for k in keys:
        sel = sharing[:, None] if fol[k].ndim == 2 else sharing
        new_fol = np.where(sel, lead[k], fol[k])
        pair = [None, None]
        pair[leader], pair[1 - leader] = lead[k], new_fol
        out[k] = np.stack(pair)
    out["sharing"] = sharing
    out["leader"] = leader
    return out


def empty_planes(c):
    sh = (c, NUM_TONE_SUBBANDS, MAX_WAVES)
    return {"freq": np.zeros(sh, np.int32), "amp_sf": np.zeros(sh, np.int32),
            "phase": np.zeros(sh, np.int32), "valid": np.zeros(sh, bool),
            "env_start": np.full(sh[:2], -1, np.int32),
            "env_stop": np.full(sh[:2], -1, np.int32),
            "sharing": np.zeros(NUM_TONE_SUBBANDS, bool), "leader": 0}


def _env_mask(has_start, start, has_stop, stop, reg_offset):
    """waves_synth's fade-in / fade-out mask over 128 samples
    (atrac3plusdsp.c:109-135); arguments [C, 8]."""
    i = np.arange(128)

    def hq_at(j):
        return _HQ[np.clip(j, 0, 3)]

    pos = (start << 2) - reg_offset
    fade_in = has_start & (pos > 0) & (pos <= 128)
    edge = ~(has_stop & (start == stop))
    j = i - pos[..., None]
    m_in = np.where(fade_in[..., None],
                    np.where(j < 0, F32(0.0),
                             np.where(edge[..., None] & (j < 4), hq_at(j),
                                      F32(1.0))), F32(1.0))
    pos2 = ((stop + 1) << 2) - reg_offset
    fade_out = has_stop & (pos2 > 0) & (pos2 <= 128)
    k = i - (pos2[..., None] - 4)
    m_out = np.where(fade_out[..., None],
                     np.where(k < 0, F32(1.0),
                              np.where(k < 4, hq_at(3 - k), F32(0.0))),
                     F32(1.0))
    return (m_in * m_out).astype(F32)


def block(prev, cur):
    """Block b's synthesis pieces from its wire planes ``cur`` and block
    b-1's ``prev`` (generate_tones' envelope across two frames)."""
    sp = cur["env_start"] >= 0
    sv = np.where(sp, cur["env_start"], -1)
    tp = cur["env_stop"] >= 0
    tv = np.where(tp, cur["env_stop"], 32)
    sp_p = prev["env_start"] >= 0
    sv_p = np.where(sp_p, prev["env_start"], -1)
    tp_p = prev["env_stop"] >= 0
    tv_p = np.where(tp_p, prev["env_stop"], 32)
    r1 = sp & (sv < tv)
    has_start = r1 | sp_p
    start = np.where(r1, sv + 32, np.where(sp_p, sv_p, 0))
    r2 = tp_p & (tv_p >= start)
    has_stop = r2 | tp
    stop = np.where(r2, tv_p, np.where(tp, tv + 32, 64))

    c = cur["valid"].shape[0]
    lanes = c * NUM_TONE_SUBBANDS
    freq = cur["freq"].reshape(lanes, -1)
    ph = cur["phase"].reshape(lanes, -1)
    amp = np.where(cur["valid"], ladder(cur["amp_sf"]),
                   F32(0.0)).reshape(lanes, -1)
    sh = (c, NUM_TONE_SUBBANDS, 128)
    reg1 = wave_sum(freq, ph, amp, 0).reshape(sh) \
        * _env_mask(has_start, start, has_stop, stop, 128)
    reg2 = wave_sum(freq, ph, amp, -128).reshape(sh) \
        * _env_mask(has_start, start, has_stop, stop, 0)
    nw = cur["valid"].any(-1)
    return {"reg1": reg1, "reg2": reg2, "nw": nw,
            "reg1_nz": nw & ~(stop < 32), "reg2_nz": nw & ~(start >= 32),
            "has_start": has_start, "has_stop": has_stop}


def synth_frame(cur, nxt):
    """Content frame c's tone signal [C, 8, 128] from block c and block
    c+1 (None past the track's end), with generate_tones' crossfade rules
    (atrac3plusdsp.c:190-200)."""
    if nxt is None:
        reg2_nz = np.zeros_like(cur["nw"])
        own = reg2_nz
        r2 = np.zeros_like(cur["reg2"])
    else:
        reg2_nz = nxt["reg2_nz"]
        own = nxt["nw"] & ~nxt["has_start"]
        r2 = np.where(reg2_nz[..., None], nxt["reg2"], F32(0.0))
    both = cur["reg1_nz"] & reg2_nz
    r1_hann = both | (cur["nw"] & ~cur["has_stop"])
    r1 = np.where(cur["reg1_nz"][..., None],
                  np.where(r1_hann[..., None], cur["reg1"] * _FALL,
                           cur["reg1"]), F32(0.0))
    r2 = np.where((both | own)[..., None], r2 * _RISE, r2)
    return r1 + r2
