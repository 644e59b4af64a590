"""ATRAC3 sound-unit serialization: planes <-> fixed-size frames.

Bit layout per channel (reference: src/atrac/at3/atrac3_bitstream.cpp:
WriteSoundUnit :830-918, EncodeSpecs :597-636, CLCEnc/VLCEnc :163-220):

  6 bits: 0x28 channel id (or 14-bit JS params block for JS channel 1)
  2 bits: numQmfBand - 1
  per band: 3 bits num gain points, then (4 level + 5 loc) per point
  tonal section (5-bit count, then groups; empty -> count 0)
  5 bits: numBlocks - 1;  1 bit: coding mode (1 = CLC)
  3 bits x numBlocks: word length ("precision")
  6 bits x used block: scale factor index
  per used block: CLC or VLC coded mantissas
  zero-pad / truncate to halfFrameSz bytes; channels concatenated
  (JS channel 1 byte-reversed; mono duplicates channel 0).
"""
import numpy as np

from portbench.reference.upstream import bitpack
from . import tables as T

_MAXLEN = T.MAX_SPECS_PER_BLOCK           # 128
_N_HEAD = 2                               # id, numQmf
_N_GAIN = 4 * (1 + 8 * 2)                 # per band: count + 8 (level, loc)
# tonal section: tcsgn + mode + up to 21 subgroups x (4 flags + 2 fields +
# 16 window counts) + 21 members x (sfi + rel + 5 VLC values) -> 512 slots
_N_TONAL = 512
_N_BLOCKHDR = 2                           # numBlocks-1, codingMode
_N_FIELDS = _N_HEAD + _N_GAIN + _N_TONAL + _N_BLOCKHDR + 32 + 32 + 32 * _MAXLEN

_SPECS = T.SPECS_PER_BLOCK
_CLC_LEN = T.CLC_LENGTH_TAB


def _vlc_lookup(mant, wl):
    """(code, bits) planes for single-mantissa VLC (wl > 1 lanes)."""
    idx = np.where(mant < 0, -mant * 2, np.where(mant > 0, mant * 2 - 1, 0))
    sel = np.clip(wl - 1, 0, 6)
    return T.VLC_CODE[sel[..., None], idx], T.VLC_BITS[sel[..., None], idx]


def _tonal_section(groups):
    """One frame-channel's tonal groups -> [(value, width), ...] fields.

    groups: list of dicts {bfu, pos, len, sfi, quant, mant[len]} in BFU
    order.  Mirrors GroupTonalComponents + EncodeTonalComponents
    (atrac3_bitstream.cpp:409-595); coding mode is fixed to VLC (:484-487).
    """
    buckets = [[] for _ in range(64)]
    for g in groups:
        buckets[g["quant"] * 8 + g["len"]].append(g)

    # subgroup split per bucket (the 64-line-window limiter walk, :427-449)
    subgroups = []   # (bucket_idx, members)
    for i in range(64):
        ptr = buckets[i]
        cur = 0
        while cur < len(ptr):
            start = cur
            anchor = cur
            limiter = 0
            while True:
                cur += 1
                if cur == len(ptr):
                    break
                if ptr[cur]["pos"] - (ptr[anchor]["pos"] & ~63) < 64:
                    limiter += 1
                else:
                    limiter = 0
                    anchor = cur
                if limiter >= 7:
                    break
            subgroups.append((i, ptr[start:cur]))

    fields = [(len(subgroups), 5)]
    if not subgroups:
        return fields
    fields.append((0, 2))                     # coding mode: all VLC

    for i, members in subgroups:
        quant = i >> 3
        counts = [0] * 16
        for m in members:
            counts[m["pos"] >> 6] += 1
        band_any = [any(counts[4 * b: 4 * b + 4]) for b in range(4)]
        for b in range(4):
            fields.append((int(band_any[b]), 1))
        fields.append(((i & 7) - 1, 3))       # codedValues - 1
        fields.append((quant, 3))
        k = 0
        for j in range(16):
            if not band_any[j >> 2]:
                continue
            fields.append((counts[j], 3))
            for m in members[k: k + counts[j]]:
                fields.append((m["sfi"], 6))
                fields.append((m["pos"] - j * 64, 6))
                for v in m["mant"]:
                    idx = (-v) * 2 if v < 0 else (v * 2 - 1 if v > 0 else 0)
                    code, bits = T.HUFF_TABLES[quant - 1][idx]
                    fields.append((code, bits))
            k += counts[j]
    return fields


def pack_channel(planes) -> tuple:
    """planes (frame-major, one channel) -> (values [N, K], widths [N, K]).

    Expects: num_bfu [N], coding_mode [N] (1=CLC), wordlen [N, 32],
    sfi [N, 32], mant [N, 32, 128], gain_npoints [N, 4],
    gain_levels [N, 4, 8], gain_locs [N, 4, 8], js_channel1 bool.
    """
    num_bfu = np.asarray(planes["num_bfu"], np.int64)
    mode = np.asarray(planes["coding_mode"], np.int64)
    wl = np.asarray(planes["wordlen"], np.int64)
    sfi = np.asarray(planes["sfi"], np.int64)
    mant = np.asarray(planes["mant"], np.int64)
    gnp = np.asarray(planes["gain_npoints"], np.int64)
    glev = np.asarray(planes["gain_levels"], np.int64)
    gloc = np.asarray(planes["gain_locs"], np.int64)
    js1 = bool(planes.get("js_channel1", False))
    n = num_bfu.shape[0]

    values = np.zeros((n, _N_FIELDS), np.uint32)
    widths = np.zeros((n, _N_FIELDS), np.int64)
    pos = 0

    # channel id / JS params (atrac3_bitstream.cpp:848-853, 791-798)
    if js1:
        # WriteJsParams = (0,1)(7,3)(3,2)x4 then (3,2): 14 bits == two fields
        values[:, 0] = (0 << 13) | (7 << 10) | 0b11_11_11_11_11
        widths[:, 0] = 14
    else:
        values[:, 0] = 0x28
        widths[:, 0] = 6
    num_qmf = np.asarray(planes.get("num_qmf", np.full(n, 4)), np.int64)
    values[:, 1] = num_qmf - 1
    widths[:, 1] = 2
    pos = _N_HEAD

    for band in range(4):
        in_band = band < num_qmf
        values[:, pos] = np.where(in_band, gnp[:, band], 0)
        widths[:, pos] = np.where(in_band, 3, 0)
        pos += 1
        for p in range(8):
            active = p < gnp[:, band]
            values[:, pos] = np.where(active, glev[:, band, p], 0)
            widths[:, pos] = np.where(active, 4, 0)
            values[:, pos + 1] = np.where(active, gloc[:, band, p], 0)
            widths[:, pos + 1] = np.where(active, 5, 0)
            pos += 2

    # tonal section (empty -> single 5-bit zero count)
    if "tonal_active" in planes:
        t_act = np.asarray(planes["tonal_active"], bool)
        t_start = np.asarray(planes["tonal_start"], np.int64)
        t_len = np.asarray(planes["tonal_len"], np.int64)
        t_sfi = np.asarray(planes["tonal_sfi"], np.int64)
        t_quant = np.asarray(planes["tonal_quant"], np.int64)
        t_mant = np.asarray(planes["tonal_mant"], np.int64)
        for fi in range(n):
            groups = [
                {"bfu": b, "pos": int(t_start[fi, b]),
                 "len": int(t_len[fi, b]), "sfi": int(t_sfi[fi, b]),
                 "quant": int(t_quant[fi, b]),
                 "mant": t_mant[fi, b, : t_len[fi, b]].tolist()}
                for b in range(32) if t_act[fi, b]]
            fields = _tonal_section(groups)
            assert len(fields) <= _N_TONAL, "tonal field slots exceeded"
            for k, (v, w) in enumerate(fields):
                values[fi, pos + k] = v
                widths[fi, pos + k] = w
    else:
        values[:, pos] = 0
        widths[:, pos] = 5
    pos += _N_TONAL

    values[:, pos] = num_bfu - 1
    widths[:, pos] = 5
    values[:, pos + 1] = mode
    widths[:, pos + 1] = 1
    pos += 2

    in_use = np.arange(32)[None, :] < num_bfu[:, None]
    used = in_use & (wl > 0)

    sl = slice(pos, pos + 32)
    values[:, sl] = wl
    widths[:, sl] = np.where(in_use, 3, 0)
    pos += 32

    sl = slice(pos, pos + 32)
    values[:, sl] = np.where(used, sfi, 0)
    widths[:, sl] = np.where(used, 6, 0)
    pos += 32

    # spectrum: [N, 32, 128] field plane; pair modes use slots 0..63
    spec_v = np.zeros((n, 32, _MAXLEN), np.uint32)
    spec_w = np.zeros((n, 32, _MAXLEN), np.int64)

    line_valid = (np.arange(_MAXLEN)[None, :] < _SPECS[:, None])[None]
    clc_mode = used & (mode == 1)[:, None]
    vlc_mode = used & (mode == 0)[:, None]

    # --- single-mantissa lanes (wl > 1) ---
    single = (wl > 1)[:, :, None] & line_valid
    clc_w = np.where(single & clc_mode[:, :, None], _CLC_LEN[wl][:, :, None], 0)
    clc_v = bitpack.mask_sign(mant, np.maximum(_CLC_LEN[wl][:, :, None], 1))
    vcode, vbits = _vlc_lookup(mant, wl)
    vlc_w = np.where(single & vlc_mode[:, :, None], vbits, 0)

    # --- pair lanes (wl == 1): 64 slots of 4-bit CLC or pair VLC ---
    pair_valid = (np.arange(64)[None, :] < (_SPECS // 2)[:, None])[None]
    a = mant[:, :, 0::2]
    b = mant[:, :, 1::2]
    clcp_v = (T.CLC_RTAB[np.clip(a, -2, 1) + 2] << 2) | \
        T.CLC_RTAB[np.clip(b, -2, 1) + 2]
    pidx = T.VLC_PAIR_RTAB[3 * (np.clip(a, -1, 1) + 1) + (np.clip(b, -1, 1) + 1)]
    vlcp_v = T.VLC_CODE[0, pidx]
    vlcp_w = T.VLC_BITS[0, pidx]

    wl_gt1 = (wl > 1)[:, :, None]
    spec_v = np.where(wl_gt1, np.where(clc_mode[:, :, None], clc_v, vcode), 0)
    spec_w = np.where(wl_gt1, clc_w + vlc_w, 0)
    pair_clc = clc_mode[:, :, None] & (wl == 1)[:, :, None] & pair_valid
    pair_vlc = vlc_mode[:, :, None] & (wl == 1)[:, :, None] & pair_valid
    spec_v[:, :, :64] = np.where(pair_clc, clcp_v,
                                 np.where(pair_vlc, vlcp_v, spec_v[:, :, :64]))
    spec_w[:, :, :64] = np.where(pair_clc, 4,
                                 np.where(pair_vlc, vlcp_w, spec_w[:, :, :64]))

    values[:, pos:] = spec_v.reshape(n, -1)
    widths[:, pos:] = spec_w.reshape(n, -1)
    return values, widths


def _empty_js_channel1(n):
    """Synthetic empty side-channel planes for JS mono input
    (atrac3denc.cpp:843-849: one SCE with 1 QMF band, no blocks)."""
    return {
        "num_bfu": np.ones(n, np.int32),
        "coding_mode": np.ones(n, np.int32),       # CLC (TConfigure default)
        "wordlen": np.zeros((n, 32), np.int32),
        "sfi": np.zeros((n, 32), np.int32),
        "mant": np.zeros((n, 32, _MAXLEN), np.int32),
        "gain_npoints": np.zeros((n, 4), np.int32),
        "gain_levels": np.zeros((n, 4, 8), np.int32),
        "gain_locs": np.zeros((n, 4, 8), np.int32),
        "num_qmf": np.ones(n, np.int32),
        "js_channel1": True,
    }


def pack(planes, frame_bytes: int, js: bool = False) -> np.ndarray:
    """Channel planes dict of [C, F, ...] arrays -> [F, frame_bytes] frames.

    Mono non-JS output duplicates the channel bytes
    (atrac3_bitstream.cpp:909-914); JS channel 1 is byte-reversed into the
    frame tail with the per-frame M/S byte-budget shift (:899-905).
    """
    n_total = planes["num_bfu"].shape[1]
    step = 1024
    if n_total > step:
        # bounded working-set slices: the field planes are ~170 KB/frame
        parts = []
        for a in range(0, n_total, step):
            sl = {k: (v[:, a:a + step] if v.ndim > 1 and k != "ms_shift"
                      else (v[a:a + step] if k in ("ms_shift", "loudness")
                            else v))
                  for k, v in planes.items()}
            parts.append(pack(sl, frame_bytes, js=js))
        return np.concatenate(parts, axis=0)

    c = planes["num_bfu"].shape[0]
    n = planes["num_bfu"].shape[1]
    half = frame_bytes // 2
    slack = 256  # TBitStream can overrun the budget; resize() truncates
    shift = np.asarray(planes.get("ms_shift",
                                  np.zeros(n, np.int32)), np.int64)

    chans = [{k: v[ch] for k, v in planes.items()
              if k not in ("loudness", "ms_shift")} for ch in range(c)]
    if js and c == 1:
        chans.append(_empty_js_channel1(n))
    elif js:
        chans[1]["js_channel1"] = True

    bufs = []
    for p in chans:
        values, widths = pack_channel(p)
        bufs.append(bitpack.pack_frames(values, widths,
                                        frame_bytes + slack)[:, :frame_bytes])

    if not js:
        if c == 1:
            return np.concatenate([bufs[0][:, :half]] * 2, axis=1)
        return np.concatenate([bufs[0][:, :half], bufs[1][:, :half]], axis=1)

    # JS assembly: out[j] = ch0[j] for j < half+shift, else reversed ch1:
    # out[j] = ch1[frame_bytes-1-j]
    j = np.arange(frame_bytes)[None, :]
    boundary = (half + shift)[:, None]
    rows = np.arange(n)[:, None]
    return np.where(j < boundary, bufs[0][rows, j],
                    bufs[1][rows, frame_bytes - 1 - j]).astype(np.uint8)


class BitReader:
    """MSB-first bit reader over one frame (QA parser)."""

    def __init__(self, data: np.ndarray):
        self.bits = np.unpackbits(np.ascontiguousarray(data, np.uint8))
        self.pos = 0

    def read(self, n):
        v = 0
        for _ in range(n):
            v = (v << 1) | int(self.bits[self.pos])
            self.pos += 1
        return v

    def read_signed(self, n):
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v


def _vlc_decode(br, sel):
    """Walk one Huffman code of selector `sel` (1..7)."""
    table = T.HUFF_TABLES[sel - 1]
    code, bits = 0, 0
    lut = {(c, b): i for i, (c, b) in enumerate(table)}
    while bits < 10:
        code = (code << 1) | br.read(1)
        bits += 1
        if (code, bits) in lut:
            return lut[(code, bits)]
    raise ValueError("bad VLC code")


def unpack_channel(data: np.ndarray, js1: bool = False):
    """Parse one channel's bytes -> plane dict (QA/golden-test parser)."""
    br = BitReader(data)
    if js1:
        assert br.read(1) == 0
        assert br.read(3) == 7
        for _ in range(5):
            br.read(2)
    else:
        assert br.read(6) == 0x28, "bad channel id"
    num_qmf = br.read(2) + 1
    gain = []
    for _ in range(num_qmf):
        npts = br.read(3)
        gain.append([(br.read(4), br.read(5)) for _ in range(npts)])

    tcsgn = br.read(5)
    tonal = []
    if tcsgn:
        coding_mode_tc = br.read(2)
        for _ in range(tcsgn):
            band_flags = [br.read(1) for _ in range(num_qmf)]
            coded_values = br.read(3) + 1
            quant = br.read(3)
            for j in range(4 * num_qmf):
                if not band_flags[j >> 2]:
                    continue
                ncomp = br.read(3)
                for _ in range(ncomp):
                    sf = br.read(6)
                    rel = br.read(6)
                    mants = []
                    for _ in range(coded_values):
                        if coding_mode_tc == 1:
                            nb = int(T.CLC_LENGTH_TAB[quant])
                            mants.append(br.read_signed(nb))
                        else:
                            idx = _vlc_decode(br, quant)
                            m = (idx + 1) // 2
                            mants.append(-m if idx % 2 == 0 and idx else m)
                    tonal.append({"pos": j * 64 + rel, "sfi": sf,
                                  "quant": quant, "mant": mants})

    num_blocks = br.read(5) + 1
    mode = br.read(1)
    wl = np.zeros(32, np.int32)
    sfi = np.zeros(32, np.int32)
    mant = np.zeros((32, _MAXLEN), np.int32)
    for i in range(num_blocks):
        wl[i] = br.read(3)
    for i in range(num_blocks):
        if wl[i]:
            sfi[i] = br.read(6)
    for i in range(num_blocks):
        if not wl[i]:
            continue
        size = int(_SPECS[i])
        if mode == 1:                      # CLC
            nb = int(_CLC_LEN[wl[i]])
            if wl[i] > 1:
                for k in range(size):
                    mant[i, k] = br.read_signed(nb)
            else:
                for k in range(size // 2):
                    code = br.read(4)
                    # CLC_RTAB maps m in [-2..1] -> idx {2,3,0,1};
                    # inverse: idx -> m
                    inv = {2: -2, 3: -1, 0: 0, 1: 1}
                    mant[i, 2 * k] = inv[code >> 2]
                    mant[i, 2 * k + 1] = inv[code & 3]
        else:                              # VLC
            if wl[i] > 1:
                for k in range(size):
                    idx = _vlc_decode(br, int(wl[i]))
                    m = (idx + 1) // 2
                    mant[i, k] = -m if idx and idx % 2 == 0 else m
            else:
                # pair VLC: inverse of VLC_PAIR_RTAB
                inv = np.argsort(T.VLC_PAIR_RTAB)
                for k in range(size // 2):
                    idx = _vlc_decode(br, 1)
                    packed = int(inv[idx])
                    mant[i, 2 * k] = packed // 3 - 1
                    mant[i, 2 * k + 1] = packed % 3 - 1
    return {
        "num_bfu": num_blocks, "coding_mode": mode, "wordlen": wl,
        "sfi": sfi, "mant": mant, "gain": gain, "tonal": tonal,
        "bits_used": br.pos,
    }


def unpack(frames: np.ndarray, channels: int, js: bool = False):
    """[N, frame_bytes] frames -> list of per-channel plane dict lists."""
    frames = np.ascontiguousarray(frames, np.uint8)
    half = frames.shape[1] // 2
    out = []
    for fr in frames:
        chans = [unpack_channel(fr[:half] if not js else fr)]
        if channels == 2 or js:
            # the JS side channel reads backwards from the frame end; the
            # M/S byte boundary is implicit, so hand it the whole frame
            second = fr[::-1] if js else fr[half:]
            chans.append(unpack_channel(second, js1=js))
        out.append(chans)
    return out
