"""ATRAC3+ frame serialization: planes <-> fixed 2048-byte frames.

Bit layout (reference: src/atrac/at3p/at3p_bitstream.cpp): 1 start bit,
2-bit channel block type, then numQU-1 (5) + mute (1), the wordlen section
(VLC-coded deltas of the fixed allocation table), scale-factor indices
(6 bits), the code-table section, per-QU VLC spectra with sign bits, the
power-compensation stubs, window-shape/gain flags, the (optional) tonal
block, noise flag and terminator; zero-padded to 2048 bytes.
"""
import numpy as np

from portbench.reference.upstream import bitpack
from . import tables as T


def _wl_fields(num_qu: int):
    """ch0 wordlen section fields for the fixed allocation table."""
    wl = T.FIXED_WORDLEN[:num_qu]
    deltas = np.diff(wl)
    max_d = int(np.abs(deltas).max(initial=0))
    rng = (2, 3) if max_d >= 3 else ((1, 1) if max_d == 2 else (0, 0))
    best = min(range(rng[0], rng[1] + 1),
               key=lambda i: T.WL_LEN[i][deltas & 7].sum())
    fields = [(3, 2), (0, 2), (0, 2), (best, 2), (int(wl[0]), 3)]
    for d in deltas & 7:
        fields.append((int(T.WL_CODE[best, d]), int(T.WL_LEN[best, d])))
    return fields


def _wl_fields_ch1(num_qu: int):
    """inter-channel wordlen deltas (all zero: both use the fixed table)."""
    fields = [(1, 2), (0, 2), (0, 2)]
    for _ in range(num_qu):
        fields.append((int(T.WL_CODE[0, 0]), int(T.WL_LEN[0, 0])))
    return fields


def _qu_spectra_fields(mant, qu, tab_family):
    """One QU's spectrum fields (EncodeQuSpectra)."""
    tab_idx = 7 * tab_family + int(T.FIXED_WORDLEN[qu]) - 1
    gs, nc, bits, signed = (int(x) for x in T.SPECTRA_TABS[tab_idx])
    ln = int(T.SPECS_PER_BLOCK[qu])
    fields = []
    pos = 0
    while pos < ln:
        if gs != 1:
            fields.append((1, 1))
        for _ in range(gs):
            val = 0
            signs = []
            for i in range(nc):
                t = int(mant[pos])
                pos += 1
                if not signed and t != 0:
                    signs.append(0 if t > 0 else 1)
                    t = abs(t)
                else:
                    t = t & ((1 << bits) - 1)
                val |= t << (bits * i)
            fields.append((int(T.SPEC_CODE[tab_idx, val]),
                           int(T.SPEC_LEN[tab_idx, val])))
            for s in signs:
                fields.append((s, 1))
    return fields


def pack(planes, channels: int) -> np.ndarray:
    """planes (from encoder.encode_track) -> [F, 2048] uint8 frames."""
    num_qu = planes["num_qu"]
    sfi = planes["sfi"]
    mant = planes["mant"]
    spec_tab = planes["spec_tab"]
    tones = planes.get("tones")
    n = num_qu.shape[0]

    frames = np.zeros((n, T.FRAME_BYTES), np.uint8)
    for fi in range(n):
        nq = int(num_qu[fi])
        fields = [(0, 1), (channels - 1, 2), (nq - 1, 5), (0, 1)]
        fields += _wl_fields(nq)
        if channels == 2:
            fields += _wl_fields_ch1(nq)
        for ch in range(channels):
            fields.append((0, 2))
            for qu in range(nq):
                fields.append((int(sfi[ch, fi, qu]), 6))
        # code-table section (EncodeCodeTab, useFullTable=1)
        fields.append((1, 1))
        for ch in range(channels):
            fields += [(0, 1), (0, 2), (0, 1)]
            for qu in range(nq):
                fields.append((int(spec_tab[ch, fi, qu]), 3))
        # spectra + power stubs
        for ch in range(channels):
            for qu in range(nq):
                fields += _qu_spectra_fields(
                    mant[ch, fi, qu], qu, int(spec_tab[ch, fi, qu]))
            npwr = int(T.SUBBAND_TO_NUM_POWGRPS[T.QU_TO_SUBBAND[nq - 1]])
            fields += [(15, 4)] * npwr
        # window shapes (all sine), gain comp, tonal, noise, terminator
        if channels == 2:
            fields.append((0, 2))
        fields += [(0, 1)] * channels            # sine windows
        fields += [(0, 1)] * channels            # gain comp
        nb = 0
        if tones is not None:
            active = tones["valid"][:, fi].any(-1).any(0)
            nb = int(np.where(active, np.arange(8) + 1, 0).max())
        if nb:
            fields.append((1, 1))
            fields += tonal_block_fields(tones, fi, channels, nb)
        else:
            fields.append((0, 1))                # no tonal block
        fields += [(0, 1), (3, 2)]               # no noise, terminator

        values = np.array([v for v, _ in fields], np.uint32)[None]
        widths = np.array([w for _, w in fields], np.int64)[None]
        frames[fi] = bitpack.pack_frames(values, widths, T.FRAME_BYTES)[0]
    return frames


class BitReader:
    """MSB-first reads from one frame, held as one integer; a read past the
    frame's end raises ValueError."""

    def __init__(self, data):
        data = np.ascontiguousarray(data, np.uint8)
        self.size = data.size * 8
        self.word = int.from_bytes(data.tobytes(), "big")
        self.pos = 0

    def peek(self, n):
        """The next n bits (zeros past the frame's end)."""
        shift = self.size - self.pos - n
        word = self.word >> shift if shift >= 0 else self.word << -shift
        return word & ((1 << n) - 1)

    def read(self, n):
        if self.pos + n > self.size:
            raise ValueError("read past the frame's end")
        v = self.peek(n)
        self.pos += n
        return v


_VLC_LUTS = {}


def _vlc_lut(codes, lens):
    """(symbol, length) of every value of the next max(lens) bits."""
    key = (np.asarray(codes).tobytes(), np.asarray(lens).tobytes())
    lut = _VLC_LUTS.get(key)
    if lut is None:
        top = int(max(lens))
        sym = np.full(1 << top, -1, np.int64)
        ln = np.zeros(1 << top, np.int64)
        for i, (c, n) in enumerate(zip(codes, lens)):
            if n > 0:
                lo = int(c) << (top - int(n))
                sym[lo:lo + (1 << (top - int(n)))] = i
                ln[lo:lo + (1 << (top - int(n)))] = n
        lut = _VLC_LUTS[key] = (top, sym.tolist(), ln.tolist())
    return lut


def _read_vlc(br, codes, lens):
    top, sym, ln = _vlc_lut(codes, lens)
    v = br.peek(top)
    if sym[v] < 0:
        raise ValueError("bad VLC")
    br.read(ln[v])
    return sym[v]


def unpack_frame(data: np.ndarray, channels: int):
    """QA parser for one frame -> plane dict."""
    br = BitReader(data)
    assert br.read(1) == 0
    assert br.read(2) == channels - 1
    nq = br.read(5) + 1
    mute = br.read(1)
    assert mute == 0

    wl = np.zeros((channels, 32), np.int32)
    mode = br.read(2)
    assert mode == 3
    br.read(2)  # weights
    br.read(2)  # num coded vals
    tab = br.read(2)
    wl[0, 0] = br.read(3)
    for i in range(1, nq):
        d = _read_vlc(br, T.WL_CODE[tab], T.WL_LEN[tab])
        d = d - 8 if d >= 4 else d
        wl[0, i] = wl[0, i - 1] + d
    if channels == 2:
        assert br.read(2) == 1
        br.read(2)
        tab = br.read(2)
        for i in range(nq):
            d = _read_vlc(br, T.WL_CODE[tab], T.WL_LEN[tab])
            d = d - 8 if d >= 4 else d
            wl[1, i] = wl[0, i] + d

    sfi = np.zeros((channels, 32), np.int32)
    for ch in range(channels):
        assert br.read(2) == 0
        for i in range(nq):
            sfi[ch, i] = br.read(6)

    spec_tab = np.zeros((channels, 32), np.int32)
    full = br.read(1)
    for ch in range(channels):
        br.read(1)
        assert br.read(2) == 0
        br.read(1)
        for i in range(nq):
            spec_tab[ch, i] = br.read(full + 2)

    mant = np.zeros((channels, 32, 128), np.int32)
    for ch in range(channels):
        for qu in range(nq):
            tab_idx = 7 * spec_tab[ch, qu] + wl[ch, qu] - 1
            gs, nc, bits, signed = (int(x) for x in T.SPECTRA_TABS[tab_idx])
            ln = int(T.SPECS_PER_BLOCK[qu])
            pos = 0
            while pos < ln:
                if gs != 1:
                    assert br.read(1) == 1
                for _ in range(gs):
                    val = _read_vlc(br, T.SPEC_CODE[tab_idx],
                                    T.SPEC_LEN[tab_idx])
                    vals = [(val >> (bits * i)) & ((1 << bits) - 1)
                            for i in range(nc)]
                    if signed:
                        half = 1 << (bits - 1)
                        vals = [v - (1 << bits) if v >= half else v
                                for v in vals]
                        for v in vals:
                            mant[ch, qu, pos] = v
                            pos += 1
                    else:
                        for v in vals:
                            if v != 0 and br.read(1):
                                v = -v
                            mant[ch, qu, pos] = v
                            pos += 1
        npwr = int(T.SUBBAND_TO_NUM_POWGRPS[T.QU_TO_SUBBAND[nq - 1]])
        for _ in range(npwr):
            assert br.read(4) == 15

    # trailing channel-unit data: windows, gain, tonal block, noise, term
    if channels == 2:
        assert br.read(2) == 0                   # swap/negate
    for ch in range(channels):
        if br.read(1):                           # window shape flags
            if br.read(1):
                sbn = int(T.QU_TO_SUBBAND[nq - 1]) + 1
                for _ in range(sbn):
                    br.read(1)
    for ch in range(channels):
        assert br.read(1) == 0                   # gain comp
    tones = None
    if br.read(1):
        tones = _parse_tonal_block(br, channels)
    assert br.read(1) == 0                       # noise
    assert br.read(2) == 3                       # terminator
    return {"num_qu": nq, "wordlen": wl, "sfi": sfi, "mant": mant,
            "spec_tab": spec_tab, "tones": tones, "bits_used": br.pos}


def _read_subband_flags(br, n):
    """Inverse of WriteSubbandFlags."""
    if br.read(1) == 0:
        return [False] * n
    if br.read(1) == 0:
        return [True] * n
    return [bool(br.read(1)) for _ in range(n)]


def _parse_tonal_block(br, channels):
    """Inverse of tonal_block_fields (QA parser).  Returns wire-effective
    physical-channel planes: shared subbands duplicated to the follower,
    SecondIsLeader unswapped (mirrors ApplyFilter, at3p_gha.cpp:655-666)."""
    assert br.read(1) == 1                       # amplitude mode 1
    nb = _read_vlc(br, T.TONE_BANDS_CODE, T.TONE_BANDS_LEN) + 1
    sharing = [False] * 8
    second_is_leader = False
    if channels == 2:
        sharing[:nb] = _read_subband_flags(br, nb)
        second_is_leader = _read_subband_flags(br, 1)[0]
        assert br.read(1) == 0                   # no phase inversion
    out = {"freq": np.zeros((channels, 8, 15), np.int32),
           "amp_sf": np.zeros((channels, 8, 15), np.int32),
           "phase": np.zeros((channels, 8, 15), np.int32),
           "valid": np.zeros((channels, 8, 15), bool),
           "env_start": np.full((channels, 8), -1, np.int32),
           "env_stop": np.full((channels, 8), -1, np.int32),
           "sharing": np.array(sharing, bool),
           "leader": np.int32(1 if second_is_leader else 0)}
    for wch in range(channels):
        coded = [sb for sb in range(nb)
                 if not (wch == 1 and sharing[sb])]
        if wch:
            assert br.read(1) == 0               # own envelope data
        for sb in coded:
            if br.read(1):
                out["env_start"][wch, sb] = br.read(5)
            if br.read(1):
                out["env_stop"][wch, sb] = br.read(5)
        assert br.read(wch + 1) == 0             # num-waves mode
        nw = {sb: br.read(4) for sb in coded}
        if wch:
            assert br.read(1) == 0               # freqs independent
        for sb in coded:
            if nw[sb] == 0:
                continue
            order = br.read(1) if nw[sb] > 1 else 0
            freqs = [br.read(10)]
            if order == 0:                       # ascending
                for _ in range(1, nw[sb]):
                    prev = freqs[-1]
                    if prev < 512:
                        freqs.append(br.read(10))
                    else:
                        b = _fsb(1023 - prev) + 1
                        freqs.append(br.read(b) + (1024 - (1 << b)))
            else:                                # descending
                for _ in range(1, nw[sb]):
                    prev = freqs[-1]
                    b = _fsb(prev) + 1
                    freqs.append(br.read(b))
                freqs = freqs[::-1]
            for w, fq in enumerate(freqs):
                out["freq"][wch, sb, w] = fq
                out["valid"][wch, sb, w] = True
        assert br.read(wch + 1) == 0             # amplitude mode
        for sb in coded:
            for w in range(nw[sb]):
                out["amp_sf"][wch, sb, w] = br.read(6)
        for sb in coded:
            for w in range(nw[sb]):
                out["phase"][wch, sb, w] = br.read(5)
    if channels == 2:
        for k in ("freq", "amp_sf", "phase", "valid"):
            for sb in range(nb):
                if sharing[sb]:
                    out[k][1, sb] = out[k][0, sb]
        for k in ("env_start", "env_stop"):
            for sb in range(nb):
                if sharing[sb]:
                    out[k][1, sb] = out[k][0, sb]
        if second_is_leader:
            for k in ("freq", "amp_sf", "phase", "valid",
                      "env_start", "env_stop"):
                out[k] = out[k][::-1].copy()
    return out


# --- tonal block (WriteTonalBlock, at3p_bitstream.cpp:366-520) --------------

def _fsb(x: int) -> int:
    """Position of the highest set bit; 0 for input 0 (util.h:65-76)."""
    return max(x.bit_length() - 1, 0)


def create_freq_bit_pack(freqs):
    """Frequency packing, ascending vs descending order by total bits
    (CreateFreqBitPack, at3p_bitstream.cpp:41-94).  `freqs` ascending."""
    n = len(freqs)
    asc = [(freqs[0] & 1023, 10)]
    bits_asc = 10
    prev = freqs[0] & 1023
    for i in range(1, n):
        cur = freqs[i] & 1023
        if prev < 512:
            asc.append((cur, 10))
            bits_asc += 10
        else:
            b = _fsb(1023 - prev) + 1
            asc.append((cur - (1024 - (1 << b)), b))
            bits_asc += b
        prev = cur
    if n == 1:
        return asc, 0
    desc = [(freqs[-1] & 1023, 10)]
    bits_desc = 10
    prev = freqs[-1] & 1023
    for i in range(n - 2, -1, -1):
        cur = freqs[i] & 1023
        b = _fsb(prev) + 1
        desc.append((cur, b))
        bits_desc += b
        prev = cur
    if bits_asc < bits_desc:
        return asc, 0
    return desc, 1


def _subband_flags_fields(flags):
    """WriteSubbandFlags (at3p_bitstream.cpp:487-508)."""
    s = sum(1 for x in flags if x)
    if s == 0:
        return [(0, 1)]
    if s == len(flags):
        return [(1, 1), (0, 1)]
    return [(1, 1), (1, 1)] + [(int(bool(x)), 1) for x in flags]


def tonal_block_fields(tones, fi, channels, nb):
    """One frame's tonal-block fields [(value, width), ...]; `tones` planes
    are frequency-sorted and wire-effective (shared subbands already carry
    the leader's data in both channels), `nb` = NumToneBands >= 1.
    (WriteTonalBlock, at3p_bitstream.cpp:509-629.)"""
    fields = [(1, 1)]                                 # GHA amplitude mode 1
    fields.append((int(T.TONE_BANDS_CODE[nb - 1]),
                   int(T.TONE_BANDS_LEN[nb - 1])))
    leader = int(tones.get("leader", np.zeros(1, np.int32))[fi]) \
        if channels == 2 else 0
    sharing = [bool(tones["sharing"][fi, sb]) for sb in range(nb)] \
        if (channels == 2 and "sharing" in tones) else [False] * nb
    if channels == 2:
        fields += _subband_flags_fields(sharing)
        fields += _subband_flags_fields([leader == 1])
        fields.append((0, 1))                         # no phase inversion
    env_start = tones.get("env_start")
    env_stop = tones.get("env_stop")
    for wch in range(channels):
        ch = leader if wch == 0 else 1 - leader       # wire ch0 = leader
        skip = (lambda sb: wch == 1 and sharing[sb])
        if wch:
            fields.append((0, 1))                     # own envelope data
        for sb in range(nb):
            if skip(sb):
                continue
            es = int(env_start[ch, fi, sb]) if env_start is not None else -1
            et = int(env_stop[ch, fi, sb]) if env_stop is not None else -1
            if es >= 0:
                fields += [(1, 1), (es, 5)]
            else:
                fields.append((0, 1))
            if et >= 0:
                fields += [(1, 1), (et, 5)]
            else:
                fields.append((0, 1))
        fields.append((0, wch + 1))                   # num-waves mode
        nw = [int(tones["valid"][ch, fi, sb].sum()) for sb in range(nb)]
        for sb in range(nb):
            if not skip(sb):
                fields.append((nw[sb], 4))
        if wch:
            fields.append((0, 1))                     # freqs independent
        for sb in range(nb):
            if skip(sb) or nw[sb] == 0:
                continue
            freqs = [int(x) for x in
                     tones["freq"][ch, fi, sb][tones["valid"][ch, fi, sb]]]
            pack, order = create_freq_bit_pack(freqs)
            if nw[sb] > 1:
                fields.append((order, 1))
            fields += pack
        fields.append((0, wch + 1))                   # amplitude mode
        for sb in range(nb):
            if skip(sb):
                continue
            sfs = tones["amp_sf"][ch, fi, sb][tones["valid"][ch, fi, sb]]
            for v in sfs:
                fields.append((int(v), 6))
        for sb in range(nb):
            if skip(sb):
                continue
            phs = tones["phase"][ch, fi, sb][tones["valid"][ch, fi, sb]]
            for v in phs:
                fields.append((int(v), 5))
    return fields
