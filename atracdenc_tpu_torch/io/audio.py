"""Multi-format PCM I/O (WAV / AIFF / AU / headerless RAW), stdlib-only.

Mirrors the reference's libsndfile usage (src/pcm_io_sndfile.cpp): READS
auto-detect the container by content magic (libsndfile ignores the
extension on open-for-read); WRITES pick the format from the output
extension per fileext_to_libsndfmt (:26-41) — `.au` -> AU, `.aiff` -> AIFF,
`.pcm`/`.raw` -> headerless, anything else WAV — and stdout (`-`) is AU
(:28-29, a streamable format, since WAV needs a seekable header).

All formats are 16-bit PCM (SF_FORMAT_PCM_16); AIFF/AU are big-endian by
specification, WAV/RAW little-endian.  Values normalize by 1/32768 on read
and scale by 32768 with clipping on write, like io/wav.py.
"""
import io
import struct
import sys

import numpy as np

from . import wav as _wav


def _read_stream(data: bytes):
    """(pcm [C, T] float32, rate) from a byte stream, by content magic."""
    magic = data[:4]
    if magic == b"RIFF":
        import wave
        with wave.open(io.BytesIO(data), "rb") as fp:
            if fp.getsampwidth() != 2:
                raise ValueError("Only 16-bit PCM input is supported")
            ch, rate = fp.getnchannels(), fp.getframerate()
            raw = fp.readframes(fp.getnframes())
        pcm = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
        return pcm.reshape(-1, ch).T.copy(), rate
    if magic == b"FORM":
        return _read_aiff(data)
    if magic == b".snd":
        return _read_au(data)
    raise ValueError("Unrecognized audio input (expected WAV, AIFF or AU)")


def read(path: str):
    """Returns (pcm [C, T] float32 in [-1, 1), sample_rate).

    Format is detected from content, never the extension (reference reads
    via libsndfile auto-detect, pcm_io_sndfile.cpp:45-52)."""
    if path == "-":
        return _read_stream(sys.stdin.buffer.read())
    with open(path, "rb") as f:
        return _read_stream(f.read())


def write(path: str, pcm: np.ndarray, sample_rate: int = 44100) -> None:
    """pcm [C, T] float in [-1, 1]; format from the output extension."""
    fmt = _ext_format(path)
    if fmt == "wav":
        return _wav.write(path, pcm, sample_rate)
    pcm = np.atleast_2d(pcm)
    ints = np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype(np.int16)
    inter = ints.T.reshape(-1)                       # interleaved frames
    if fmt == "raw":
        payload = inter.astype("<i2").tobytes()
    elif fmt == "au":
        payload = _au_bytes(inter, pcm.shape[0], sample_rate)
    else:
        payload = _aiff_bytes(inter, pcm.shape[0], sample_rate)
    if path == "-":
        sys.stdout.buffer.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def _ext_format(path: str) -> str:
    if path == "-":
        return "au"                                  # pcm_io_sndfile.cpp:28
    dot = path.rfind(".")
    ext = path[dot + 1:].upper() if 0 <= dot < len(path) - 1 else ""
    if ext == "AU":
        return "au"
    if ext == "AIFF":
        return "aiff"
    if ext in ("PCM", "RAW"):
        return "raw"
    return "wav"


# ---- AU (Sun audio): trivial big-endian header + PCM16BE ----------------

def _au_bytes(inter: np.ndarray, channels: int, rate: int) -> bytes:
    data = inter.astype(">i2").tobytes()
    hdr = struct.pack(">4sIIIII", b".snd", 24, len(data), 3, rate, channels)
    return hdr + data


def _read_au(data: bytes):
    magic, off, size, enc, rate, ch = struct.unpack(">4sIIIII", data[:24])
    if enc != 3:
        raise ValueError("Only 16-bit linear PCM AU input is supported")
    if size in (0, 0xFFFFFFFF):                      # unknown length
        size = len(data) - off
    raw = data[off:off + size]
    pcm = np.frombuffer(raw[: len(raw) // (2 * ch) * 2 * ch], ">i2")
    return (pcm.astype(np.float32) / 32768.0).reshape(-1, ch).T.copy(), rate


# ---- AIFF: FORM/COMM/SSND chunks, PCM16BE, 80-bit-float rate ------------

def _f80(rate: int) -> bytes:
    """IEEE 754 extended 80-bit float encoding of a positive integer."""
    if rate == 0:
        return b"\x00" * 10
    exp = rate.bit_length() - 1
    mant = rate << (63 - exp)
    return struct.pack(">HQ", 16383 + exp, mant)


def _f80_to_int(b: bytes) -> int:
    se, mant = struct.unpack(">HQ", b)
    exp = (se & 0x7FFF) - 16383
    return int(round(mant / (1 << (63 - exp)))) if mant else 0


def _aiff_bytes(inter: np.ndarray, channels: int, rate: int) -> bytes:
    data = inter.astype(">i2").tobytes()
    nframes = len(inter) // channels
    comm = struct.pack(">hIh", channels, nframes, 16) + _f80(rate)
    ssnd = struct.pack(">II", 0, 0) + data
    body = (b"AIFF"
            + b"COMM" + struct.pack(">I", len(comm)) + comm
            + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd
            + (b"\x00" if len(ssnd) & 1 else b""))
    return b"FORM" + struct.pack(">I", len(body)) + body


def _read_aiff(data: bytes):
    if data[8:12] != b"AIFF":
        raise ValueError("Only uncompressed AIFF input is supported")
    pos, end = 12, 8 + struct.unpack(">I", data[4:8])[0]
    comm = ssnd = None
    while pos + 8 <= min(end, len(data)):
        cid = data[pos:pos + 4]
        ln = struct.unpack(">I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + ln]
        if cid == b"COMM":
            comm = body
        elif cid == b"SSND":
            ssnd = body
        pos += 8 + ln + (ln & 1)                     # chunks are word-aligned
    if comm is None or ssnd is None:
        raise ValueError("AIFF missing COMM or SSND chunk")
    ch, nframes, bits = struct.unpack(">hIh", comm[:8])
    if bits != 16:
        raise ValueError("Only 16-bit PCM AIFF input is supported")
    rate = _f80_to_int(comm[8:18])
    off = struct.unpack(">I", ssnd[:4])[0]
    raw = ssnd[8 + off:8 + off + nframes * ch * 2]
    pcm = np.frombuffer(raw, ">i2").astype(np.float32) / 32768.0
    return pcm.reshape(-1, ch).T.copy(), rate
