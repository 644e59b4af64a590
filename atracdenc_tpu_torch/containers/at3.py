"""RIFF/WAVE containers for ATRAC3 (.at3/.wav) and ATRAC3+ streams.

Byte layout mirrors the reference writer (reference: src/at3.cpp:60-320):
ATRAC3 uses format tag 0x270 with a 14-byte extradata block; ATRAC3+ uses
WAVE_FORMAT_EXTENSIBLE (0xFFFE) with the ATRAC3+ subformat GUID.  Both carry
a "fact" chunk with total samples.  Since we know the frame count up front,
no back-fill pass is needed (the reference patches sizes in its destructor
because its stream length is only known at close, at3.cpp:222-234).
"""
import struct

import numpy as np

AT3_SAMPLES_PER_FRAME = 1024
AT3P_SAMPLES_PER_FRAME = 2048
_AT3P_GUID = bytes([0xBF, 0xAA, 0x23, 0xE9, 0x58, 0xCB, 0x71, 0x44,
                    0xA1, 0x19, 0xFF, 0xFA, 0x01, 0xE4, 0xCE, 0x62])


def write_at3(path, frames: np.ndarray, frame_size, joint_stereo=False,
              channels=2):
    n = frames.shape[0]
    data_size = n * frame_size
    header = b"".join([
        b"RIFF", struct.pack("<I", 76 + data_size - 8), b"WAVE",
        b"fmt ", struct.pack("<I", 18 + 14),
        struct.pack("<HHIIHHH", 0x270, channels, 44100,
                    frame_size * 44100 // AT3_SAMPLES_PER_FRAME,
                    frame_size, 0, 14),
        struct.pack("<HIHHHH", 1, 0x1000,
                    1 if joint_stereo else 0, 1 if joint_stereo else 0, 1, 0),
        b"fact", struct.pack("<III", 8, n * AT3_SAMPLES_PER_FRAME,
                             AT3_SAMPLES_PER_FRAME),
        b"data", struct.pack("<I", data_size),
    ])
    assert len(header) == 76
    with open(path, "wb") as fp:
        fp.write(header)
        fp.write(np.ascontiguousarray(frames, np.uint8).tobytes())


def read(path):
    """RIFF/WAVE ATRAC3 or ATRAC3+ -> (frames [N, frame_size] uint8, info).

    info: {"codec": "atrac3"|"atrac3plus", "channels", "frame_size",
    "joint_stereo", "total_samples" (0 if no fact chunk)}.
    New capability — the reference only WRITES this container (its decoder
    is ATRAC1-only, src/main.cpp:649-655)."""
    with open(path, "rb") as fp:
        riff = fp.read(12)
        if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError("not a RIFF/WAVE file")
        fmt = None
        total_samples = 0
        data = None
        while True:
            hdr = fp.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            body = fp.read(size + (size & 1))[:size]
            if cid == b"fmt ":
                fmt = body
            elif cid == b"fact" and len(body) >= 4:
                total_samples = struct.unpack("<I", body[:4])[0]
            elif cid == b"data":
                data = body
    if fmt is None or data is None:
        raise ValueError("RIFF file lacks fmt/data chunks")
    tag, channels, _rate, _bps, block_align = struct.unpack("<HHIIH",
                                                            fmt[:14])
    if tag == 0x270:
        ext = fmt[18:]
        js = bool(struct.unpack("<H", ext[6:8])[0]) if len(ext) >= 8 else False
        info = {"codec": "atrac3", "channels": channels,
                "frame_size": block_align, "joint_stereo": js,
                "total_samples": total_samples}
    elif tag == 0xFFFE and fmt[24:40] == _AT3P_GUID:
        info = {"codec": "atrac3plus", "channels": channels,
                "frame_size": block_align, "joint_stereo": False,
                "total_samples": total_samples}
    else:
        raise ValueError(f"unsupported WAVE format tag 0x{tag:x}")
    fs = info["frame_size"]
    n = len(data) // fs
    frames = np.frombuffer(data[: n * fs], np.uint8).reshape(n, fs)
    return frames, info


def write_at3p(path, frames: np.ndarray, frame_size, channels=2):
    n = frames.shape[0]
    data_size = n * frame_size
    channel_mask = 0x4 if channels == 1 else 0x3
    header = b"".join([
        b"RIFF", struct.pack("<I", 80 + data_size - 8), b"WAVE",
        b"fmt ", struct.pack("<I", 18 + 22),
        struct.pack("<HHIIHHH", 0xFFFE, channels, 44100,
                    frame_size * 44100 // AT3P_SAMPLES_PER_FRAME,
                    frame_size, 16, 22),
        struct.pack("<HI", 16, channel_mask), _AT3P_GUID,
        b"fact", struct.pack("<II", 4, n * AT3P_SAMPLES_PER_FRAME),
        b"data", struct.pack("<I", data_size),
    ])
    assert len(header) == 80
    with open(path, "wb") as fp:
        fp.write(header)
        fp.write(np.ascontiguousarray(frames, np.uint8).tobytes())
