"""Sony OpenMG (OMA / EA3) container.

Format (reference: src/lib/liboma/src/liboma.c:205-236): 96-byte header —
"EA3" magic, version byte 1, header size 96, encryption markers 0xFF 0xFF,
big-endian codec params word at offset 32 — followed by fixed-size frames.
  ATRAC3 params:  (0 << 24) | (js << 17) | (sr_idx << 13) | framesize/8
  ATRAC3+ params: (1 << 24) | (sr_idx << 13) | ((ch_id+1) << 10) | (framesize-8)/8
"""
import struct

import numpy as np

HEADER_SIZE = 96
CODEC_ATRAC3 = 0
CODEC_ATRAC3PLUS = 1
_SAMPLERATES = [32000, 44100, 48000, 88200, 96000]


class OmaFormatError(ValueError):
    pass


def _sr_idx(sample_rate):
    try:
        return _SAMPLERATES.index(sample_rate)
    except ValueError:
        raise OmaFormatError(f"unsupported sample rate {sample_rate}")


def _params(codec, frame_size, channels, joint_stereo, sample_rate):
    sr = _sr_idx(sample_rate)
    if codec == CODEC_ATRAC3:
        js = 1 if joint_stereo else 0
        return (CODEC_ATRAC3 << 24) | (js << 17) | (sr << 13) | (frame_size // 8)
    # ATRAC3+: channel id 1 = mono, 2 = stereo (channel_id_to_format_tab)
    ch_id = 1 if channels == 1 else 2
    return ((CODEC_ATRAC3PLUS << 24) | (sr << 13) | (ch_id << 10)
            | ((frame_size - 8) // 8))


def write(path, frames: np.ndarray, codec, frame_size, channels=2,
          joint_stereo=False, sample_rate=44100):
    """frames: [N, frame_size] uint8."""
    header = bytearray(HEADER_SIZE)
    header[0:3] = b"EA3"
    header[3] = 1
    header[5] = HEADER_SIZE
    header[6] = 0xFF
    header[7] = 0xFF
    header[32:36] = struct.pack(
        ">I", _params(codec, frame_size, channels, joint_stereo, sample_rate))
    with open(path, "wb") as fp:
        fp.write(bytes(header))
        fp.write(np.ascontiguousarray(frames, np.uint8).tobytes())


def read(path):
    """Returns (frames [N, frame_size] uint8, info dict)."""
    with open(path, "rb") as fp:
        header = fp.read(HEADER_SIZE)
        if len(header) < HEADER_SIZE or header[0:3] != b"EA3" \
                or header[5] != HEADER_SIZE:
            raise OmaFormatError("not an OMA file")
        if header[6] != 0xFF or header[7] != 0xFF:
            raise OmaFormatError("encrypted OMA is not supported")
        params = struct.unpack(">I", header[32:36])[0]
        codec = params >> 24
        sr = _SAMPLERATES[(params >> 13) & 7]
        if codec == CODEC_ATRAC3:
            info = {"codec": codec, "sample_rate": sr,
                    "joint_stereo": bool((params >> 17) & 1),
                    "frame_size": (params & 0x3FF) * 8, "channels": 2}
        elif codec == CODEC_ATRAC3PLUS:
            ch_id = (params >> 10) & 7
            info = {"codec": codec, "sample_rate": sr, "joint_stereo": False,
                    "frame_size": (params & 0x3FF) * 8 + 8,
                    "channels": 1 if ch_id == 1 else 2}
        else:
            raise OmaFormatError(f"unsupported OMA codec {codec}")
        data = fp.read()
    fs = info["frame_size"]
    n = len(data) // fs
    frames = np.frombuffer(data[: n * fs], np.uint8).reshape(n, fs)
    return frames, info
