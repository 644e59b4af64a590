"""RealMedia (.rm) container for ATRAC3 streams.

Chunk layout mirrors the reference writer (reference: src/rm.cpp): .RMF /
PROP / MDPR (with RA5 codec data blob) / DATA.  Frame payloads are XOR-
scrambled with 0x537F6103 and grouped three per media packet with the
timestamp rule the original RealAudio player expects (rm.cpp:211-231).
"""
import struct

import numpy as np

_RA_MIME = b"audio/x-pn-realaudio\x00"
_RA_DESC = b"Audio Stream\x00"
_CODEC_DATA_SZ = 92
_RMF_SZ = 18
_PROP_SZ = 50
_MDPR_SZ = 42 + len(_RA_MIME) + len(_RA_DESC) + _CODEC_DATA_SZ
_FRAME_DURATION_MS = 1000.0 * 1024.0 / 44100.0
_SCRAMBLE_KEY = 0x537F6103


def _codec_data(frame_size, channels, joint_stereo, bitrate):
    buf = bytearray(_CODEC_DATA_SZ)
    struct.pack_into(">I", buf, 0, _CODEC_DATA_SZ - 4)
    buf[4:8] = b".ra\xfd"
    struct.pack_into(">H", buf, 8, 5)                 # version
    buf[12:16] = b".ra5"
    struct.pack_into(">I", buf, 16, 0x01B53530)
    struct.pack_into(">H", buf, 20, 5)                # version2
    struct.pack_into(">I", buf, 22, 0)                # header size
    struct.pack_into(">H", buf, 26, 2)                # flavor
    struct.pack_into(">I", buf, 28, frame_size * 3)   # codec frame size
    struct.pack_into(">I", buf, 32, 0x51540)
    struct.pack_into(">I", buf, 36, bitrate // 8 * 60)
    struct.pack_into(">I", buf, 40, bitrate // 8 * 60)
    struct.pack_into(">H", buf, 44, 1)                # sub packet h
    struct.pack_into(">H", buf, 46, frame_size * 3)   # frame size
    struct.pack_into(">H", buf, 48, frame_size)       # sub packet sz
    struct.pack_into(">H", buf, 54, 44100)
    struct.pack_into(">H", buf, 58, 44100)
    struct.pack_into(">H", buf, 62, 16)               # sample size
    struct.pack_into(">H", buf, 64, 2)                # channels
    buf[66:74] = b"genratrc"
    buf[74] = 0x01
    buf[75] = 0x07
    struct.pack_into(">I", buf, 78, 10)
    struct.pack_into(">I", buf, 82, 4)
    struct.pack_into(">H", buf, 86, 1024 * channels)
    struct.pack_into(">H", buf, 88, 0x88E)
    struct.pack_into(">H", buf, 90, 0x12 if joint_stereo else 0x2)
    return bytes(buf)


def read(path):
    """RealMedia ATRAC3 -> (frames [N, frame_size] uint8, info).

    Inverts the writer below: walks .RMF/PROP/MDPR/DATA, pulls the
    sub-packet size and JS flag from the RA5 codec blob, splits the 3-frame
    media packets and unscrambles the payloads.  New capability — the
    reference only writes .rm."""
    with open(path, "rb") as fp:
        blob = fp.read()
    if blob[:4] != b".RMF":
        raise ValueError("not a RealMedia file")
    pos = 0
    frame_size = None
    joint_stereo = False
    payload = None
    npkts = 0
    while pos + 8 <= len(blob):
        cid = blob[pos:pos + 4]
        size = struct.unpack(">I", blob[pos + 4:pos + 8])[0]
        if cid == b".RMF":
            size = _RMF_SZ
        if cid == b"MDPR":
            cd = blob[pos + size - _CODEC_DATA_SZ: pos + size]
            if cd[4:8] != b".ra\xfd":
                raise ValueError("MDPR without RA5 codec data")
            frame_size = struct.unpack(">H", cd[48:50])[0]
            joint_stereo = struct.unpack(">H", cd[90:92])[0] == 0x12
        elif cid == b"DATA":
            npkts = struct.unpack(">I", blob[pos + 10:pos + 14])[0]
            payload = blob[pos + 18: pos + size]
        if size <= 0:
            # corrupt size field would otherwise spin this walk forever
            raise ValueError(f"RealMedia chunk {cid!r} with size {size}")
        pos += size
    if frame_size is None or payload is None:
        raise ValueError("RealMedia file lacks MDPR/DATA chunks")
    if frame_size <= 0 or frame_size % 8:
        raise ValueError(f"RealMedia MDPR with bogus frame size {frame_size}")

    key = np.array([0x53, 0x7F, 0x61, 0x03], np.uint8)
    # packet = 10-byte header (ver, len, stream, ts) + 2 flag bytes + frames
    pkt_hdr = 12
    pkt_sz = pkt_hdr + 3 * frame_size
    out = []
    p = 0
    while p + pkt_hdr + frame_size <= len(payload):
        # a final short packet carries 1-2 frames (the writer declares the
        # full 3-frame length but writes only what exists)
        body = payload[p + pkt_hdr: min(p + pkt_sz, len(payload))]
        k = len(body) // frame_size
        out.append(np.frombuffer(body[: k * frame_size], np.uint8)
                   .reshape(k, frame_size))
        p += pkt_sz
    frames = (np.concatenate(out, axis=0) if out
              else np.zeros((0, frame_size), np.uint8))
    frames = frames ^ np.tile(key, frame_size // 4)
    info = {"codec": "atrac3", "channels": 2, "frame_size": frame_size,
            "joint_stereo": joint_stereo, "total_samples": npkts * 1024}
    return frames, info


def write(path, frames: np.ndarray, frame_size, channels=2,
          joint_stereo=False):
    """frames: [N, frame_size] uint8."""
    n = frames.shape[0]
    bitrate = int(8 * frame_size * 44100.0 / 1024.0)
    duration = int(n * _FRAME_DURATION_MS)

    rmf = (b".RMF" + struct.pack(">IHII", _RMF_SZ, 0, 0, 4)[:14])
    prop = (b"PROP" + struct.pack(
        ">IHIIIIIIIIIHH", _PROP_SZ, 0, bitrate, bitrate, frame_size,
        frame_size, n, duration, 0, 0, _RMF_SZ + _PROP_SZ + _MDPR_SZ, 1, 3))
    mdpr = (b"MDPR" + struct.pack(
        ">IHHIIIIIII", _MDPR_SZ, 0, 0, bitrate, bitrate, frame_size,
        frame_size, 0, 0, duration)
        + bytes([len(_RA_DESC)]) + _RA_DESC
        + bytes([len(_RA_MIME)]) + _RA_MIME
        + _codec_data(frame_size, channels, joint_stereo, bitrate))
    assert len(prop) == _PROP_SZ and len(mdpr) == _MDPR_SZ

    # scramble payloads: per-uint32 XOR with 0x537F6103 whose byte pattern in
    # the file is 53 7F 61 03 (rm.cpp:137-145), i.e. a byte-wise XOR tile
    data = np.ascontiguousarray(frames, np.uint8)
    key = np.array([0x53, 0x7F, 0x61, 0x03], np.uint8)
    scrambled = data.reshape(n, -1) ^ np.tile(key, frame_size // 4)

    packets = bytearray()
    ts = 0.0
    for i in range(n):
        if i % 3 == 0:
            packets += struct.pack(">HHHI", 0, 3 * frame_size + 12, 0, int(ts))
            packets += b"\x00\x02"
        packets += scrambled[i].tobytes()
        if i % 3 == 2:
            ts += _FRAME_DURATION_MS * 3.0

    data_chunk_sz = 18 + len(packets)
    data_hdr = b"DATA" + struct.pack(">IHII", data_chunk_sz, 0, n, 0)[:14]
    with open(path, "wb") as fp:
        fp.write(rmf)
        fp.write(prop)
        fp.write(mdpr)
        fp.write(data_hdr)
        fp.write(bytes(packets))
