"""AEA (ATRAC1 MiniDisc) container.

Format (reference: src/aea.cpp): 2048-byte header — magic 00 08 00 00, title
at offset 4 (<=16 chars), uint32-LE frame count at 260, channel count byte at
264 — followed by 212-byte sound units.  One dummy (all-zero) frame replaces
the very first encoded frame: the reference pre-writes a zero frame at create
time and swallows the first WriteFrame (aea.cpp:166-181), so we do the same
to stay byte-compatible.
"""
import struct

import numpy as np

META_SIZE = 2048
FRAME_SIZE = 212
MAGIC = b"\x00\x08\x00\x00"


class AeaFormatError(ValueError):
    pass


def write(path: str, frames: np.ndarray, channels: int, total_samples: int,
          title: str = "test") -> None:
    """frames: [N, 212] uint8 in stream order (ch-interleaved per frame)."""
    header = bytearray(META_SIZE)
    header[0:4] = MAGIC
    tb = title.encode("utf-8")[:16]
    header[4: 4 + len(tb)] = tb
    num_frames = channels * total_samples // 512
    header[260:264] = struct.pack("<I", num_frames)
    header[264] = channels
    with open(path, "wb") as fp:
        fp.write(bytes(header))
        fp.write(bytes(FRAME_SIZE))          # dummy frame
        if len(frames):
            fp.write(np.ascontiguousarray(frames[1:], np.uint8).tobytes())


def read(path: str):
    """Returns (frames [N, 212] uint8 incl. the leading dummy, channels, title,
    length_in_samples)."""
    with open(path, "rb") as fp:
        header = fp.read(META_SIZE)
        if len(header) < META_SIZE:
            raise AeaFormatError("Can't read AEA header")
        if header[0:4] != MAGIC or header[264] >= 3:
            raise AeaFormatError("not an AEA file")
        channels = header[264] or 1
        title = header[4:260].split(b"\x00", 1)[0].decode("utf-8", "replace")
        data = fp.read()
    n = len(data) // FRAME_SIZE
    frames = np.frombuffer(data[: n * FRAME_SIZE], np.uint8).reshape(n, FRAME_SIZE)
    # length formula from the reference (aea.cpp:98-108): per-channel frame
    # count minus the 5 warm-up frames, in samples
    length = 512 * (len(data) // FRAME_SIZE // channels - 5)
    return frames, channels, title, max(length, 0)
