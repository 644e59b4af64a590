"""RAW container: headerless frames, optionally zero-padded to a fixed size
(reference: src/raw.cpp:40-47)."""
import numpy as np


def write(path: str, frames: np.ndarray, frame_size: int = 0) -> None:
    frames = np.ascontiguousarray(frames, np.uint8)
    if frame_size and frames.shape[1] < frame_size:
        frames = np.pad(frames, ((0, 0), (0, frame_size - frames.shape[1])))
    with open(path, "wb") as fp:
        fp.write(frames.tobytes())


def read(path: str, frame_size: int) -> np.ndarray:
    with open(path, "rb") as fp:
        data = fp.read()
    n = len(data) // frame_size
    return np.frombuffer(data[: n * frame_size], np.uint8).reshape(n, frame_size)
