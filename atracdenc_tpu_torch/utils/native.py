"""ctypes loader for the native host runtime (native/bitpack.cpp).

Builds the library on first use, if a compiler is available, into
``.build/atracdenc_tpu_torch/`` beside the package (named by a hash of the
source and the Makefile, so an edit rebuilds); the package keeps no built
library.  All callers fall back to the NumPy implementations in utils/bitpack.py when the
native library cannot be built, with byte-identical output, so the framework
stays functional everywhere.
"""
import ctypes
import hashlib
import os
import subprocess

import numpy as np

from atracdenc_tpu_torch.kernels import BUILD_DIR

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_lib = None
_tried = False


def library_path():
    h = hashlib.sha1()
    for name in ("bitpack.cpp", "Makefile"):
        with open(os.path.join(_NATIVE_DIR, name), "rb") as fp:
            h.update(fp.read())
    return os.path.join(BUILD_DIR, f"libatracpack_{h.hexdigest()[:12]}.so")


def load():
    """Returns the loaded CDLL or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}"       # parallel builders never collide
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
            subprocess.run(["make", "-s", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, path)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.pack_frames.restype = ctypes.c_int
    lib.pack_frames.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.unpack_fields.restype = None
    lib.unpack_fields.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint32),
    ]
    _lib = lib
    return _lib


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def pack_frames(values: np.ndarray, widths: np.ndarray, frame_bytes: int):
    """Native pack_frames; returns None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, np.uint32)
    widths = np.ascontiguousarray(widths, np.int32)
    n, k = values.shape
    out = np.empty((n, frame_bytes), np.uint8)
    rc = lib.pack_frames(_ptr(values, ctypes.c_uint32), _ptr(widths, ctypes.c_int32),
                         n, k, frame_bytes, _ptr(out, ctypes.c_uint8))
    if rc != 0:
        raise ValueError("frame overflow: fields exceed frame size")
    return out


def unpack_fields(frames: np.ndarray, offsets: np.ndarray, widths: np.ndarray):
    """Native unpack_fields; returns None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    frames = np.ascontiguousarray(frames, np.uint8)
    offsets = np.ascontiguousarray(offsets, np.int64)
    widths = np.ascontiguousarray(widths, np.int32)
    n, k = offsets.shape
    out = np.empty((n, k), np.uint32)
    lib.unpack_fields(_ptr(frames, ctypes.c_uint8), frames.shape[1],
                      _ptr(offsets, ctypes.c_int64), _ptr(widths, ctypes.c_int32),
                      n, k, _ptr(out, ctypes.c_uint32))
    return out
