"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The sources have a plain C interface, so they compile with ``nvcc`` alone
(no PyTorch headers, seconds instead of minutes) and load with ``ctypes``.
The library is built on first use into ``.build/atracdenc_tpu_torch/``
beside the package, named by a hash of the sources so an edit rebuilds.

Flags: ``-fmad=false`` keeps every ``a*b + c`` a separate multiply and add,
as the plain PyTorch versions and XLA compute it (kernel C's allocation
``spread*(csfi/xdiv) + (1-spread)*fix - shift`` would otherwise change in
the last bit); no ``--use_fast_math``, so division and rounding are IEEE.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".build", "atracdenc_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # (x, mask, err, vlc, n_blocks, stream)
    "atrac3_quant_cost_plain": [_P, _P, _P, _P, _L, _P],
    # (a, b, elig, e1, e2, e2_out, accept, rows, L, stream)
    "atrac3_greedy_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # (csfi, gated, tcounts, spread, target, num_bfu, err, clc, vlc,
    #  t_active, t_pos, t_len, t_bfu, t_vlc, fix, xdiv,
    #  wl_out, num_bfu_out, mode_out, n, auto, stream)
    "atrac3_rate_control": [_P] * 19 + [_I, _I, _P],
}


def sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path():
    h = hashlib.sha1()
    for s in sources():
        with open(s, "rb") as fp:
            h.update(os.path.basename(s).encode() + fp.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libatrac3_kernels_{h.hexdigest()[:12]}.so")


def build(verbose=False):
    """Compile csrc/*.cu into the shared library (if not yet built).

    Returns (path, seconds spent compiling; 0.0 when already built).
    verbose=True adds ``-Xptxas -v`` and prints nvcc's report (registers,
    shared memory and spills of every kernel)."""
    out = library_path()
    if os.path.exists(out):
        return out, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [s for s in sources() if s.endswith(".cu")]
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp] + cu
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    dt = time.perf_counter() - t0
    if verbose and (res.stdout or res.stderr):
        print(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out, dt


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built on first use).  Raises when it
    cannot be built or loaded: a CUDA tensor never falls back to the plain
    version."""
    path, _ = build()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status, name):
    """Raise on a non-zero cudaError_t returned by a launch entry."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {status}")


def stream_ptr(t):
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name, *tensors):
    """Device / contiguity / alignment checks shared by the wrappers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor not 16-byte aligned")
