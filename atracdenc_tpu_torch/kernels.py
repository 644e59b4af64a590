"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The sources have a plain C interface, so they compile with ``nvcc`` alone
(no PyTorch headers, seconds instead of minutes) and load with ``ctypes``.
The library is built on first use into ``.build/atracdenc_tpu_torch/``
beside the package, named by a hash of the sources so an edit rebuilds.

Flags: ``-fmad=false`` keeps every ``a*b + c`` a separate multiply and add,
as the plain PyTorch versions and XLA compute it (the allocations of
kernels C and E, ``spread*(sfi/div) + (1-spread)*fix - shift``, would
otherwise change in the last bit); no ``--use_fast_math``, so division and
rounding are IEEE.
"""
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), ".build", "atracdenc_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # (x, mask, err, vlc, n_frames, stream)
    "atrac3_quant_cost_plain": [_P, _P, _P, _P, _L, _P],
    # (x, mask, err, vlc, n_frames, stream)
    "atrac3_quant_cost_full": [_P, _P, _P, _P, _L, _P],
    # (a, b, elig, e1, e2, e2_out, accept, rows, L, stream)
    "atrac3_greedy_scan": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # () -> bytes of kernel B's dynamic shared memory a block
    "atrac3_greedy_smem_bytes": [],
    # (csfi, gated, tcounts, spread, target, num_bfu, err, clc, vlc,
    #  t_active, t_pos, t_len, t_bfu, t_vlc, fix, xdiv,
    #  wl_out, num_bfu_out, mode_out, n, clc_stride, auto, stream)
    "atrac3_rate_control": [_P] * 19 + [_I, _I, _I, _P],
    # (the 16 inputs of atrac3_rate_control, wl_out, n, clc_stride, stream)
    "atrac3_bisect": [_P] * 17 + [_I, _I, _P],
    # (sfi, energy, short_flags, loud, ath, fix_long, fix_short, band, specs,
    #  amount, boost_bits, boost_pos, n_boost, wl_out, idx_out, n,
    #  bfu_idx_const, flags_stride, loud_channels, loud_frames, stream)
    "atrac1_allocate": [_P] * 12 + [_I, _P, _P, _I, _I, _I, _I, _I, _P],
    # (values, value_bytes, widths, width_bytes, offsets, offset_bytes, out,
    #  n_frames, k, total_bytes, stream)
    "deposit_fields": [_P, _I, _P, _I, _P, _I, _P, _L, _I, _I, _P],
    # (x, fit_len, max_keep, sb_ath, active, dft_c, dft_s, tone_sin, ladder,
    #  freq, sf, ph, valid, max_amp, x_work, lists, counts, lane_rounds,
    #  lanes, stream)
    "gha_greedy": [_P] * 18 + [_I, _P],
    # (mant, spec_tab, num_qu, pos, book, values, widths, offsets, bits,
    #  n_frames, book_len, stream)
    "at3p_spectrum_fields": [_P] * 9 + [_L, _I, _P],
    # (bands, prev_tail, next_head, tiles, hcol, gain, lo, hi, hfr,
    #  channels, frames, stream)
    "at3_gain_analysis": [_P] * 9 + [_I, _I, _P],
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
    return os.path.join(BUILD_DIR, f"libatracdenc_kernels_{h.hexdigest()[:12]}.so")


def build(verbose=False):
    """Compile csrc/*.cu into the shared library (if not yet built): one
    ``nvcc -c`` per source, all started together, then one link.

    Returns (path, seconds spent compiling, nvcc's report); 0.0 and "" when
    already built.  verbose=True adds ``-Xptxas -v`` and prints the report
    (registers, shared memory, stack and spills of every kernel; see
    ``ptxas_usage``)."""
    out = library_path()
    if os.path.exists(out):
        return out, 0.0, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{out}.{os.getpid()}"
    extra = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    jobs = []
    for src in (s for s in sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        jobs.append((obj, subprocess.Popen(
            [nvcc] + NVCC_FLAGS + extra + ["-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    objs, failed, reports = [], [], []
    for obj, proc in jobs:
        report = proc.communicate()[0]
        if verbose and report:
            print(report)
        reports.append(report)
        objs.append(obj)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{report}")
    if not failed:
        res = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                              "-shared", "-o", f"{tmp}.so"] + objs,
                             capture_output=True, text=True)
        if res.returncode != 0:
            failed.append(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(f"{tmp}.so", out)
    return out, time.perf_counter() - t0, "\n".join(reports)


def ptxas_usage(report):
    """{mangled kernel name: {"registers", "smem", "stack", "spill"}} (bytes
    but registers) from the ``-Xptxas -v`` lines of ``build``'s report."""
    usage, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'?([\w$]+)", line)
        if m:
            name = m.group(1)
            usage.setdefault(name, {})
            continue
        if name is None:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill", r"(\d+) bytes spill stores"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                usage[name][key] = int(m.group(1))
    return usage


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library (built on first use).  Raises when it
    cannot be built or loaded: a CUDA tensor never falls back to the plain
    version."""
    path, _, _ = build()
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


def require_cuda(name, *tensors, align=16):
    """Device / contiguity / alignment (``align`` bytes) checks shared by
    the wrappers."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: tensor not {align}-byte aligned")
