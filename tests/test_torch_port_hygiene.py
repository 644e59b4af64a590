"""Hygiene of the PyTorch port: neither JAX nor the JAX package anywhere in
its import graph, TF32 off, and no silent CPU fallback on a CUDA path."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import kernels, runtime, trace
from atracdenc_tpu_torch.ops import (at1_alloc, bitdeposit, greedy, quant_cost,
                                     rate_control)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "atracdenc_tpu"):
            raise ImportError(f"{name} is refused in this process")
        return None

sys.meta_path.insert(0, Refuse())
import numpy as np
import torch
torch.set_num_threads(1)
import importlib, pkgutil
import atracdenc_tpu_torch
for m in pkgutil.walk_packages(atracdenc_tpu_torch.__path__, "atracdenc_tpu_torch."):
    importlib.import_module(m.name)
from atracdenc_tpu_torch.models.atrac3.encoder import encode_frames
from atracdenc_tpu_torch.models.atrac3 import frame
from atracdenc_tpu_torch.runtime import to_numpy
rng = np.random.default_rng(0)
pcm = torch.from_numpy((0.1 * rng.standard_normal((2, 2048))).astype(np.float32))
planes = encode_frames(pcm, no_gain_control=False, no_tonal=False)
out = frame.pack({k: to_numpy(v) for k, v in planes.items()}, 384)
assert out.shape == (2, 384)
from atracdenc_tpu_torch.models.atrac3 import decoder as at3_decoder
pcm_back = at3_decoder.decode_track(out, 2, device="cpu")
assert pcm_back.shape == (2, 2048 - 1162) and np.isfinite(pcm_back).all()
from atracdenc_tpu_torch.models.atrac1 import decoder, device_pack, encoder as at1
from atracdenc_tpu_torch.models.atrac1 import frame as at1_frame
pcm1 = (0.1 * rng.standard_normal((2, 512 * 4))).astype(np.float32)
planes1 = at1.encode_track(pcm1, device="cpu")
merged = {k: np.swapaxes(planes1[k], 0, 1).reshape((-1,) + planes1[k].shape[2:])
          for k in ("short_mask", "bfu_idx", "wordlen", "sfi", "mant")}
units = at1_frame.pack(merged)
assert units.shape == (8, 212)
assert (device_pack.pack_device({k: torch.from_numpy(v) for k, v in merged.items()}).numpy() == units).all()
assert decoder.decode_track(planes1, exact=False, device="cpu").shape == (2, 512 * 4)
from atracdenc_tpu_torch.models.atrac3p import decoder as at3p_decoder
from atracdenc_tpu_torch.models.atrac3p import encoder as at3p
from atracdenc_tpu_torch.models.atrac3p.device_pack import pack_device
k = np.arange(2048 * 2)
pcm3p = np.stack([0.4 * np.sin(2 * np.pi * 689.0625 * k / 44100)] * 2).astype(np.float32)
planes3p = at3p.encode_track(pcm3p, device="cpu")
assert planes3p["tones"]["valid"].any()
frames3p = pack_device({key: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                              if isinstance(v, dict) else torch.from_numpy(v))
                        for key, v in planes3p.items()}, 2).numpy()
assert frames3p.shape == (2, 2048)
pcm3p_back = at3p_decoder.decode_track(frames3p, 2, device="cpu")
assert pcm3p_back.shape == (2, 2 * 2048 - 368) and np.isfinite(pcm3p_back).all()
from atracdenc_tpu_torch.ops.sort import bitonic_sort
key, (perm,) = bitonic_sort(torch.tensor([[3.0, 1.0, 2.0, 0.0]]), [torch.arange(4)[None]])
assert key.tolist() == [[0.0, 1.0, 2.0, 3.0]] and perm.tolist() == [[3, 1, 2, 0]]
from atracdenc_tpu_torch.parallel import mesh as M
mesh1 = M.Mesh(1, 1, "cpu")
assert M.encode_batch_sharded(pcm1[None], mesh1)["wordlen"].shape == (1, 2, 4, 52)
assert M.encode_batch_at3_bytes_sharded(
    (0.1 * rng.standard_normal((1, 2, 2048))).astype(np.float32), mesh1).shape == (1, 2, 384)
import os, sys as _sys, tempfile
from atracdenc_tpu_torch.io import wav
from atracdenc_tpu_torch.tools import transcode
with tempfile.TemporaryDirectory() as d:
    wav.write(os.path.join(d, "a.wav"), pcm1, 44100)
    assert transcode.main([os.path.join(d, "a.wav"), "--codec", "atrac1",
                           "--device", "cpu", "--out-dir", d]) == 0
    assert os.path.getsize(os.path.join(d, "a.aea")) > 2048
assert not any(m.split(".")[0] in ("jax", "atracdenc_tpu") for m in sys.modules)
print("ok")
"""


def test_port_imports_and_encodes_without_jax():
    """The whole port imports, encodes and decodes (ATRAC3, ATRAC1 and
    ATRAC3+, GHA on, through the device packer) in a process that refuses
    both ``jax`` and ``atracdenc_tpu``."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


# the modules of the scale-out and batch slice, the bench and the
# harnesses, named so that a rename cannot drop them from the import checks
# below
SCALE_OUT = ("parallel/__init__.py", "parallel/distributed.py",
             "parallel/mesh.py", "tools/transcode.py", "ops/sort.py",
             "bench.py", "selfcheck.py", "scaling_bench.py",
             "golden_check.py", "triage_at3.py", "triage_gain.py",
             "triage_at1.py", "sweep_at3_batch.py", "sweep_at1_batch.py",
             "perf_campaign.py")


def _imported_modules(path):
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_only_shared_imports_the_jax_package():
    """No file of the port, and not chip_smoke.py, imports JAX or anything
    of atracdenc_tpu: the port keeps its own copies of the host modules."""
    pkg = os.path.join(ROOT, "atracdenc_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
        if f.endswith(".py")]
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "atracdenc_tpu"), (path, mod)
    assert not os.path.exists(os.path.join(pkg, "shared.py"))
    for rel in SCALE_OUT:
        assert os.path.join(pkg, rel) in files, rel
        assert not any(m.split(".")[0] in ("jax", "jaxlib", "atracdenc_tpu")
                       for m in _imported_modules(os.path.join(pkg, rel))), rel


def test_ranks_never_fall_back_to_the_cpu(tmp_path):
    """A rank, a mesh and the transcoder run on CUDA unless the CPU is
    asked for: without a card they raise, never move to the CPU."""
    from atracdenc_tpu_torch.parallel import distributed as D, mesh as M
    from atracdenc_tpu_torch.tools import transcode
    assert D.rank_device("cpu", 3, 4).type == "cpu"
    with pytest.raises(ValueError, match="local_devices"):
        D.initialize(local_devices=2, device="cuda")
    if torch.cuda.is_available():
        assert D.rank_device("cuda", 3, 4).type == "cuda"
        return
    for call in (lambda: D.rank_device("cuda", 0, 4), D.initialize,
                 lambda: M.Mesh(1, 1),
                 lambda: transcode.main(["none.wav", "--out-dir",
                                         str(tmp_path)])):
        with pytest.raises(RuntimeError, match="CUDA requested"):
            call()
    assert not os.listdir(tmp_path)


def test_chip_smoke_refuses_without_cuda():
    """Without a GPU the card check exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_device_never_falls_back():
    assert runtime.device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            runtime.device()
    with pytest.raises(ValueError):
        runtime.device("meta")


def _missing_library():
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@pytest.mark.parametrize("name", ["quant_cost", "greedy", "rate_control",
                                  "at1_alloc", "quant_cost_full",
                                  "bisect_block", "deposit"])
def test_non_cpu_tensor_without_library_raises(monkeypatch, name):
    """A tensor that is not on the CPU goes to the kernel, never to the
    plain version: with the library missing the wrapper raises (meta
    tensors stand in for CUDA tensors on a machine without a GPU)."""
    monkeypatch.setattr(kernels, "library", _missing_library)
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        if name in ("quant_cost", "quant_cost_full"):
            fn = getattr(quant_cost, "quant_cost_plain" if name == "quant_cost"
                         else name)
            fn(torch.zeros((2, 32, 128), device=meta),
               torch.ones((32, 128), dtype=torch.bool, device=meta))
        elif name == "greedy":
            z = torch.zeros((4, 32), device=meta)
            greedy.greedy_scan(z, z, z.bool(), z[:, 0], z[:, 0])
        elif name in ("rate_control", "bisect_block"):
            f = torch.zeros((3, 32), device=meta)
            i = f.int()
            m = torch.zeros((3, 32, 8), device=meta)
            fn = getattr(rate_control, "rate_control_block"
                         if name == "rate_control" else name)
            fn(f, f.bool(), i, f[:, 0], i[:, 0], i[:, 0], m, m.int(), m.int(),
               i, i, i, i, m.int())
        elif name == "deposit":
            z = torch.zeros((3, 40), dtype=torch.int64, device=meta)
            bitdeposit.deposit_fields(z, z, z, 212)
        else:
            e = torch.zeros((3, 52), device=meta)
            at1_alloc.at1_allocate_block(e.int(), e, e[:, :3].bool(), e[:, 0])
    assert trace.counter("launch.deposit") == 0
    assert trace.counter("launch.quant_cost") == 0 \
        and trace.counter("launch.greedy") == 0 \
        and trace.counter("launch.rate_control") == 0 \
        and trace.counter("launch.at1_alloc") == 0
    assert trace.counter("launch.quant_full") == 0 \
        and trace.counter("launch.bisect") == 0


def test_cpu_route_takes_the_plain_version():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    x = torch.from_numpy(
        (0.5 * np.random.default_rng(1).standard_normal((1, 32, 128))).astype(np.float32))
    err, vlc = quant_cost.quant_cost_plain(x, torch.ones((32, 128), dtype=torch.bool))
    assert err.shape == (1, 32, 8) and vlc.dtype == torch.int32
    assert trace.counter("launch.quant_cost") == 0
    e = torch.full((2, 52), 1e-3)
    idx, wl = at1_alloc.at1_allocate_block(
        torch.full((2, 52), 40, dtype=torch.int32), e,
        torch.zeros((2, 3), dtype=torch.bool), torch.ones(2))
    assert idx.shape == (2,) and wl.shape == (2, 52) and wl.dtype == torch.int32
    assert trace.counter("launch.at1_alloc") == 0
    f = torch.full((2, 5), 8, dtype=torch.int32)
    units = bitdeposit.deposit_fields(f, f, torch.arange(0, 40, 8).expand(2, 5), 5)
    assert torch.equal(units, torch.full((2, 5), 8, dtype=torch.uint8))
    assert trace.counter("launch.deposit") == 0


def test_kernel_sources_and_entries():
    """Every csrc/*.cu goes into the library (the bit deposit's too), and
    every entry point ``kernels.py`` binds is defined in one of them."""
    names = {os.path.basename(s) for s in kernels.sources()}
    assert {"bitdeposit.cu", "at1_alloc.cu", "quant_cost.cu"} <= names
    assert names == set(os.listdir(kernels.CSRC)) - {"__pycache__"}
    text = "".join(open(s).read() for s in kernels.sources())
    for entry in kernels._SIGNATURES:
        assert f'extern "C" int {entry}(' in text, entry
