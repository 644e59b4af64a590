"""Hygiene of the PyTorch port: no JAX anywhere in its import graph, TF32
off, and no silent CPU fallback on a CUDA path."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import kernels, runtime
from atracdenc_tpu_torch.ops import greedy, quant_cost, rate_control

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = r"""
import sys

class RefuseJax:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is refused in this process")
        return None

sys.meta_path.insert(0, RefuseJax())
import numpy as np
import torch
torch.set_num_threads(1)
import importlib, pkgutil
import atracdenc_tpu_torch
for m in pkgutil.walk_packages(atracdenc_tpu_torch.__path__, "atracdenc_tpu_torch."):
    importlib.import_module(m.name)
from atracdenc_tpu_torch.models.atrac3.encoder import encode_frames
from atracdenc_tpu_torch.shared import frame
from atracdenc_tpu_torch.runtime import to_numpy
rng = np.random.default_rng(0)
pcm = torch.from_numpy((0.1 * rng.standard_normal((2, 2048))).astype(np.float32))
planes = encode_frames(pcm, no_gain_control=False, no_tonal=False)
out = frame.pack({k: to_numpy(v) for k, v in planes.items()}, 384)
assert out.shape == (2, 384)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print("ok")
"""


def test_port_imports_and_encodes_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def _imported_modules(path):
    with open(path) as fp:
        tree = ast.parse(fp.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_only_shared_imports_the_jax_package():
    """The port and chip_smoke.py import nothing of JAX, and take the host
    modules of atracdenc_tpu only through atracdenc_tpu_torch/shared.py."""
    pkg = os.path.join(ROOT, "atracdenc_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs
        if f.endswith(".py")]
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib"), (path, mod)
            if top == "atracdenc_tpu":
                assert path == os.path.join(pkg, "shared.py"), (path, mod)


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


@pytest.mark.parametrize("name", ["quant_cost", "greedy", "rate_control"])
def test_non_cpu_tensor_without_library_raises(monkeypatch, name):
    """A tensor that is not on the CPU goes to the kernel, never to the
    plain version: with the library missing the wrapper raises (meta
    tensors stand in for CUDA tensors on a machine without a GPU)."""
    monkeypatch.setattr(kernels, "library", _missing_library)
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="nvcc"):
        if name == "quant_cost":
            quant_cost.quant_cost_plain(
                torch.zeros((2, 32, 128), device=meta),
                torch.ones((32, 128), dtype=torch.bool, device=meta))
        elif name == "greedy":
            z = torch.zeros((4, 32), device=meta)
            greedy.greedy_scan(z, z, z.bool(), z[:, 0], z[:, 0])
        else:
            f = torch.zeros((3, 32), device=meta)
            i = f.int()
            m = torch.zeros((3, 32, 8), device=meta)
            rate_control.rate_control_block(
                f, f.bool(), i, f[:, 0], i[:, 0], i[:, 0], m, m.int(), m.int(),
                i, i, i, i, m.int())
    assert quant_cost.launches == 0 and greedy.launches == 0 \
        and rate_control.launches == 0


def test_cpu_route_takes_the_plain_version():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    x = torch.from_numpy(
        (0.5 * np.random.default_rng(1).standard_normal((1, 32, 128))).astype(np.float32))
    err, vlc = quant_cost.quant_cost_plain(x, torch.ones((32, 128), dtype=torch.bool))
    assert err.shape == (1, 32, 8) and vlc.dtype == torch.int32
    assert quant_cost.launches == 0
