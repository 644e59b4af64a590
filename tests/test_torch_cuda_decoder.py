"""The ATRAC3 QA decoder on the card against itself on the CPU, on the
reference containers (plain and joint stereo): max |CUDA - CPU| within
1e-5 (cuBLAS sums the IMDCT and QMF matmuls in another order).

Needs a GPU, so every test is marked ``cuda`` and skips elsewhere.  Run it
on the card without the conftest (which imports JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_decoder.py
"""
import os

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch.containers import oma
from atracdenc_tpu_torch.models.atrac3 import decoder

pytestmark = pytest.mark.cuda
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("name", ["ref_c.oma", "ref_js.oma"])
def test_decode_track_cuda_matches_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    frames, info = oma.read(os.path.join(GOLDEN, name))
    js = info["joint_stereo"]
    gpu = decoder.decode_track(frames, info["channels"], js=js)
    cpu = decoder.decode_track(frames, info["channels"], js=js, device="cpu")
    assert gpu.shape == cpu.shape and np.isfinite(gpu).all()
    assert float(np.abs(gpu - cpu).max()) <= 1e-5
