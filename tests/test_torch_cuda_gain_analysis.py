"""Kernel J (``csrc/at3_gain.cu``, through ``gain.gain_analysis``) against
the plain route ``gain.gain_analysis_torch`` on the card.

Needs a GPU and nvcc, so every test is marked ``cuda`` and skips elsewhere.
The machine with the card has no JAX, and tests/conftest.py imports it, so
run this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_gain_analysis.py

The inputs: ``testing.gain_case`` at ragged shapes (odd channel counts, one
frame and 37, with and without a lookahead), and one ``atrac3-lp2.batch``
call's windows (64 ``portbench.music`` tracks x 512 frames, 262,144
windows).  J sums each of its 512-term products in another order than
cuBLAS, so its planes differ from the plain route's in the last bits: a
gap is held against the window's input RMS (``testing.gain_gaps``; an f32
sum of 512 products errs with its terms, not with its value) under
``testing.GAIN_TOL``.  Where a gain decision stands on such a knife edge,
``gain_control``'s points may differ: they must be equal on at least 99.9%
of band-frames, and the rest are printed.
"""
import pytest
import torch

from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.models.atrac3 import gain
from atracdenc_tpu_torch.testing import (GAIN_TOL, gain_case, gain_cell_call,
                                         gain_gaps)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    trace.disable()
    trace.reset()
    yield torch.device("cuda")
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def cell_call():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return gain_cell_call(torch.device("cuda"))


def _hold(args):
    got = gain.gain_analysis(*args)
    want = gain.gain_analysis_torch(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    gaps = gain_gaps(got, want, *args)
    print(gaps)
    for name, (scaled, _) in gaps.items():
        assert scaled <= GAIN_TOL[name], (name, gaps[name])
    return got


@pytest.mark.parametrize("c,f,head", [(3, 1, True), (3, 1, False),
                                      (5, 37, True), (5, 37, False)])
def test_kernel_matches_plain_ragged(dev, c, f, head):
    b, p, n = (torch.from_numpy(a).to(dev) for a in gain_case(7 * c + f, c, f))
    _hold((b, p, n if head else None))


def test_kernel_matches_plain_cell_call(dev, cell_call):
    assert cell_call[0].shape[:2] == (128, 512)
    _hold(cell_call)


def test_gain_control_points_match_plain_route(dev, cell_call, monkeypatch):
    bands, prev_tail, next_head = cell_call
    ctx = gain.init_ctx(bands.shape[0], dev)
    ctx["prev_tail"] = prev_tail
    j = gain.gain_control(bands, ctx, next_head)
    monkeypatch.setattr(gain, "gain_analysis", gain.gain_analysis_torch)
    p = gain.gain_control(bands, ctx, next_head)
    same = (j[0] == p[0]).all(-1) & (j[1] == p[1]).all(-1) & (j[2] == p[2])
    share = float(same.float().mean())
    for i in torch.nonzero(~same).tolist():
        i = tuple(i)
        print(f"band-frame {i}: J levels {j[0][i].tolist()} locs "
              f"{j[1][i].tolist()}; plain levels {p[0][i].tolist()} locs "
              f"{p[1][i].tolist()}")
    print(f"equal on {share:.6f} of {same.numel()} band-frames")
    assert share >= 0.999


def test_one_launch_per_gain_control(dev):
    b, p, n = (torch.from_numpy(a).to(dev) for a in gain_case(11, 3, 8))
    ctx = gain.init_ctx(3, dev)
    ctx["prev_tail"] = p
    for k in (1, 2):
        gain.gain_control(b, ctx, n)
        assert trace.counter("launch.at3_gain") == k
