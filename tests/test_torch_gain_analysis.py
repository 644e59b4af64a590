"""ATRAC3 gain analysis (``models/atrac3/gain.gain_analysis``) on the CPU.

Kernel J (``csrc/at3_gain.cu``) runs only on a card; these tests hold what
it is built from: its window gather (``testing.gain_windows``, the kernel's
offsets) against ``assemble_up_in``, its packed constants and thread layout
(``testing.gain_kernel_model``) against the plain route, and the identity
that lets it skip the plain version's third product.  The card tests are
``tests/test_torch_cuda_gain_analysis.py``.
"""
import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.models.atrac3 import gain
from atracdenc_tpu_torch.testing import (assert_close, cpu_setup, gain_case,
                                         gain_kernel_model, gain_windows)


@pytest.fixture(autouse=True)
def tracer_off():
    cpu_setup()
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _case(seed, c=3, f=5):
    return [torch.from_numpy(a) for a in gain_case(seed, c, f)]


@pytest.mark.parametrize("f", [1, 5])
@pytest.mark.parametrize("with_head", [True, False])
def test_window_gather_equals_assemble_up_in(f, with_head):
    """The kernel's offsets give assemble_up_in's windows, at a chunk's
    first frame (prev_tail), its last (next_head, or zeros) and, with one
    frame, both at once."""
    bands, prev_tail, next_head = _case(1, f=f)
    head = next_head if with_head else None
    want = gain.assemble_up_in(bands, prev_tail, head).reshape(-1, 512)
    got = gain_windows(bands.numpy(), prev_tail.numpy(),
                       None if head is None else head.numpy())
    assert np.array_equal(got, want.numpy())
    if not with_head:
        assert not want.reshape(3, f, 4, 512)[:, -1, :, 384:].any()


def test_filtered_spectrum_is_scaled_spectrum():
    """x @ Ef == (x @ E) * [h, h] within one f32 ulp: h is 0, 0.5 or 1, so
    the scaled products round as the unscaled ones."""
    _, e, ef = gain._region_matrices_np()
    h = gain._hpf_response()
    assert set(np.unique(h)) == {0.0, 0.5, 1.0}
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.standard_normal((64, 512)),
                        gain_windows(*gain_case(2))]).astype(np.float32)
    x = torch.from_numpy(x)
    sp = torch.matmul(x, torch.from_numpy(e))
    spf = torch.matmul(x, torch.from_numpy(ef))
    scaled = sp * torch.from_numpy(np.concatenate([h, h]))
    np.testing.assert_array_max_ulp(scaled.numpy(), spf.numpy(), maxulp=1)


def test_gain_analysis_cpu_is_the_plain_route():
    bands, prev_tail, next_head = _case(3)
    got = gain.gain_analysis(bands, prev_tail, next_head)
    region, hfr = gain.upsample_region(
        gain.assemble_up_in(bands, prev_tail, next_head))
    want = gain.analyze_gain(region) + (hfr,)
    for name, g, w in zip(("gain", "lo", "hi", "hfr"), got, want):
        assert torch.equal(g, w), name
    assert trace.counter("launch.at3_gain") == 0


@pytest.mark.parametrize("seed", [4, 5])
def test_kernel_layout_and_constants(seed):
    """Kernel J's packed tiles read through its thread layout give the
    region and the spectrum (without the two zero columns), and its
    epilogue's arithmetic gives the plain route's planes."""
    bands, prev_tail, next_head = _case(seed, c=2, f=4)
    tiles, hcol = (torch.from_numpy(a) for a in gain._kernel_consts_np())
    assert tuple(tiles.shape) == (10, 512, 256) and tuple(hcol.shape) == (512,)
    x = torch.from_numpy(gain_windows(bands.numpy(), prev_tail.numpy(),
                                      next_head.numpy()))
    region, sp, g, lo, hi, hfr = gain_kernel_model(x, tiles, hcol)
    want_region, _ = gain.upsample_region(x)
    m, e, _ = (torch.from_numpy(a) for a in gain._region_matrices_np())
    assert_close(want_region, region, "region", peak=1e-6)
    keep = np.r_[0:257, 258:513]
    assert_close(torch.matmul(x, e)[:, keep], sp, "spectrum", peak=1e-6)
    want = gain.gain_analysis_torch(bands, prev_tail, next_head)
    for name, w, got in zip(("gain", "lo", "hi", "hfr"), want,
                            (g, lo, hi, hfr)):
        w = w.reshape(got.shape)
        assert_close(w, got, name, rtol=1e-4, peak=1e-5)
    assert int((want[3] >= gain.HIGH_FREQ_THRESHOLD).sum()) > 0
    assert int((want[3] < gain.HIGH_FREQ_THRESHOLD).sum()) > 0


def test_gain_control_runs_gain_analysis_in_its_span():
    bands, prev_tail, next_head = _case(6)
    ctx = gain.init_ctx(3, torch.device("cpu"))
    ctx["prev_tail"] = prev_tail
    trace.enable(cuda=False)
    gain.gain_control(bands, ctx, next_head)
    trace.disable()
    recs = trace.snapshot()["records"]
    by_id = {r["id"]: r for r in recs}
    inner = [r for r in recs if r["name"] == "gain_analysis"]
    assert len(inner) == 1
    assert by_id[inner[0]["parent"]]["name"] == "gain_control"
