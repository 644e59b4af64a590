"""Kernel I (``csrc/at3p_spectrum.cu``, through
``models/atrac3p/device_pack.spectrum_fields``) against its plain version
on the card.  Fields are integers: every comparison is equality.

Needs a GPU and nvcc, so every test is marked ``cuda`` and skips elsewhere.
The machine with the card has no JAX, and tests/conftest.py imports it, so
run this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_at3p_spectrum.py

The inputs come from ``testing.spectrum_case``: every (wordlen, family)
table at the encoder's extreme magnitudes, all-zero and sparse QUs, every
numQU from 1 to 32, stray values past each QU's lines; frame counts of 1,
37 and 3,001 (more frames than the grid's blocks hold at once, and no
multiple of them), and the ``atrac3plus.batch`` cell's 32,768 a channel.
"""
import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.models.atrac3p import device_pack as dp
from atracdenc_tpu_torch.testing import spectrum_case

pytestmark = pytest.mark.cuda
CELL_FRAMES = 64 * 512                      # atrac3plus.batch, a channel


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    trace.disable()
    trace.reset()
    yield torch.device("cuda")
    torch.cuda.set_sync_debug_mode(0)
    trace.disable()
    trace.reset()


def _inputs(seed, f, dev, tile=1):
    mant, spec_tab, num_qu = spectrum_case(seed, f)
    pos = np.random.default_rng(seed).integers(0, 8000, f).astype(np.int32)
    return [torch.from_numpy(a).to(dev).repeat((tile,) + (1,) * (a.ndim - 1))
            for a in (mant, spec_tab, num_qu, pos)]


def _check(args):
    got = dp.spectrum_fields(*args)
    plain = dp.spectrum_fields_torch(*args)
    torch.cuda.synchronize()
    for name, g, p in zip(("values", "widths", "offsets", "bits"), got, plain):
        assert g.dtype == p.dtype and g.shape == p.shape, name
        assert torch.equal(g, p), \
            f"{name}: {int((g != p).sum())} of {g.numel()} differ"
    return got


@pytest.mark.parametrize("f", [1, 37, 3001])
def test_spectrum_kernel_equals_plain(dev, f):
    got = _check(_inputs(11 + f, f, dev))
    assert int(got[3].sum()) > 0


def test_spectrum_kernel_at_the_cells_shape(dev):
    """32,768 frames a channel: equal to the plain version; no operation
    of the kernel's route, nor of the whole packer around it, synchronises
    with the host; ``launch.at3p_spectrum`` counts 2 a stereo
    ``pack_device``."""
    args = _inputs(5, 64, dev, tile=CELL_FRAMES // 64)
    _check(args)
    torch.cuda.set_sync_debug_mode("error")
    dp.spectrum_fields(*args)
    torch.cuda.set_sync_debug_mode(0)

    mant, spec_tab, num_qu, _ = args
    gen = torch.Generator(device=dev).manual_seed(3)
    planes = {"num_qu": num_qu, "mant": torch.stack([mant, mant.flip(0)]),
              "spec_tab": torch.stack([spec_tab, spec_tab.flip(0)]),
              "sfi": torch.randint(0, 64, (2, CELL_FRAMES, 32), device=dev,
                                   generator=gen, dtype=torch.int32)}
    dp.pack_device(planes, 2)                        # tables on the card
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    torch.cuda.set_sync_debug_mode("error")
    frames = dp.pack_device(planes, 2)
    torch.cuda.set_sync_debug_mode(0)
    trace.disable()
    assert trace.counter("launch.at3p_spectrum") == 2
    assert trace.counter("launch.deposit") == 1
    assert frames.shape == (CELL_FRAMES, 2048)


def test_pack_device_cuda_equals_cpu(dev):
    """The whole packer on the card (kernels I and G) equals its CPU route
    (both plain versions) byte for byte, stereo and mono."""
    mant, spec_tab, num_qu = (torch.from_numpy(a) for a in spectrum_case(8, 96))
    sfi = torch.from_numpy(np.random.default_rng(8).integers(
        0, 64, (2, 96, 32)).astype(np.int32))
    for c in (2, 1):
        planes = {"num_qu": num_qu, "sfi": sfi[:c],
                  "mant": torch.stack([mant, mant.roll(1, 0)])[:c],
                  "spec_tab": torch.stack([spec_tab, spec_tab.roll(1, 0)])[:c]}
        host = dp.pack_device(planes, c)
        got = dp.pack_device({k: v.to(dev) for k, v in planes.items()}, c)
        assert torch.equal(got.cpu(), host), c


def test_spectrum_wrapper_refuses(dev):
    mant, spec_tab, num_qu, pos = _inputs(2, 8, dev)
    for bad in ((mant.long(), spec_tab, num_qu, pos),
                (mant[:, :16], spec_tab, num_qu, pos),
                (mant, spec_tab[:, :31], num_qu, pos),
                (mant, spec_tab, num_qu[:7], pos),
                (mant, spec_tab, num_qu, pos.to(torch.int16))):
        with pytest.raises(ValueError, match="int32"):
            dp.spectrum_fields(*bad)
    with pytest.raises(ValueError, match="one device"):
        dp.spectrum_fields(mant, spec_tab, num_qu.cpu(), pos)
    odd = torch.empty(mant.numel() + 1, dtype=torch.int32, device=dev)[1:]
    with pytest.raises(ValueError, match="16-byte"):
        dp.spectrum_fields(odd.view(mant.shape).copy_(mant), spec_tab, num_qu,
                           pos)
