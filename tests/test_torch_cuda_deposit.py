"""The bit-deposit kernel (``csrc/bitdeposit.cu``) against its plain
version, and the three device packers that run it against the host
packers, on the card.  Bytes are integers: every comparison is equality.

Needs a GPU and nvcc, so every test is marked ``cuda`` and skips elsewhere.
The machine with the card has no JAX, and tests/conftest.py imports it, so
run this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_deposit.py

The fields come from ``testing.deposit_case`` (widths 0 to 32, a 32-bit
field from bit 31, a frame filled to its last bit, fields partly and wholly
past the end, stray width-0 fields), from the cells' own encodes (ATRAC1's
65,536 units of 1,151 fields, ATRAC3's per-channel planes of 32,768
frames), and from the goldens through each codec's device packer.  A third
witness, ``_bit_reference``, sets bit by bit what the fields say and cuts
the frame at ``total_bytes``.
"""
import os

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.models.atrac1 import device_pack as pack1
from atracdenc_tpu_torch.models.atrac1 import encoder as enc1
from atracdenc_tpu_torch.models.atrac1 import frame as frame1
from atracdenc_tpu_torch.models.atrac3 import device_pack as pack3
from atracdenc_tpu_torch.models.atrac3 import encoder as enc3
from atracdenc_tpu_torch.models.atrac3 import frame as frame3
from atracdenc_tpu_torch.models.atrac3p import device_pack as pack3p
from atracdenc_tpu_torch.models.atrac3p import encoder as enc3p
from atracdenc_tpu_torch.models.atrac3p import frame as frame3p
from atracdenc_tpu_torch.ops import bitdeposit
from atracdenc_tpu_torch.testing import deposit_case

pytestmark = pytest.mark.cuda
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
AT1_PLANES = ("short_mask", "bfu_idx", "wordlen", "sfi", "mant")


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


def _bit_reference(values, widths, offsets, total_bytes):
    """[F, total_bytes] uint8: every bit of every field set where its
    offset says, MSB first, and the stream cut at the frame's end."""
    v = values.astype(np.uint64) & np.uint64(0xFFFFFFFF)
    w, o = widths.astype(np.int64), offsets.astype(np.int64)
    bits = 8 * total_bytes
    out = np.zeros((len(v), bits + 1), np.uint8)        # + a sink bit
    rows = np.arange(len(v))[:, None]
    for j in range(32):
        on = w > j
        pos = np.where(on & (o + j >= 0) & (o + j < bits), o + j, bits)
        bit = (v >> np.where(on, w - 1 - j, 0).astype(np.uint64)) & np.uint64(1)
        out[rows, pos] |= np.where(pos < bits, bit, 0).astype(np.uint8)
    return np.packbits(out[:, :bits], axis=1)


def _check(values, widths, offsets, total_bytes, reference=True):
    """The kernel's bytes equal the plain version's (and the bit
    reference's); returns them."""
    got = bitdeposit.deposit_fields(values, widths, offsets, total_bytes)
    plain = bitdeposit.deposit_fields_torch(values, widths, offsets,
                                            total_bytes)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and got.shape == plain.shape
    assert torch.equal(got, plain), \
        f"{int((got != plain).sum())} of {got.numel()} bytes differ"
    if reference:
        ref = _bit_reference(*(x.cpu().numpy() for x in (values, widths,
                                                         offsets)), total_bytes)
        assert np.array_equal(got.cpu().numpy(), ref)
    return got


def _planes(case, dev, dtypes=(torch.int64, torch.int32, torch.int32)):
    values, widths, offsets = case[:3]
    v = torch.from_numpy(values.astype(np.int64))
    if dtypes[0] == torch.int32:                # the low 32 bits, signed
        v = torch.from_numpy(values.view(np.int32))
    return (v.to(dev), torch.from_numpy(widths).to(dtypes[1]).to(dev),
            torch.from_numpy(offsets).to(dtypes[2]).to(dev))


@pytest.mark.parametrize("k", [40, 256, 1300])
@pytest.mark.parametrize("total_bytes", [212, 256, 1, 7, 2048, 65536])
def test_deposit_kernel_equals_plain(dev, total_bytes, k):
    """Frames a block from K (40: four, 256 and 1300: one), shared words
    from total_bytes (65,536 takes more than the default 48 KiB)."""
    case = deposit_case(total_bytes + k, total_bytes, f=37, k=k)
    _check(*_planes(case, dev), total_bytes)


@pytest.mark.parametrize("dtypes", [
    (torch.int64, torch.int64, torch.int64), (torch.int32, torch.int32, torch.int32),
    (torch.int64, torch.int32, torch.int32), (torch.int32, torch.int64, torch.int64),
    (torch.int64, torch.uint8, torch.int64)], ids=str)
def test_deposit_kernel_dtypes(dev, dtypes):
    """The planes as ATRAC1 (int64), ATRAC3 (int32) and ATRAC3+ (int64
    values) give them, mixed, and a dtype the kernel converts (uint8
    widths); int32 values above 2**31 are negative and read as 32 bits."""
    case = deposit_case(5, 212, f=19, k=300)
    _check(*_planes(case, dev, dtypes), 212)


def test_deposit_kernel_straddles_and_ends(dev):
    """A 32-bit field from bit 31 (words 0 and 1) that runs across the end
    of a 7-byte frame (the end of word 1 is cut), one across word 1 into
    the sink word, two far past it, and a width-0 field with a stray value,
    against the stream written out by hand: (0x7FFFFFFF << 33) |
    (0xC0FFEE01 << 1) | 1."""
    fields = [(0x7FFFFFFF, 31, 0), (0xC0FFEE01, 32, 31), (0xDEADBEEF, 0, 5),
              (0xA, 4, 63), (0xFF, 8, 100), (1, 1, 1 << 20)]
    values, widths, offsets = (torch.tensor([[f[i] for f in fields]],
                                            dtype=torch.int64, device=dev)
                               for i in range(3))
    got7 = _check(values, widths, offsets, 7)
    assert bytes(got7.cpu().numpy()[0]) == bytes.fromhex("ffffffff81ffdc")
    got8 = _check(values, widths, offsets, 8)
    assert bytes(got8.cpu().numpy()[0]) == bytes.fromhex("ffffffff81ffdc03")


def test_deposit_kernel_layouts(dev):
    """Non-contiguous planes (a column slice, a transpose) are copied into
    the kernel's layout and give the same bytes; F = 1; no fields."""
    case = deposit_case(11, 256, f=9, k=200)
    v, w, o = _planes(case, dev)
    wide = [torch.stack([x, torch.zeros_like(x)], -1).reshape(9, 400)
            for x in (v, w, o)]
    sliced = [x[:, ::2] for x in wide]
    assert not sliced[0].is_contiguous()
    assert torch.equal(_check(*sliced, 256), _check(v, w, o, 256))
    trans = [x.t().contiguous().t() for x in (v, w, o)]
    assert not trans[0].is_contiguous()
    _check(*trans, 256)
    _check(*_planes(deposit_case(12, 212, f=1, k=1151), dev), 212)
    empty = torch.zeros((3, 0), dtype=torch.int64, device=dev)
    assert torch.equal(_check(empty, empty, empty, 212),
                       torch.zeros((3, 212), dtype=torch.uint8, device=dev))


def test_deposit_wrapper_refuses(dev):
    z = torch.zeros((2, 5), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="shape"):
        bitdeposit.deposit_fields(z, z[:, :4], z, 212)
    with pytest.raises(RuntimeError, match="deposit_fields"):
        bitdeposit.deposit_fields(z, z, z, 1 << 20)   # past shared memory


def _capture(mod, fn):
    """Run fn() and return the (values, widths, offsets, total_bytes) of
    every deposit that ``mod``'s packer makes."""
    calls, real = [], mod.deposit_fields

    def spy(*a):
        calls.append(a)
        return real(*a)
    mod.deposit_fields = spy
    try:
        fn()
    finally:
        mod.deposit_fields = real
    return calls


def test_deposit_kernel_at_the_cells_shapes(dev):
    """The deposits of one batch call of each cell (64 tracks x 512
    frames, noise in place of music): ATRAC1's one [65,536, 1,151] int64
    deposit into 212 bytes, ATRAC3's two int32 per-channel deposits
    [32,768, K] into 256 bytes.  Kernel equals plain; no operation in the
    kernel's route synchronises with the host."""
    rng = np.random.default_rng(17)
    pcm1 = torch.from_numpy((0.3 * rng.standard_normal((64, 2, 512 * 512)))
                            .astype(np.float32)).to(dev)
    planes1, _ = enc1.encode_frames_chunk(pcm1, None, None)
    merged = {k: planes1[k].transpose(1, 2).reshape((-1,) + planes1[k].shape[3:])
              for k in AT1_PLANES}
    (at1,) = _capture(pack1, lambda: pack1.pack_device(merged))
    del pcm1, planes1, merged
    pcm3 = torch.from_numpy((0.3 * rng.standard_normal((64, 2, 512 * 1024)))
                            .astype(np.float32)).to(dev)
    planes3, _ = enc3.encode_frames_chunk(pcm3, None, None,
                                          no_gain_control=False, no_tonal=False)
    at3 = _capture(pack3, lambda: pack3.pack_device_batch(planes3, 384))
    del pcm3, planes3
    assert tuple(at1[0].shape) == (65536, 1151) and at1[3] == 212
    assert len(at3) == 2 and all(a[0].shape[0] == 32768 and a[3] == 256
                                 and a[0].dtype == torch.int32 for a in at3)
    for args in [at1] + at3:
        _check(*args, reference=False)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            bitdeposit.deposit_fields(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.empty_cache()


def _t(planes, dev):
    return {k: (_t(v, dev) if isinstance(v, dict)
                else torch.from_numpy(np.ascontiguousarray(v)).to(dev))
            for k, v in planes.items()}


@pytest.mark.parametrize("case,launches", [
    ("at1", 1), ("at3", 2), ("at3_js", 2), ("at3_js_mono", 2), ("at3p", 1)])
def test_device_packers_equal_host_on_goldens(dev, case, launches):
    """Each device packer on the card equals its host ``frame.pack`` on a
    golden's encode, through ``launch.deposit`` launches of the kernel (one
    a deposit: ATRAC1's one, one an ATRAC3 channel, ATRAC3+'s one) with
    no ``host_sync`` counted under ``deposit_fields``."""
    if case == "at1":
        pcm = np.load(os.path.join(GOLDEN, "at1_golden.npz"))["pcm_in"]
        planes = enc1.encode_track(pcm, device="cuda")
        units = {k: np.swapaxes(planes[k], 0, 1).reshape(
            (-1,) + planes[k].shape[2:]) for k in AT1_PLANES}
        host, pack = frame1.pack(units), lambda: pack1.pack_device(_t(units, dev))
    elif case == "at3p":
        pcm = np.load(os.path.join(GOLDEN, "at3p_golden.npz"))["pcm_mixed"]
        planes = enc3p.encode_track(pcm, device="cuda")
        host = frame3p.pack(planes, 2)
        pack = lambda: pack3p.pack_device(_t(planes, dev), 2)  # noqa: E731
    else:
        js = case != "at3"
        g = np.load(os.path.join(GOLDEN, "at3_js_golden.npz" if js
                                 else "at3_tonal_golden.npz"))
        pcm = g["pcm_mono"] if case == "at3_js_mono" else g["pcm_in"]
        fb = 192 if js else 384
        planes = enc3.encode_track(pcm, frame_bytes=fb, js=js,
                                   no_gain_control=False, no_tonal=False,
                                   device="cuda")
        host = frame3.pack(planes, fb, js=js)
        pack = lambda: pack3.pack_device(_t(planes, dev), fb, js=js)  # noqa: E731
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    got = pack()
    recs = trace.snapshot()["records"]
    trace.disable()
    assert np.array_equal(got.cpu().numpy(), host), \
        f"{int((got.cpu().numpy() != host).sum())} bytes differ"
    assert trace.counter("launch.deposit") == launches
    deps = [r for r in recs if r["name"] == "deposit_fields"]
    assert len(deps) == launches
    assert not any(r["counts"].get("host_sync") for r in deps)
