"""The port's device packers against the JAX package's and the shared host
packers (CPU): ``ops/bitdeposit.deposit_fields``, the ATRAC3
``pack_device`` / ``pack_device_batch`` and the ATRAC1 ``pack_device``.
Bytes are integers, so every comparison is exact equality."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atracdenc_tpu.models.atrac1 import frame as at1_frame
from atracdenc_tpu.models.atrac3 import frame as at3_frame
from atracdenc_tpu.ops.bitdeposit import deposit_fields as jax_deposit
from atracdenc_tpu.utils.bitpack import _pack_frames_np
from atracdenc_tpu_torch.models.atrac1 import device_pack as dp1
from atracdenc_tpu_torch.models.atrac3 import device_pack as dp3
from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.ops.bitdeposit import deposit_fields
from atracdenc_tpu_torch.testing import assert_equal, cpu_setup, deposit_case
from test_device_pack import _at3_planes

cpu_setup()


def _tensors(planes):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in planes.items()}


def _random_fields(seed, f=11, k=257):
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, 25, (f, k)).astype(np.int32)
    widths[rng.random((f, k)) < 0.3] = 0
    values = (rng.integers(0, 1 << 24, (f, k))
              & ((1 << widths.astype(np.int64)) - 1)).astype(np.uint32)
    offsets = np.zeros((f, k), np.int64)
    np.cumsum(widths[:, :-1], axis=1, out=offsets[:, 1:])
    return values, widths, offsets.astype(np.int32)


@pytest.mark.parametrize("total_bytes,case", [
    pytest.param(1600, "random", id="1600"), pytest.param(212, "random", id="212"),
    pytest.param(212, "edges", id="edges-212"),
    pytest.param(256, "edges", id="edges-256"),
    pytest.param(7, "edges", id="edges-7"), pytest.param(1, "edges", id="edges-1")])
def test_deposit_fields_vs_jax(total_bytes, case):
    """Random fields in a shuffled order; at 212 bytes most fields lie past
    the frame and must be dropped as the JAX one-hot drops them.  The edge
    cases (``testing.deposit_case``): widths up to 32, a 32-bit field from
    bit 31 across two words, a frame filled to its last bit, fields partly
    and wholly past the end, and frames of 1 and 7 bytes (not whole words).
    CPU tensors take the plain version and launch nothing."""
    if case == "random":
        values, widths, offsets = _random_fields(0)
        perm = np.random.default_rng(1).permutation(values.shape[1])
        values, widths, offsets = (values[:, perm], widths[:, perm],
                                   offsets[:, perm])
        fits = np.arange(len(values)) \
            if total_bytes * 8 >= int((offsets + widths).max()) else []
    else:
        values, widths, offsets, fits = deposit_case(3, total_bytes)
    ref = np.asarray(jax_deposit(jnp.asarray(values), jnp.asarray(widths),
                                 jnp.asarray(offsets), total_bytes))
    got = deposit_fields(torch.from_numpy(values.astype(np.int64)),
                         torch.from_numpy(widths), torch.from_numpy(offsets),
                         total_bytes)
    assert trace.counter("launch.deposit") == 0
    assert_equal(ref, got, "deposit_fields")
    if len(fits):
        v, w, o = values[fits], widths[fits], offsets[fits]
        order = np.argsort(o, axis=1, kind="stable")
        host = _pack_frames_np(np.take_along_axis(v, order, 1),
                               np.take_along_axis(w, order, 1), total_bytes)
        assert_equal(host, got[fits], "deposit_fields vs host")


@pytest.mark.parametrize("js,tonal,mono", [
    (False, False, False), (False, True, False), (True, False, False),
    (True, True, False), (False, True, True), (True, True, True)])
def test_at3_pack_device_equals_host(js, tonal, mono):
    planes = _at3_planes(np.random.default_rng(7), 9, tonal)
    if mono:
        planes = {k: v if k == "ms_shift" else v[:1] for k, v in planes.items()}
    ref = at3_frame.pack(planes, 384, js=js)
    assert_equal(ref, dp3.pack_device(_tensors(planes), 384, js=js),
                 "pack_device")


@pytest.mark.parametrize("js", [False, True])
def test_at3_pack_device_batch_equals_host(js):
    streams = [_at3_planes(np.random.default_rng(s), 5, True) for s in (1, 2, 3)]
    # the encoder's batched layout: [S, F] for ms_shift, else [S, C, F, ...]
    batch = {k: np.stack([p[k] for p in streams]) for k in streams[0]}
    got = dp3.pack_device_batch(_tensors(batch), 384, js=js)
    ref = np.stack([at3_frame.pack(p, 384, js=js) for p in streams])
    assert_equal(ref, got, "pack_device_batch")


def test_at1_pack_device_equals_host():
    rng = np.random.default_rng(3)
    n = 17
    # total bits stay under the 212-byte unit, as real allocations do
    wl = np.where(rng.random((n, 52)) < 0.3, rng.integers(2, 5, (n, 52)),
                  0).astype(np.int32)
    wl[0] = 0                                   # a silent frame
    wl[1, :8] = 16                              # the widest mantissas
    lim = np.where(wl >= 2, (1 << np.maximum(wl - 1, 1)) - 1, 0)
    planes = {
        "short_mask": rng.random((n, 3)) < 0.3,
        "bfu_idx": rng.integers(0, 8, (n,)).astype(np.int32),
        "wordlen": wl,
        "sfi": rng.integers(0, 64, (n, 52)).astype(np.int32),
        "mant": np.clip(rng.integers(-40000, 40000, (n, 52, 20)),
                        -lim[..., None], lim[..., None]).astype(np.int32),
    }
    assert_equal(at1_frame.pack(planes), dp1.pack_device(_tensors(planes)),
                 "at1 pack_device")
