"""Kernel E's plain version (``models/atrac1/bitalloc.allocate``, the route
``ops/at1_alloc.at1_allocate_block`` takes on the CPU) against the JAX
package's ATRAC1 rate control: the XLA ``allocate`` and the Pallas kernel
``at1_allocate_block`` in interpret mode.  The outputs are decisions
(bfu_idx, wordlens) and must be equal: every float op of the allocation is
elementwise in the XLA order and every sum is an integer sum.  The CUDA
kernel itself runs only on the card (chip_smoke.py,
tests/test_torch_cuda_kernels.py)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atracdenc_tpu.models.atrac1 import bitalloc as jba
from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.models.atrac1 import bitalloc, encoder
from atracdenc_tpu_torch.ops import at1_alloc
from atracdenc_tpu_torch.testing import assert_equal, cpu_setup, t

cpu_setup()
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _random_inputs(seed, c=2, f=8):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, (c, f, 52)).astype(np.int32),
            (10.0 ** rng.uniform(-9, 2, (c, f, 52))).astype(np.float32),
            rng.integers(0, 2, (c, f, 3)) > 0,
            (10.0 ** rng.uniform(-4, 0, (c, f))).astype(np.float32))


@pytest.fixture(scope="module")
def stress_inputs():
    """The allocation inputs of one port encode of at1_stress (its planes
    equal the JAX encoder's, tests/test_torch_at1_codec.py)."""
    pcm = np.load(os.path.join(GOLDEN, "at1_stress_pcm.npz"))["pcm_in"]
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(encoder, "at1_allocate_block",
                   lambda *a, **kw: calls.append(a) or at1_alloc.at1_allocate_block(*a, **kw))
        encoder.encode_frames(t(pcm))
    (args,) = calls
    return tuple(np.ascontiguousarray(a.numpy()) for a in args)


@pytest.mark.parametrize("const", [0, 1, 4, 8])
def test_allocate_equals_xla_and_pallas(const):
    ins = _random_inputs(3)
    idx, wl = at1_alloc.at1_allocate_block(*(t(x) for x in ins),
                                           bfu_idx_const=const)
    assert trace.counter("launch.at1_alloc") == 0
    for use_pallas in (False, True):
        idx_j, wl_j = jba.allocate(*(jnp.asarray(x) for x in ins),
                                   bfu_idx_const=const, use_pallas=use_pallas)
        assert_equal(idx_j, idx, f"bfu_idx, pallas={use_pallas}")
        assert_equal(wl_j, wl, f"wordlen, pallas={use_pallas}")


@pytest.mark.parametrize("const", [0, 1, 4, 8])
def test_allocate_on_stress_encode_inputs(stress_inputs, const):
    """Real inputs: short windows, the ATH gate, silence and shrink rounds."""
    idx, wl = bitalloc.allocate(*(t(x) for x in stress_inputs),
                                bfu_idx_const=const)
    for use_pallas in (False, True):
        idx_j, wl_j = jba.allocate(*(jnp.asarray(x) for x in stress_inputs),
                                   bfu_idx_const=const, use_pallas=use_pallas)
        assert_equal(idx_j, idx, f"bfu_idx, pallas={use_pallas}")
        assert_equal(wl_j, wl, f"wordlen, pallas={use_pallas}")
    if const == 0:
        assert len(np.unique(idx.numpy())) > 1, "no shrink round ran"


def test_calc_bits_allocation_at_many_lambdas():
    """One allocation per lambda across [-3, 15] and every bfu_num: the
    trunc of the blended allocation at its knife edges."""
    sfi, energy, short, loud = _random_inputs(5, c=1, f=64)
    rng = np.random.default_rng(5)
    shift = rng.uniform(-3, 15, (1, 64)).astype(np.float32)
    shift[0, :8] = np.float32(0.5) * np.arange(8)       # exact halves
    bfu_num = rng.choice(np.asarray([20, 28, 32, 36, 40, 44, 48, 52]),
                         (1, 64)).astype(np.int32)
    ref = jba.calc_bits_allocation(*(jnp.asarray(x) for x in
                                     (sfi, energy, short, loud, shift, bfu_num)))
    got = bitalloc.calc_bits_allocation(*(t(x) for x in
                                          (sfi, energy, short, loud, shift, bfu_num)))
    assert_equal(ref, got, "calc_bits_allocation")


def test_tables_match_the_jax_package():
    """Kernel E takes its tables from ``bitalloc.consts``: the ATH floor,
    the boost walk and the table values are the JAX package's."""
    np.testing.assert_array_equal(np.asarray(jba._at1_ath_long(), np.float32),
                                  bitalloc.ath_long())
    assert bitalloc.BOOST_ENTRIES == jba._BOOST_ENTRIES
    assert (bitalloc.BISECT_STEPS, bitalloc.SHRINK_ROUNDS) == \
        (jba._BISECT_STEPS, jba._SHRINK_ROUNDS)


def _layout(case):
    """(sfi, energy, short_flags, loudness) [S=2, C=2, F=5, ...] CPU tensors
    laid out as a caller hands them to kernel E, and the tensors that must
    reach the kernel with no copy."""
    sfi, energy, short, loud = (t(x) for x in _random_inputs(9, c=4, f=5))
    sfi, energy, short = (x.reshape((2, 2, 5) + x.shape[2:])
                          for x in (sfi, energy, short))
    base = loud.reshape(2, 2, 5)[:, 0].contiguous()     # [S, F]
    enc_loud = base[..., None, :].expand(2, 2, 5)   # encoder._encode_specs
    if case == "encoder, auto windows":
        return (sfi, energy, short, enc_loud), [sfi, energy, short, base]
    if case == "encoder, fixed windows":
        fixed = encoder._fixed_masks(5, (2, 2, 5), torch.device("cpu"))
        return (sfi, energy, fixed, enc_loud), [sfi, energy, fixed, base]
    if case == "contiguous loudness":
        return (sfi, energy, short, loud.reshape(2, 2, 5)), [sfi, energy, short]
    if case == "chunk slices and casts":
        # a frame slice of longer masks (encoder._encode_window), int64 sfi
        # and loudness transposed: each copied into the kernel's layout
        wide = torch.cat([short, short[..., :1, :]], dim=-2)[..., :5, :]
        return (sfi.long(), energy, wide,
                loud.reshape(2, 5, 2).transpose(1, 2)), []
    raise KeyError(case)


@pytest.mark.parametrize("case", ["encoder, auto windows",
                                  "encoder, fixed windows",
                                  "contiguous loudness",
                                  "chunk slices and casts"])
def test_kernel_rows_read_the_callers_layouts(case):
    """``at1_alloc.rows``, the layouts kernel E reads, emulated here as the
    kernel indexes them: every row sees its own sfi, energy, short flags
    and loudness, and the encoder's tensors pass with no copy."""
    ins, in_place = _layout(case)
    sfi, energy, flags, fstride, loud, c, f = at1_alloc.rows(*ins)
    n = ins[3].numel()
    r = np.arange(n)
    assert sfi.dtype == torch.int32 and energy.dtype == torch.float32
    assert all(x.is_contiguous() for x in (sfi, energy, flags, loud))
    np.testing.assert_array_equal(sfi.numpy().reshape(n, 52),
                                  ins[0].reshape(n, 52).numpy())
    np.testing.assert_array_equal(energy.numpy().reshape(n, 52),
                                  ins[1].reshape(n, 52).numpy())
    got_flags = flags.reshape(-1).numpy()[(r * fstride)[:, None] + np.arange(3)]
    np.testing.assert_array_equal(got_flags, ins[2].reshape(n, 3).numpy())
    got_loud = loud.reshape(-1).numpy()[r // (c * f) * f + r % f]
    np.testing.assert_array_equal(got_loud, ins[3].reshape(n).numpy())
    passed = {x.data_ptr() for x in (sfi, energy, flags, loud)}
    for x in in_place:
        assert x.data_ptr() in passed
