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

from atracdenc_tpu.models.atrac1 import bitalloc as jba
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
    assert at1_alloc.launches == 0
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
