"""Kernel A (ops/quant_cost.py): the plain PyTorch version against the JAX
package's XLA twin (bitalloc._plain_costs_xla) and against the Pallas
kernel (ops/pallas_quant.quant_cost_plain) in interpret mode.

Tolerances: vlc (integer bit counts) equal; err (e1/e2) within rtol=1e-6,
because e1 is an f32 sum of 128 squares taken in another order.  The CUDA
kernel itself runs only on the card (chip_smoke.py phase 3)."""
import os
import re

import jax.numpy as jnp
import numpy as np
import torch

from atracdenc_tpu.models.atrac3 import bitalloc as jba
from atracdenc_tpu.models.atrac3 import tables as T
from atracdenc_tpu.ops.pallas_quant import quant_cost_plain as pallas_plain
from atracdenc_tpu_torch.ops import quant_cost
from atracdenc_tpu_torch.testing import assert_close, assert_equal, cpu_setup, t

cpu_setup()
MASK = T.GATHER_MASK


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    x = 0.999 * np.tanh(rng.standard_normal((n, 32, 128)))
    x *= 10.0 ** rng.uniform(-3, 0, (n, 32, 1))
    return (x * MASK).astype(np.float32)


def _edge_inputs():
    """Silence (0/0 -> NaN -> 0), all-tiny blocks (e2 == 0 -> inf ->
    FLT_MAX) and exact half-integer multiples (rounding ties)."""
    rng = np.random.default_rng(3)
    x = np.zeros((3, 32, 128), np.float32)
    x[1] = 1e-6
    x[2] = (np.round(rng.uniform(-15, 15, (32, 128))) + 0.5) / 15.5
    return (np.clip(x, -0.99999, 0.99999) * MASK).astype(np.float32)


def _xla(scaled):
    err, vlc, _ = jba._plain_costs_xla(jnp.asarray(scaled), MASK)
    err = np.asarray(err)
    fmax = np.finfo(np.float32).max
    return np.where(np.isnan(err), 0.0, np.where(np.isinf(err), fmax, err)
                    ).astype(np.float32), np.asarray(vlc)


def test_plain_matches_xla_twin():
    for scaled in (_inputs(0, 6).reshape(2, 3, 32, 128), _edge_inputs()):
        err_j, vlc_j = _xla(scaled)
        err_t, vlc_t = quant_cost.quant_cost_plain(t(scaled), t(MASK))
        assert_equal(vlc_j, vlc_t, "vlc")
        assert_close(err_j, err_t, "err", rtol=1e-6, atol=0.0)


def test_plain_matches_pallas_interpret():
    scaled = _inputs(1, 2)
    err_p, vlc_p = pallas_plain(jnp.asarray(scaled), MASK, interpret=True)
    err_t, vlc_t = quant_cost.quant_cost_plain(t(scaled), t(MASK))
    assert_equal(vlc_p, vlc_t, "vlc")
    assert_close(err_p, err_t, "err", rtol=1e-6, atol=0.0)


def _cuh():
    src = os.path.join(os.path.dirname(quant_cost.__file__), "..", "csrc",
                       "quant_block.cuh")
    with open(src) as fp:
        return fp.read()


def test_cuda_vlc_table_literal_matches_tables():
    """The codebook literal of kernels A and D (csrc/quant_block.cuh), from
    which they fill their shared-memory table, is the step-function
    codebook of the JAX package (bitalloc._vlc_bits_arith)."""
    body = re.search(r"c_vlc_step\[7\]\[64\] = \{(.*?)\};", _cuh(), re.S)
    rows = re.findall(r"\{([^{}]*)\}", body.group(1))
    lit = np.array([[int(v) for v in r.split(",")] for r in rows], np.int32)
    assert_equal(quant_cost.vlc_step_table(), lit, "vlc step table")
    idx = np.arange(64)
    for sel in range(7):
        ref = np.asarray(jba._vlc_bits_arith(jnp.asarray(idx), sel))
        assert np.array_equal(ref, lit[sel]), sel


def test_vlc_lengths_do_not_depend_on_the_sign():
    """Kernels A and D index their table by |q|: the symbols of q and -q
    (2|q| - 1 and 2|q|) have one length in every codebook, the clamp at
    index 63 included (|q| = 32)."""
    tab = quant_cost.vlc_step_table()
    assert np.array_equal(tab[:, 1:63:2], tab[:, 2:64:2])
    m = torch.arange(-32, 33, dtype=torch.int32)
    for sel in range(7):
        bits = quant_cost.vlc_bits(quant_cost.vlc_index(m), sel)
        assert torch.equal(bits, bits.flip(0)), sel


def test_packed_sums_fit_their_fields():
    """A block's sums of q^2 and of VLC bits travel as one 32-bit word, the
    squares below kBitsShift and the bits above.  Scaled values have
    |x| <= 1, so |q| <= round(31.5) = 32, below the table's zero entry."""
    shift = int(re.search(r"kBitsShift = (\d+);", _cuh()).group(1))
    zero_entry = int(re.search(r"kZeroEntry = (\d+);", _cuh()).group(1))
    q_max = int(np.round(T.MAX_QUANT.max() * np.float32(1.0)))
    assert q_max == 32 and q_max < zero_entry < 64
    assert T.MAX_SPECS_PER_BLOCK * q_max ** 2 < 1 << shift
    longest = max(int(quant_cost.vlc_step_table().max()),
                  int(quant_cost.pair_bits_table().max()))
    assert T.MAX_SPECS_PER_BLOCK * longest < 1 << (32 - shift)


def test_dense_passes_cover_every_block_once():
    """c_pass packs a frame's blocks into 9 warp passes: a block of len
    values takes len / 4 lanes, a pass at most 32 lanes, every BFU is in
    exactly one pass, and the repo's mask is the mask by length that the
    dense passes assume (the kernels read no mask byte beyond it)."""
    body = re.search(r"c_pass\[9\]\[3\] = \{(.*?)\};", _cuh(), re.S)
    rows = [[int(v) for v in r.split(",")]
            for r in re.findall(r"\{([^{}]*)\}", body.group(1))]
    assert len(rows) == 9
    seen = []
    for lg, first, n in rows:
        assert n << lg <= 32
        for b in range(first, first + n):
            assert int(T.SPECS_PER_BLOCK[b]) == 4 << lg, b
            seen.append(b)
    assert seen == list(range(32))
    by_len = np.arange(128)[None, :] < T.SPECS_PER_BLOCK[:, None]
    assert np.array_equal(T.GATHER_MASK, by_len)
