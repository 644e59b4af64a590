"""ATRAC3+'s spectrum section (``device_pack.spectrum_fields``) on the CPU:
its plain version's packed layout of 2,048 slots a frame, its offsets and
section bits, tied to the encoder's table costing (``_qu_table_cost``).
Kernel I against this version is ``test_torch_cuda_at3p_spectrum.py``, on
the card; the bytes of the packer that runs it, ``test_torch_at3p_stages.py``
(against ``frame.pack`` and the JAX packer)."""
import numpy as np
import pytest
import torch

from atracdenc_tpu_torch.models.atrac3p import device_pack as dp
from atracdenc_tpu_torch.models.atrac3p import encoder
from atracdenc_tpu_torch.models.atrac3p import tables as T
from atracdenc_tpu_torch.testing import cpu_setup, spectrum_case

cpu_setup()


def _slot_map():
    """Per slot [2048]: its QU, its index in the QU, and the QU's length."""
    qu = np.repeat(np.arange(32), T.SPECS_PER_BLOCK)
    g = np.arange(2048) - T.SPECS_START[qu]
    return qu, g, T.SPECS_PER_BLOCK[qu]


def _chosen_cost(mant, spec_tab):
    """[F, 32] the encoder's bits for each QU at the table it chose."""
    cost = torch.cat([torch.stack([encoder._qu_table_cost(
        mant[:, q0:q1, :ln], 7 * i + wl - 1) for i in range(8)], dim=-1)
        for q0, q1, wl, ln in dp._qu_classes()], dim=-2)
    return cost.gather(-1, spec_tab.long()[..., None])[..., 0]


def _spectrum(mant, spec_tab, num_qu, seed):
    pos = np.random.default_rng(seed).integers(0, 8000, len(num_qu))
    args = [torch.from_numpy(a.astype(np.int32))
            for a in (mant, spec_tab, num_qu, pos)]
    return args, dp.spectrum_fields(*args)


@pytest.mark.parametrize("seed", [3, 2500000101])
def test_spectrum_fields_packed_layout(seed):
    """Every table, every numQU, extremes and all-zero QUs: offsets are pos
    plus the exclusive prefix of the widths in slot order, a slot is empty
    past numQU and past its QU's code groups (and only there, at the
    range's ends), and the section's bits are the encoder's costs of the
    chosen tables summed below numQU."""
    mant, spec_tab, num_qu = spectrum_case(seed, f=40)
    (m, tab, nq, pos), (values, widths, offsets, bits) = _spectrum(
        mant, spec_tab, num_qu, seed)
    assert values.dtype == torch.int64 and widths.dtype == torch.int32
    assert offsets.dtype == torch.int32 and bits.dtype == torch.int32
    assert values.shape == widths.shape == offsets.shape == (40, 2048)
    assert bits.shape == (40,)
    w = widths.numpy().astype(np.int64)
    excl = np.cumsum(w, axis=1) - w
    assert np.array_equal(offsets.numpy(), pos.numpy()[:, None] + excl)
    assert np.array_equal(bits.numpy(), w.sum(1))

    qu, g, ln = _slot_map()
    nc = T.SPECTRA_TABS[7 * spec_tab[:, qu] + T.FIXED_WORDLEN[qu] - 1][..., 1]
    coded = (qu[None, :] < num_qu[:, None]) & (g[None, :] < ln // nc)
    assert not w[~coded].any() and not values.numpy()[~coded].any()
    assert (w[coded] > 0).all()                  # every code has a length
    assert (values.numpy() >> np.maximum(w, 1) == 0).all()   # fits its width

    cost = _chosen_cost(m, tab).numpy()
    below = np.arange(32)[None, :] < num_qu[:, None]
    assert np.array_equal(bits.numpy(), (cost * below).sum(1))
    assert set(num_qu.tolist()) == set(range(1, 33))


def test_spectrum_bits_equal_the_encoders_spec_bits():
    """On the encoder's own planes (its scaler, wordlens and best-of-8
    choice over random spectra), the section bits at each numQU are
    ``spec_bits`` summed over the QUs below it."""
    rng = np.random.default_rng(7)
    specs = torch.from_numpy((rng.standard_normal((6, 2048))
                              * np.exp(rng.uniform(-6, 2, (6, 1))))
                             .astype(np.float32))
    _, mant, spec_tab, spec_bits = encoder._spectral_planes(specs)
    for nq in (1, 9, 17, 28, 32):
        num_qu = np.full(6, nq, np.int32)
        _, (_, _, _, bits) = _spectrum(mant.numpy(), spec_tab.numpy(), num_qu, nq)
        assert np.array_equal(bits.numpy(),
                              spec_bits[:, :nq].sum(-1).numpy()), nq
    assert int(spec_bits.sum()) > 0


def test_spectrum_kernel_wrapper_refuses():
    """Kernel I's launch checks dtypes, shapes and the device before it
    reaches the library (a CPU tensor never gets there)."""
    mant, spec_tab, num_qu = (torch.from_numpy(a)
                              for a in spectrum_case(1, f=4))
    pos = torch.zeros(4, dtype=torch.int32)
    good = (mant, spec_tab, num_qu, pos)
    for bad in ((mant.long(), spec_tab, num_qu, pos),
                (mant[:, :, :64], spec_tab, num_qu, pos),
                (mant, spec_tab[:3], num_qu, pos),
                (mant, spec_tab, num_qu, pos.long())):
        with pytest.raises(ValueError, match="int32"):
            dp._spectrum_fields_cuda(*bad)
    with pytest.raises(ValueError, match="CUDA"):
        dp._spectrum_fields_cuda(*good)
