"""The CUDA kernels against their plain PyTorch versions, on the card, at
shapes and values the main path rarely gives them: ragged row and frame
counts, one-candidate and full-length scans, silent and tiny blocks,
rounding ties, EA candidates on the 0.25 boundary, dense tonal planes,
both rate-control modes and the single bisection, and for the ATRAC1 rate
control every BFU gated, every band short and every --bfuidxconst value.

Needs a GPU and nvcc, so every test is marked ``cuda`` and skips elsewhere.
The machine with the card has no JAX, and tests/conftest.py imports it, so
run this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances are chip_smoke.py's: B, C, E and F bit-equal (B's NaN energies
of wordlen-0 rows counted equal on both sides); A's and D's vlc
equal and their err within 4 ulp (the plain lanes' e1 is an f32 sum taken
in another order; D's EA lanes share the plain version's order).
"""
import numpy as np
import pytest
import torch

from atracdenc_tpu_torch.ops import at1_alloc, greedy, quant_cost, rate_control
from atracdenc_tpu_torch.models.atrac3 import tables as T

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _ulp(a, b):
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def _quant_inputs(n):
    rng = np.random.default_rng(n)
    x = 0.999 * np.tanh(rng.standard_normal((n, 32, 128)))
    x *= 10.0 ** rng.uniform(-3, 0, (n, 32, 1))
    x[0] = 0.0                                   # silence: 0/0 -> 0
    if n > 1:
        x[1] = 1e-6                              # e2 == 0: inf -> FLT_MAX
    if n > 2:                                    # exact rounding ties
        x[2] = (np.round(rng.uniform(-15, 15, (32, 128))) + 0.5) / 15.5
    return (np.clip(x, -0.99999, 0.99999) * T.GATHER_MASK).astype(np.float32)


def _by_bfu(fn):
    """[32, 128] f64 with block b's row made by fn(b, length)."""
    out = np.zeros((32, 128))
    for b in range(32):
        ln = int(T.SPECS_PER_BLOCK[b])
        out[b, :ln] = fn(b, ln)
    return out


def _quant_case(name):
    """(x [n, 32, 128] f32, mask [32, 128] bool): inputs that the dense
    passes, the packed sums, the compaction and the rank of kernels A and D
    could get wrong."""
    rng = np.random.default_rng(sum(name.encode()))
    mask = T.GATHER_MASK.copy()
    k31 = lambda ln: rng.integers(0, 30, ln)                 # noqa: E731
    if name == "all_candidates":
        # t = k + 0.3 at wordlen 7: every value rounds down and is an
        # eligible candidate, the longest rank and recurrence there are
        frames = [_by_bfu(lambda b, ln: (k31(ln) + 0.3) / 31.5)] * 2
    elif name == "no_candidates":
        # negative values are never candidates; integers sit at |delta| 0.5
        frames = [_by_bfu(lambda b, ln: -rng.random(ln)),
                  _by_bfu(lambda b, ln: k31(ln) / 31.5)]
    elif name == "tied_deltas":
        # a few distinct values a block: equal |delta| at many indices, so
        # the order is the index order
        frames = [_by_bfu(lambda b, ln: rng.choice(
            [0.3 / 1.5, 1.3 / 2.5, 2.4 / 3.5, 9.3 / 31.5, 9.7 / 31.5], ln))
            for _ in range(3)]
    elif name == "up_and_down":
        # blocks that round down (the pass moves up) beside blocks that
        # round up (it moves down), in one frame
        frames = [_by_bfu(lambda b, ln: (k31(ln) + (0.3 if b % 2 else 0.7))
                          / 31.5) for _ in range(2)]
    elif name == "zeros":
        frames = [np.zeros((32, 128))] * 2
    elif name == "nan_blocks":
        f = _by_bfu(lambda b, ln: rng.uniform(-0.9, 0.9, ln))
        f[[3, 12, 20, 27, 31]] = np.nan
        f[5, 2] = np.nan
        f[30, 77] = np.nan
        frames = [f, _by_bfu(lambda b, ln: rng.uniform(-0.9, 0.9, ln))]
    elif name == "garbage_behind_the_mask":
        # inf and NaN at the positions the mask switches off
        f = np.full((32, 128), np.inf)
        f[::2] = np.nan
        f = np.where(T.GATHER_MASK, _by_bfu(
            lambda b, ln: rng.uniform(-0.9, 0.9, ln)), f)
        frames = [f, -f]
    elif name == "mantissas_at_31":
        frames = [_by_bfu(lambda b, ln: rng.choice([-0.99999, 0.99999], ln)),
                  _by_bfu(lambda b, ln: np.full(ln, 0.99999)),
                  _by_bfu(lambda b, ln: np.full(ln, -0.99999))]
    elif name == "holes_in_the_mask":
        # a mask with gaps inside the blocks' lengths
        mask &= rng.random((32, 128)) < 0.7
        frames = [rng.uniform(-0.9, 0.9, (32, 128)) for _ in range(3)]
    else:
        raise KeyError(name)
    return np.stack(frames).astype(np.float32), mask


QUANT_CASES = ["all_candidates", "no_candidates", "tied_deltas", "up_and_down",
               "zeros", "nan_blocks", "garbage_behind_the_mask",
               "mantissas_at_31", "holes_in_the_mask"]


def _check_quant(kernel, plain, x, mask, dev):
    x = torch.from_numpy(x).to(dev)
    mask = torch.as_tensor(mask, device=dev)
    err_k, vlc_k = kernel(x, mask)
    err_p, vlc_p = plain(x, mask)
    torch.cuda.synchronize()
    assert torch.equal(vlc_k, vlc_p), int((vlc_k != vlc_p).sum())
    assert int(_ulp(err_k, err_p).max()) <= 4


# n = 1, and counts that are no multiple of the CTAs either kernel launches
@pytest.mark.parametrize("n", [1, 3, 37, 1000, 4099])
def test_quant_cost_kernel(dev, n):
    _check_quant(quant_cost.quant_cost_plain, quant_cost.quant_cost_torch,
                 _quant_inputs(n), T.GATHER_MASK, dev)


@pytest.mark.parametrize("case", QUANT_CASES)
def test_quant_cost_kernel_cases(dev, case):
    _check_quant(quant_cost.quant_cost_plain, quant_cost.quant_cost_torch,
                 *_quant_case(case), dev)


@pytest.mark.parametrize("n", [1, 3, 37, 1000, 4099])
def test_quant_cost_full_kernel(dev, n):
    _check_quant(quant_cost.quant_cost_full, quant_cost.quant_cost_full_torch,
                 _quant_inputs(n), T.GATHER_MASK, dev)


@pytest.mark.parametrize("case", QUANT_CASES)
def test_quant_cost_full_kernel_cases(dev, case):
    _check_quant(quant_cost.quant_cost_full, quant_cost.quant_cost_full_torch,
                 *_quant_case(case), dev)


def test_quant_cost_full_kernel_edges(dev):
    """Candidates straddling the |delta| < 0.25 boundary at wordlen 2, and
    values a hair from the clip, in every EA group."""
    rng = np.random.default_rng(3)
    x = np.zeros((3, 32, 128), np.float32)
    x[0] = (np.round(rng.uniform(-2, 2, (32, 128)))
            + rng.choice([0.249, 0.25, 0.251, 0.75], (32, 128))) / 2.5
    x[1] = rng.choice([-0.9999, 0.9999], (32, 128))
    x[2] = (np.round(rng.uniform(-31, 31, (32, 128))) + 0.25) / 31.5
    x = (np.clip(x, -0.9999, 0.9999) * T.GATHER_MASK).astype(np.float32)
    _check_quant(quant_cost.quant_cost_full, quant_cost.quant_cost_full_torch,
                 x, T.GATHER_MASK, dev)


def test_quant_memo_kernels_agree(dev):
    """Kernel D's memo equals the memo on kernels A and B bit for bit (one
    e1 order, one device code for the plain lanes), on every case."""
    from atracdenc_tpu_torch.models.atrac3 import bitalloc
    for case in ["all_candidates", "tied_deltas", "up_and_down", "nan_blocks"]:
        x, mask = _quant_case(case)
        x = torch.from_numpy(x).to(dev)
        mask = torch.as_tensor(mask, device=dev)
        a = bitalloc.quant_tensors(x, mask, fused_memo=False)
        d = bitalloc.quant_tensors(x, mask, fused_memo=True)
        for k in ("err", "clc", "vlc"):
            assert torch.equal(a[k].view(torch.int32), d[k].view(torch.int32)), \
                (case, k)


@pytest.mark.parametrize("rows,L", [(1, 1), (129, 7), (1000, 32), (4097, 128)])
def test_greedy_kernel(dev, rows, L):
    rng = np.random.default_rng(rows + L)
    m = rng.integers(-32, 33, (rows, L))
    mn = m + np.where(m >= 0, 1, -1)
    inv2 = rng.random((rows, 1)).astype(np.float32) + 0.01
    args = [(m * m).astype(np.float32) * inv2, (mn * mn).astype(np.float32) * inv2,
            rng.random((rows, L)) < 0.4, rng.random(rows).astype(np.float32) * 50.0,
            rng.random(rows).astype(np.float32) * 50.0]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]
    e2_k, acc_k = greedy.greedy_scan(*args)
    e2_p, acc_p = greedy.greedy_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(e2_k, e2_p) and torch.equal(acc_k, acc_p)


def _greedy_edge_inputs(rows, L, dev):
    rng = np.random.default_rng(1000 * rows + L)
    m = rng.integers(-32, 33, (rows, L))
    mn = m + np.where(m >= 0, 1, -1)
    inv2 = rng.random((rows, 1)).astype(np.float32) + 0.01
    e2 = rng.random(rows).astype(np.float32) * 50.0
    e2[::5] = np.nan                     # final_mantissas' wordlen-0 rows
    args = [(m * m).astype(np.float32) * inv2, (mn * mn).astype(np.float32) * inv2,
            rng.random((rows, L)) < 0.4, rng.random(rows).astype(np.float32) * 50.0,
            e2]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in args]


# rows around kernel B's 64-row block, L around its 32-candidate chunk
@pytest.mark.parametrize("rows", [1, 63, 65, 131])
@pytest.mark.parametrize("L", [1, 7, 31, 32, 33, 64, 128])
def test_greedy_kernel_tile_edges(dev, rows, L):
    args = _greedy_edge_inputs(rows, L, dev)
    assert args[2].dtype == torch.bool
    e2_k, acc_k = greedy.greedy_scan(*args)
    e2_p, acc_p = greedy.greedy_torch(*args)
    torch.cuda.synchronize()
    assert acc_k.dtype == torch.bool and torch.equal(acc_k, acc_p)
    both_nan = torch.isnan(e2_k) & torch.isnan(e2_p)
    assert bool(((e2_k == e2_p) | both_nan).all())
    assert bool(torch.isnan(e2_k[::5]).all())


def _rate_inputs(n, seed, dense_tonal):
    rng = np.random.default_rng(seed)
    shape = (n, 32)
    err = rng.uniform(0.0, 2.0, shape + (8,)).astype(np.float32)
    err[rng.random(err.shape) < 0.05] = 0.0
    err[rng.random(err.shape) < 0.02] = np.finfo(np.float32).max
    act = rng.random(shape) < (0.6 if dense_tonal else 0.15)
    start = np.sort(rng.integers(0, 1024, shape), axis=-1)
    if dense_tonal:                   # many same-bucket blocks in one group
        start[:, :18] = 256 + np.arange(18) * 3
    t_len = np.where(act, rng.integers(1, 8, shape), 0)
    return {
        "csfi": rng.uniform(0, 63, shape).astype(np.float32),
        "gated": rng.random(shape) < 0.1,
        "tonal_counts": rng.integers(0, 4, shape).astype(np.int32),
        "spread": rng.random(n).astype(np.float32),
        "target": rng.integers(40, 2500, n).astype(np.int32),
        "num_bfu": rng.integers(1, 33, n).astype(np.int32),
        "err": err,
        "clc": rng.integers(0, 150, shape + (8,)).astype(np.int32),
        "vlc": rng.integers(0, 150, shape + (8,)).astype(np.int32),
        "t_active": act.astype(np.int32),
        "t_pos": np.where(act, start, 0).astype(np.int32),
        "t_len": t_len.astype(np.int32),
        "t_bfu": np.where(act, rng.integers(0, 32, shape), 0).astype(np.int32),
        "t_vlc": rng.integers(4, 60, shape + (8,)).astype(np.int32),
    }


@pytest.mark.parametrize("n,dense_tonal", [(1, False), (130, False),
                                           (130, True), (5000, False)])
@pytest.mark.parametrize("auto", [True, False])
def test_rate_control_kernel(dev, n, dense_tonal, auto):
    ins = {k: torch.from_numpy(v).to(dev)
           for k, v in _rate_inputs(n, n + dense_tonal, dense_tonal).items()}
    out_k = rate_control.rate_control_block(**ins, auto=auto)
    out_p = rate_control.rate_control_torch(**ins, auto=auto)
    torch.cuda.synchronize()
    for name, k, p in zip(("num_bfu", "mode", "wl"), out_k, out_p):
        assert torch.equal(k.to(p.dtype), p), name


@pytest.mark.parametrize("n,dense_tonal", [(1, False), (130, False),
                                           (130, True), (5000, False)])
def test_bisect_kernel(dev, n, dense_tonal):
    ins = {k: torch.from_numpy(v).to(dev)
           for k, v in _rate_inputs(n, n + dense_tonal, dense_tonal).items()}
    wl_k = rate_control.bisect_block(**ins)
    wl_p = rate_control.bisect_torch(**ins)
    _, _, wl_c = rate_control.rate_control_block(**ins, auto=False)
    torch.cuda.synchronize()
    assert torch.equal(wl_k, wl_p) and torch.equal(wl_k, wl_c)


def _rate_edge_inputs(n, num_bfu, dev, shared_clc):
    """Every tonal slot active, err holding 0, NaN and FLT_MAX; clc either
    per frame or one [32, 8] table broadcast over the frames, as the
    encoder passes it."""
    ins = _rate_inputs(n, 7 * n + num_bfu, True)
    rng = np.random.default_rng(n + num_bfu)
    ins["t_active"][:] = 1
    ins["t_len"] = rng.integers(1, 4, (n, 32)).astype(np.int32)
    ins["t_pos"] = np.sort(rng.integers(0, 1024, (n, 32)), -1).astype(np.int32)
    ins["t_bfu"] = rng.integers(0, 32, (n, 32)).astype(np.int32)
    ins["num_bfu"][:] = num_bfu
    err = ins["err"]
    pick = rng.random(err.shape)
    err[pick < 0.1] = 0.0
    err[(pick >= 0.1) & (pick < 0.2)] = np.nan
    err[(pick >= 0.2) & (pick < 0.3)] = np.finfo(np.float32).max
    out = {k: torch.from_numpy(v).to(dev) for k, v in ins.items()}
    if shared_clc:
        out["clc"] = out["clc"][0].expand(out["clc"].shape)
    return out


# n not a multiple of the 4 frames (warps) a block of kernels C and F holds
@pytest.mark.parametrize("n", [13, 1003])
@pytest.mark.parametrize("num_bfu", [1, 32])
@pytest.mark.parametrize("shared_clc", [False, True])
def test_rate_control_and_bisect_kernel_edges(dev, n, num_bfu, shared_clc):
    ins = _rate_edge_inputs(n, num_bfu, dev, shared_clc)
    for auto in (True, False):
        out_k = rate_control.rate_control_block(**ins, auto=auto)
        out_p = rate_control.rate_control_torch(**ins, auto=auto)
        torch.cuda.synchronize()
        for name, k, p in zip(("num_bfu", "mode", "wl"), out_k, out_p):
            assert torch.equal(k.to(p.dtype), p), (name, auto)
    wl_f = rate_control.bisect_block(**ins)
    torch.cuda.synchronize()
    assert torch.equal(wl_f, rate_control.bisect_torch(**ins))
    assert torch.equal(wl_f, out_k[2])          # auto=False, the last round


class _Spy:
    """The kernel library, recording the arguments of every entry call."""

    def __init__(self, lib):
        self.lib, self.calls = lib, []

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls.append(args)
            return fn(*args)
        return call


def test_wrappers_make_no_layout_copy(dev, monkeypatch):
    """Kernels A to F get the caller's tensors themselves (their data_ptr
    reaches the launch; the bool masks of A, D and E are read as bytes, not
    cast; E reads the encoder's broadcast loudness and fixed-window flags
    by stride) and write the returned tensors directly."""
    from atracdenc_tpu_torch import kernels
    spy = _Spy(kernels.library())
    monkeypatch.setattr(kernels, "library", lambda: spy)

    x = torch.from_numpy(_quant_inputs(5)).to(dev).reshape(1, 5, 32, 128)
    mask = torch.as_tensor(T.GATHER_MASK, device=dev)
    assert mask.dtype == torch.bool
    for fn in (quant_cost.quant_cost_plain, quant_cost.quant_cost_full):
        err, vlc = fn(x, mask)
        assert spy.calls[-1][:5] == (x.data_ptr(), mask.data_ptr(),
                                     err.data_ptr(), vlc.data_ptr(), 5)
        assert err.shape == vlc.shape == (1, 5, 32, 8)
        assert err.dtype == torch.float32 and vlc.dtype == torch.int32

    args = _greedy_edge_inputs(300, 64, dev)
    e2_out, accept = greedy.greedy_scan(*args)
    ptrs = spy.calls[-1]
    assert list(ptrs[:5]) == [a.data_ptr() for a in args]
    assert ptrs[5:7] == (e2_out.data_ptr(), accept.data_ptr())
    assert accept.dtype == torch.bool and accept.shape == (300, 64)

    ins = _rate_edge_inputs(37, 32, dev, shared_clc=True)
    names = ("csfi", "gated", "tonal_counts", "spread", "target", "num_bfu",
             "err", "clc", "vlc", "t_active", "t_pos", "t_len", "t_bfu",
             "t_vlc")
    want = [ins[k].data_ptr() for k in names]
    nb, mode, wl = rate_control.rate_control_block(**ins)
    ptrs = spy.calls[-1]
    assert list(ptrs[:14]) == want
    assert ptrs[16:19] == (wl.data_ptr(), nb.data_ptr(), mode.data_ptr())
    assert ptrs[20] == 0                        # clc read as one table
    assert mode.dtype == torch.bool and wl.shape == (37, 32)
    wl_f = rate_control.bisect_block(**ins)
    ptrs = spy.calls[-1]
    assert list(ptrs[:14]) == want and ptrs[16] == wl_f.data_ptr()

    for layout, flags_stride in (("encoder", 3), ("fixed windows", 0)):
        sfi, energy, short, loud = _at1_inputs(37, "random", dev, layout)
        assert short.dtype == torch.bool and loud.stride(1) == 0
        idx, wl = at1_alloc.at1_allocate_block(sfi, energy, short, loud)
        ptrs = spy.calls[-1]
        assert ptrs[:4] == (sfi.data_ptr(), energy.data_ptr(),
                            short.data_ptr(), loud.data_ptr())
        assert ptrs[13:15] == (wl.data_ptr(), idx.data_ptr())
        assert ptrs[15:20] == (42, 0, flags_stride, 2, 7)   # n, auto, C, F
        assert wl.shape == (3, 2, 7, 52) and idx.shape == (3, 2, 7)
        assert wl.dtype == idx.dtype == torch.int32
    torch.cuda.synchronize()


def _at1_inputs(n, case, dev="cpu", layout="rows"):
    """sfi, energy, short_flags, loudness of about n channel-frames.

    layout "rows": [n, ...] contiguous.  As the ATRAC1 encoder hands them,
    [S, C, F, ...] with S = 3, C = 2: "encoder" gives loudness one [S, F]
    row per stream broadcast over the channels (stride 0); "fixed windows"
    also gives short_flags as ``encoder._fixed_masks``' broadcast [3]."""
    lead = (n,) if layout == "rows" else (3, 2, -(-n // 6))
    rng = np.random.default_rng(n)
    sfi = rng.integers(0, 64, lead + (52,)).astype(np.int32)
    energy = (10.0 ** rng.uniform(-9, 2, lead + (52,))).astype(np.float32)
    short = rng.integers(0, 2, lead + (3,)) > 0
    loud = (10.0 ** rng.uniform(-4, 0, lead)).astype(np.float32)
    if case == "silence":                 # every long-window BFU gated
        sfi[:] = 0
        energy[:] = 0.0
        short[:] = False
    elif case == "short":                 # all bands short: no gate
        short[:] = True
    ins = [torch.from_numpy(a).to(dev) for a in (sfi, energy, short, loud)]
    if layout != "rows":
        ins[3] = ins[3][:, 0].contiguous()[:, None, :].expand(lead)
    if layout == "fixed windows":
        from atracdenc_tpu_torch.models.atrac1 import encoder
        mask = {"silence": 0, "short": 7}.get(case, n % 8)
        ins[2] = encoder._fixed_masks(mask, lead, ins[2].device)
    return ins


@pytest.mark.parametrize("layout", ["rows", "encoder", "fixed windows"])
@pytest.mark.parametrize("n,case", [(1, "random"), (257, "random"),
                                    (257, "silence"), (257, "short"),
                                    (8192, "random")])
@pytest.mark.parametrize("const", range(9))
def test_at1_allocate_kernel(dev, n, case, const, layout):
    ins = _at1_inputs(n, case, dev, layout)
    idx_k, wl_k = at1_alloc.at1_allocate_block(*ins, bfu_idx_const=const)
    idx_p, wl_p = at1_alloc.at1_allocate_torch(*ins, bfu_idx_const=const)
    torch.cuda.synchronize()
    assert torch.equal(idx_k, idx_p) and torch.equal(wl_k, wl_p)


def test_wrappers_refuse_bad_shapes(dev):
    for fn in (quant_cost.quant_cost_plain, quant_cost.quant_cost_full):
        with pytest.raises(ValueError):
            fn(torch.zeros((2, 32, 64), device=dev),
               torch.ones((32, 128), dtype=torch.bool, device=dev))
    z = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError):
        greedy.greedy_scan(z, z, z.bool(), z[:, 0], z[:3, 0])
    ins = {k: torch.from_numpy(v).to(dev)
           for k, v in _rate_inputs(3, 0, False).items()}
    ins["t_vlc"] = ins["t_vlc"][..., :7]
    with pytest.raises(ValueError):
        rate_control.rate_control_block(**ins)
    with pytest.raises(ValueError):
        rate_control.bisect_block(**ins)
    sfi, energy, short, loud = _at1_inputs(3, "random", dev)
    with pytest.raises(ValueError):
        at1_alloc.at1_allocate_block(sfi, energy, short[:, :2], loud)
    with pytest.raises(ValueError):
        at1_alloc.at1_allocate_block(sfi, energy, short, loud, bfu_idx_const=9)
