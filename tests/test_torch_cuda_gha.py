"""Kernel H (``csrc/gha_greedy.cu``, through ``gha.greedy``) against the
plain ``gha._greedy`` on the card.

Needs a GPU and nvcc, so every test is marked ``cuda`` and skips elsewhere.
The machine with the card has no JAX, and tests/conftest.py imports it, so
run this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_gha.py

The inputs: 4,096 lanes of tones over noise (``testing.gha_lanes``); the
lanes of ``portbench.music`` tracks at the cell's subbands, through both
passes (the whole window, then the refit on the ``truncate`` lanes with
their fit lengths and caps, captured from ``_finish``); and the edge lanes
of ``testing.gha_edge_lanes`` (all zeros, fit lengths 1, 17 and 127,
max_keep 0 and 8, eight waves accepted, inactive lanes).

H sums the DFT in another order than cuBLAS, so a plane may differ where a
decision stands on a knife edge.  The integer planes must be equal on at
least 99.5% of the lanes, and each lane that differs must be one: in its
first differing round (the rounds before it are equal, so both versions
saw the same samples), the plain version's two largest mag2 lie within
1e-4 of each other (relative), or one gate's two sides lie within 1e-5, or
the amplitude or phase lies within 1e-4 of a quantiser's step.
"""
import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.models.atrac3p import gha, pqf
from atracdenc_tpu_torch.testing import (gha_edge_lanes, gha_lanes, gha_replay,
                                         gha_rounds_of)
from portbench import music

pytestmark = pytest.mark.cuda
W = gha.MAX_WAVES


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


def _knife_edge(r, lane):
    """The knife edge a lane stands on in round record ``r``, or None."""
    def near(a, b, tol):
        a, b = float(a[lane]), float(b[lane])
        return abs(a - b) <= tol * max(abs(a), abs(b))
    if near(r["top1"], r["top2"], 1e-4):
        return "argmax"
    for gate, (a, b) in {"energy": ("e_new", "e_cut"), "ath": ("amp2", "ath"),
                         "amp": ("amp", "amp_cut")}.items():
        if near(r[a], r[b], 1e-5):
            return f"gate {gate}"
    sf_in, ph_in = float(r["sf_in"][lane]), float(r["ph_in"][lane])
    if abs(sf_in - round(sf_in)) <= 1e-4:
        return "sf step"
    if abs(ph_in - np.floor(ph_in) - 0.5) <= 1e-4:
        return "phase step"
    return None


def _hold(args, active, seed):
    """H against the plain version on ``args`` (x, fit_len, max_keep,
    sb_ath); returns the number of lanes that differ."""
    x, fit_len, max_keep, sb_ath = args
    lanes = x.shape[0]
    on = torch.ones(lanes, dtype=torch.bool, device=x.device) \
        if active is None else active
    gha.greedy(*args, active=active)                   # build and warm
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    torch.cuda.set_sync_debug_mode("error")            # H reads nothing back
    got = gha.greedy(*args, active=active)
    torch.cuda.set_sync_debug_mode(0)
    snap = trace.snapshot()
    trace.disable()
    counters = snap["counters"]
    assert counters["launch.gha_greedy"]["total"] == W
    assert "host_sync" not in counters
    assert counters["gha.lane_rounds_offered"]["total"] == lanes * W
    assert counters["gha.lane_rounds"]["total"] == gha_rounds_of(
        got[3], max_keep, on)

    fit = torch.arange(128, device=x.device) < fit_len[:, None]
    plain = [torch.where(on[:, None], p, torch.zeros_like(p))
             for p in gha._greedy(x, fit, max_keep, sb_ath)]
    *replay, n_rounds, rounds = gha_replay(*args, active, seed)
    for p, r in zip(plain, replay):
        assert torch.equal(p, r)                       # the model is faithful
    diff = torch.zeros((lanes, W), dtype=torch.bool, device=x.device)
    for g, p in zip(got, plain):
        assert g.dtype == p.dtype and g.shape == p.shape
        diff |= g != p
    bad = torch.nonzero(diff.any(-1))[:, 0].tolist()
    assert len(bad) <= 0.005 * lanes, f"{len(bad)} of {lanes} lanes differ"
    unexplained = []
    for lane in bad:
        k = int(torch.nonzero(diff[lane])[0, 0])
        r = rounds[k]
        assert bool((r["listed"] == lane).any()), (lane, k)
        if _knife_edge(r, lane) is None:
            unexplained.append((lane, k))
    assert not unexplained, unexplained
    # the kernel's count is the plain version's but for the lanes that differ
    assert abs(counters["gha.lane_rounds"]["total"] - n_rounds) <= W * len(bad)
    assert n_rounds == gha_rounds_of(replay[3], max_keep, on)
    return len(bad)


def _cuda(arrays, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}


def test_tones_over_noise(dev):
    c = _cuda(gha_lanes(2500019101, 4096), dev)
    args = (c["x"], c["fit_len"], c["max_keep"], c["sb_ath"])
    _hold(args, None, 1)
    _hold(args, c["active"], 2)


@pytest.mark.parametrize("seed", [2500019111, 2500019112])
def test_edge_lanes(dev, seed):
    c = _cuda(gha_edge_lanes(seed), dev)
    args = (c["x"], c["fit_len"], c["max_keep"], c["sb_ath"])
    assert _hold(args, c["active"], seed) == 0
    _, _, _, valid = gha.greedy(*args, active=c["active"])
    n = valid.sum(-1).tolist()
    assert n[0] == 0 and n[4] == 0 and n[7] == 0 and n[8] == 0
    assert n[6] == W                                   # every round accepted


def test_music_lanes_both_passes(dev):
    """The cell's subbands of 4 music tracks x 64 frames: the whole window
    on every lane, then the refit with ``_finish``'s own inputs."""
    streams, frames = 4, 64
    pcm = music.tracks(streams, 2048 * frames, 2500019121, dev)
    bands = pqf.analysis(pcm.to(torch.float32) / 32768.0)
    bands = bands.reshape(streams, 2, 16, frames, 128).transpose(2, 3)
    x = bands[..., :gha.NUM_TONE_SUBBANDS, :].reshape(-1, 128).contiguous()
    lanes = x.shape[0]
    ath = gha._ath_lanes(lanes, dev)
    full = torch.full((lanes,), 128, dtype=torch.int32, device=dev)
    cap = torch.full((lanes,), W, dtype=torch.int32, device=dev)
    _hold((x, full, cap, ath), None, 3)
    seen = {}

    def record(e1, truncate, n1):
        seen.update(e1=e1, truncate=truncate, n1=n1)
        return gha.greedy(x, torch.where(truncate, e1, full),
                          torch.where(truncate, n1, cap), ath,
                          active=truncate)
    fit = torch.ones((lanes, 128), dtype=torch.bool, device=dev)
    gha._finish(bands, x, *gha._greedy(x, fit, cap, ath), record)
    t = seen["truncate"]
    assert 0 < int(t.sum()) < lanes // 2
    _hold((x, torch.where(t, seen["e1"], full), torch.where(t, seen["n1"], cap),
           ath), t, 4)


def test_bad_inputs_raise(dev):
    c = _cuda(gha_lanes(5, 64), dev)
    x, fit_len, max_keep, ath = c["x"], c["fit_len"], c["max_keep"], c["sb_ath"]
    bad = [(x.double(), fit_len, max_keep, ath, None),
           (x[:, :64].contiguous(), fit_len, max_keep, ath, None),
           (x, fit_len.long(), max_keep, ath, None),
           (x, fit_len, max_keep[:-1], ath, None),
           (x, fit_len, max_keep, ath.double(), None),
           (x, fit_len, max_keep, ath, c["active"].to(torch.uint8)),
           (x, fit_len.cpu(), max_keep, ath, None),
           (torch.empty((128, 64), device=dev).t(), fit_len, max_keep, ath,
            None)]
    for x_, f_, m_, a_, act in bad:
        with pytest.raises(ValueError):
            gha.greedy(x_, f_, m_, a_, active=act)
