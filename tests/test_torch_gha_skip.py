"""Kernel H's two exactness claims (``csrc/gha_greedy.cu``), modelled on
the CPU, where the kernel cannot run.

H runs the ATRAC3+ GHA greedy rounds only on a device-side list of the
lanes still searching, and the truncated-window refit only on the lanes
where ``truncate`` holds.  Both are exact:

* a round after a lane's first failed gate, or at ``k >= max_keep``,
  changes none of its planes (its ``accept`` is false: ``x`` is kept and
  the slot written as 0), so it can be skipped;
* ``extract`` keeps the refit's planes only where ``truncate`` holds
  (``torch.where``), so the other lanes need no refit.

``testing.gha_replay`` is H's control flow with the plain round's
arithmetic (the same tensor ops on the same full-shape tensors as
``gha._greedy``, so every float is the same): round 0 lists the active
lanes with ``max_keep > 0``; a round takes its decisions only for the
listed lanes, writes each result at the lane's own index, and lists, in a
shuffled order, the lanes that accepted with another round left under
``max_keep``.  It gives the plain planes byte for byte, and
``gha.greedy``'s CPU route and ``extract``'s planes are unchanged by the
fit-length / active-set plumbing.  The card's test
(``tests/test_torch_cuda_gha.py``) holds H itself against the plain
version.
"""
import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.models.atrac3p import gha, pqf
from atracdenc_tpu_torch.testing import (cpu_setup, gha_edge_lanes,
                                         gha_lanes, gha_replay, gha_rounds_of)
from portbench import music

W = gha.MAX_WAVES


@pytest.fixture(autouse=True)
def _cpu():
    cpu_setup()
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _music_lanes(seed, frames=6, streams=2):
    """The cell's GHA lanes (subbands 0-7 of every channel-frame) of
    ``frames`` frames of ``portbench.music`` tracks, on the CPU."""
    pcm = music.tracks(streams, 2048 * frames, seed, "cpu")
    bands = pqf.analysis(pcm.to(torch.float32) / 32768.0)
    bands = bands.reshape(streams, 2, 16, frames, 128).transpose(2, 3)
    return bands


def _case(name, seed):
    if name == "music":
        bands = _music_lanes(seed)
        x = bands[..., :gha.NUM_TONE_SUBBANDS, :].reshape(-1, 128)
        lanes = x.shape[0]
        rng = np.random.default_rng(seed)
        return {"x": x.contiguous(),
                "fit_len": torch.full((lanes,), 128, dtype=torch.int32),
                "max_keep": torch.full((lanes,), W, dtype=torch.int32),
                "sb_ath": gha._ath_lanes(lanes, x.device),
                "active": torch.from_numpy(rng.random(lanes) < 0.6)}
    arrays = gha_edge_lanes(seed) if name == "edge" else gha_lanes(seed, 512)
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


@pytest.mark.parametrize("name,seed", [("music", 2500019001),
                                       ("music", 2500019002),
                                       ("tones", 11), ("edge", 12),
                                       ("edge", 13)])
def test_lane_list_emulation_equals_plain_greedy(name, seed):
    """H's list control flow gives the plain planes byte for byte, with
    every lane active and with an active set (inactive lanes zero and not
    valid), and computes one round a kept wave plus the stopping round."""
    c = _case(name, seed)
    args = (c["x"], c["fit_len"], c["max_keep"], c["sb_ath"])
    fit = torch.arange(128) < c["fit_len"][:, None]
    plain = gha._greedy(c["x"], fit, c["max_keep"], c["sb_ath"])
    for active in (None, c["active"]):
        *got, rounds, _ = gha_replay(*args, active, seed)
        via = gha.greedy(*args, active=active)
        on = torch.ones(len(c["x"]), dtype=torch.bool) if active is None \
            else active
        for g, v, p in zip(got, via, plain):
            want = torch.where(on[:, None], p, torch.zeros_like(p))
            assert torch.equal(g, want) and torch.equal(v, want)
        assert rounds == gha_rounds_of(got[3], c["max_keep"], on)
        assert 0 < rounds < len(c["x"]) * W
    assert plain[3].any(-1).sum() > 0


def _extract_plain(bands):
    """``extract`` as it was before H: both passes of ``_greedy`` on every
    lane, the refit's window as a mask."""
    bands, had = gha._lead(bands)
    x = bands[..., :gha.NUM_TONE_SUBBANDS, :].reshape(-1, 128)
    lanes = x.shape[0]
    sb_ath = gha._ath_lanes(lanes, x.device)
    full = torch.ones((lanes, 128), dtype=torch.bool)
    cap = torch.full((lanes,), W, dtype=torch.int32)
    planes = gha._greedy(x, full, cap, sb_ath)

    def refit(e1, truncate, n1):
        mask2 = torch.arange(128) < e1[:, None]
        return gha._greedy(x, torch.where(truncate[:, None], mask2, full),
                           torch.where(truncate, n1, cap), sb_ath)
    return gha._unlead(gha._finish(bands, x, *planes, refit), had)


@pytest.mark.parametrize("seed", [2500019011, 2500019012])
def test_extract_planes_unchanged_by_the_refit_active_set(seed):
    """``extract`` (fit lengths, the refit on the ``truncate`` lanes only)
    gives the planes of the plumbing before it on music-like bands, with a
    stream axis and without; its two passes offer 2 x L x 8 lane-rounds,
    each under a ``gha_greedy`` span."""
    bands = _music_lanes(seed)
    for b in (bands, bands[0]):
        want = _extract_plain(b)
        trace.reset()
        trace.enable()
        got = gha.extract(b)
        snap = trace.snapshot()
        trace.disable()
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(want[k], got[k]), k
        lanes = b[..., :gha.NUM_TONE_SUBBANDS, :].numel() // 128
        assert snap["counters"]["gha.lane_rounds_offered"] == {
            "total": 2 * lanes * W, "by_span": {"gha_greedy": 2 * lanes * W}}
        assert snap["spans"]["gha_greedy"]["count"] == 2
        assert "gha.lane_rounds" not in snap["counters"]   # no kernel here
    assert want["valid"].any()


def test_refit_truncate_lanes_exist_in_music():
    """The refit's active set is a strict subset of the lanes on music:
    some lanes truncate, most do not."""
    bands = _music_lanes(2500019021)
    x = bands[..., :gha.NUM_TONE_SUBBANDS, :].reshape(-1, 128)
    seen = {}

    def record(e1, truncate, n1):
        seen["truncate"] = truncate
        return tuple(torch.zeros((len(x), W), dtype=d)
                     for d in (torch.int32,) * 3 + (torch.bool,))
    full = torch.ones((len(x), 128), dtype=torch.bool)
    cap = torch.full((len(x),), W, dtype=torch.int32)
    planes = gha._greedy(x, full, cap, gha._ath_lanes(len(x), x.device))
    gha._finish(bands, x, *planes, record)
    n = int(seen["truncate"].sum())
    assert 0 < n < len(x) // 2, n
