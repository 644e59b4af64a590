"""The ``atrac3-lp4.batch`` cell: the reference's joint-stereo route is the
upstream encoder's (``tests/golden/at3_js_golden.npz``: frames of the
compiled dcherednik/atracdenc at 66,150 bit/s, 192 B, with its default
gain control and tonal components), the cell's fast reference
(``reference/atrac3fast.py``) codes the plain model's frames byte for byte,
each of its stand-ins gives the model's function's values, the cell
resolves to a joint-stereo, 192-byte codec and reference that check past
the first carry, and a run cut to a CPU's size comes out correct, and not
correct with its carry left out."""
import os

import numpy as np
import pytest
import torch

from portbench import manifest, music
from portbench.reference import atrac3, atrac3fast
from portbench.reference.upstream.atrac3 import exact_enc as E
from portbench.reference.upstream.atrac3 import exact_gain as G
from portbench.tests.conftest import run_small
from portbench.tests.test_portbench_faults import _on_codec, state_unchanged

CELL = "atrac3-lp4.batch"
GOLDEN = os.path.join(manifest.ROOT, "tests", "golden")
SEED = 2 ** 31 + 2222
f32 = np.float32


@pytest.mark.parametrize("ref", [atrac3, atrac3fast], ids=["plain", "fast"])
@pytest.mark.parametrize("pcm_key,ref_key,frames", [
    ("pcm_in", "ref_frames", 8), ("pcm_mono", "ref_mono", 32)],
    ids=["stereo", "mono"])
def test_js_route_is_upstream_s(pcm_key, ref_key, frames, ref):
    d = np.load(os.path.join(GOLDEN, "at3_js_golden.npz"))
    cfg = manifest.cell(CELL).config
    rows = ref.encode_rows(cfg, d[pcm_key])
    want = d[ref_key]
    assert want.shape == (frames, 192)
    assert (rows[:frames] == want).all()


@pytest.mark.parametrize("npz,pcm_key,ref_key,gain,tonal", [
    ("at3_default_golden.npz", "pcm_stress", "ref_stress", True, True),
    ("at3_tonal_golden.npz", "pcm_in", "ref_frames", False, True),
], ids=["gain_and_tonal", "tonal"])
def test_fast_reference_is_upstream_s_at_384_bytes(npz, pcm_key, ref_key,
                                                   gain, tonal):
    d = np.load(os.path.join(GOLDEN, npz))
    cfg = dict(frame_bytes=384, joint_stereo=False, bfu_idx_const=0,
               gain_control=gain, tonal_components=tonal)
    rows = atrac3fast.encode_rows(cfg, d[pcm_key])
    want = d[ref_key]
    n = min(len(rows), len(want))
    assert n >= 8
    assert (rows[:n] == want[:n]).all()


@pytest.mark.parametrize("config,seed", [
    ("atrac3-lp4", 2 ** 31 + 11), ("atrac3-lp4", 3_700_000_001),
    ("atrac3-lp2", 2 ** 31 + 12)])
def test_fast_reference_codes_the_plain_models_frames(config, seed):
    """The benchmark's music, 12 frames, gain control and tonal on."""
    cfg = manifest.cell(config + ".batch").config
    pcm = music.tracks(1, 12 * 1024, seed, torch.device("cpu"))[0]
    pcm = (pcm.to(torch.float32) / 32768.0).numpy()
    plain = atrac3.encode_rows(cfg, pcm)
    fast = atrac3fast.encode_rows(cfg, pcm)
    assert plain.shape == (12, cfg["frame_bytes"])
    assert np.array_equal(fast, plain)


# each stand-in against the model's own function ------------------------------

def _same(a, b):
    """Equal values of the same dtype, bit for bit (NaN and inf too)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("scale", [0.0, 1e-6, 0.3, 40.0])
def test_analyze_gain_stand_in(scale):
    rng = np.random.default_rng(7)
    for _ in range(20):
        sig = (rng.standard_normal(2048) * scale
               * rng.uniform(0.1, 3.0, 2048)).astype(f32)
        for quantiles in (True, False):
            got = atrac3fast.analyze_gain(sig, 32, quantiles)
            want = G.analyze_gain(sig, 32, quantiles)
            for g, w in zip(got, want):
                if w is None:
                    assert g is None
                else:
                    _same(g, w)


@pytest.mark.parametrize("pts", [[], [(4, 3)], [(6, 1), (3, 12)], [(2, 30)],
                                 [(9, 0), (5, 7), (4, 20)]])
def test_calc_gain_energy_scale_stand_in(pts):
    rng = np.random.default_rng(11)
    for prev_scale in (f32(1.0), f32(0.37), f32(2.5), f32(0.0), f32(np.inf)):
        prev = (rng.standard_normal(256) * 0.2).astype(f32)
        cur = (rng.standard_normal(256) * 0.2).astype(f32)
        got = atrac3fast.calc_gain_energy_scale(prev, cur, pts, prev_scale,
                                                E._ENC_WINDOW)
        want = G.calc_gain_energy_scale(prev, cur, pts, prev_scale,
                                        E._ENC_WINDOW)
        _same(np.asarray(got, f32), np.asarray(want, f32))


@pytest.mark.parametrize("ea", [False, True], ids=["plain", "ea"])
def test_quant_mantissas_stand_in(ea):
    rng = np.random.default_rng(13)
    for n in (4, 8, 16, 32):
        for wl in range(1, 8):
            for _ in range(40):
                vals = np.clip(rng.standard_normal(n) * rng.uniform(0.05, 1),
                               -0.99999, 0.99999).astype(f32)
                if rng.uniform() < 0.1:
                    vals[:] = 0
                got = atrac3fast.quant_mantissas(vals, E._MAXQ[wl], ea)
                want = E.quant_mantissas_exact(vals, E._MAXQ[wl], ea)
                _same(got[0], want[0])
                _same(got[1], want[1])


def test_scale_frame_and_flatness_stand_ins():
    rng = np.random.default_rng(17)
    for scale in (0.0, 1e-7, 0.01, 0.5, 3.0):
        for _ in range(10):
            spec = (rng.standard_normal(1024) * scale).astype(f32)
            got, want = atrac3fast._scale_frame(spec), E._scale_frame(spec)
            _same(got[0], want[0])
            _same(got[2], want[2])
            for g, w in zip(got[1], want[1], strict=True):
                _same(g, w)
            energy = (spec * spec).astype(f32)
            _same(atrac3fast._flatness_per_bfu(energy),
                  E._flatness_per_bfu(energy))


def test_allocate_channel_stand_in():
    """Channel-frames of music through the model's scaler and tonal
    extraction, at budgets from one bit to LP2's whole channel."""
    rng = np.random.default_rng(19)
    pcm = music.tracks(1, 4096, 2 ** 31 + 19, torch.device("cpu"))[0]
    pcm = (pcm.to(torch.float32) / 32768.0).numpy()
    specs = E._mdct_frames(E._analysis_tree((pcm / f32(4.0)).astype(f32)))
    for spec in specs.reshape(-1, 1024):
        for target in (1, 60, 300, 700, 1400):
            for tonal in (False, True):
                s = spec.copy()
                bfus, cost = (), None
                if tonal:
                    blocks = E._map_tonal(E._extract_tonal(
                        s, E._flatness_per_bfu((s * s).astype(f32))))
                    bfus = [b["bfu"] for b in blocks]

                    def cost(alloc, blocks=blocks):
                        return E._tonal_bits(blocks, alloc)
                sfi, vals, energy = E._scale_frame(s)
                loud = f32(rng.uniform(0.2, 3.0))
                gs = rng.choice([f32(1.0), f32(0.5), f32(2.0)], 4).astype(f32)
                args = (sfi, vals, energy, target, loud, gs)
                got = atrac3fast._allocate_channel(
                    *args, tonal_bfus=bfus, tonal_cost_fn=cost)
                want = E._allocate_channel(
                    *args, tonal_bfus=bfus, tonal_cost_fn=cost)
                assert got[:2] == want[:2]
                _same(got[2], want[2])
                for g, w in zip(got[3], want[3], strict=True):
                    _same(g, w)


STOOD_IN = [(G, "analyze_gain"), (G, "calc_gain_energy_scale"),
            (E, "_allocate_channel"), (E, "quant_mantissas_exact"),
            (E, "_scale_frame"), (E, "_flatness_per_bfu")]


def test_stand_ins_only_while_the_fast_reference_encodes(monkeypatch):
    before = [getattr(mod, name) for mod, name in STOOD_IN]
    seen = []

    def encode(pcm, **opts):
        seen.extend(getattr(mod, name) for mod, name in STOOD_IN)
        raise RuntimeError("stop")
    monkeypatch.setattr(E, "encode_track_exact", encode)
    with pytest.raises(RuntimeError):
        atrac3fast.encode_rows(manifest.cell(CELL).config,
                               np.zeros((2, 2048), f32))
    assert seen == [atrac3fast.analyze_gain, atrac3fast.calc_gain_energy_scale,
                    atrac3fast._allocate_channel, atrac3fast.quant_mantissas,
                    atrac3fast._scale_frame, atrac3fast._flatness_per_bfu]
    assert [getattr(mod, name) for mod, name in STOOD_IN] == before


# the cell -------------------------------------------------------------------

def test_cell_reaches_codec_and_reference_as_js_192():
    cell = manifest.cell(CELL)
    cfg = cell.config
    assert (cfg["bitrate_bps"], cfg["frame_bytes"], cfg["joint_stereo"]) == (
        66150, 192, True)
    assert cfg["gain_control"] and cfg["tonal_components"]
    entry = {c["name"]: c for c in manifest.benchmark()["configs"]}[
        cell.workload["config"]]
    assert entry["reduced"] == [] and entry["file"].endswith("atrac3-lp4.json")
    codec = cell.codec_module().Codec(cfg)
    assert codec.js is True and codec.row_bytes == 192
    assert codec.opts["frame_bytes"] == 192 and codec.opts["js"] is True
    assert not codec.opts["no_gain_control"] and not codec.opts["no_tonal"]
    ref = cell.reference_module().Reference(cfg)
    assert ref.js is True and ref.row_bytes == 192
    assert cell.reference_module().Reference.encode_rows is (
        atrac3fast.encode_rows)
    assert atrac3.options(cfg)["js"] is True
    assert {m["name"] for m in cell.end_to_end} == {
        "encode_rate.at3", "peak_mem_gib", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "span_ms.at3js_stereo", "span_ms.at3js_encode"}


def test_cell_checks_past_the_first_carry():
    """The checked frames reach into the second call of each track, and
    its limits hold the mean error that a bad carry moves."""
    cell = manifest.cell(CELL)
    assert cell.config["check_frames"] > cell.traffic["chunk_frames"] + 4
    assert set(cell.limits) == {"frames_differ", "mean_frame_err"}


@pytest.mark.parametrize("fault", [None, "state_unchanged"],
                         ids=["sound", "state_unchanged"])
def test_small_run(fault, tmp_path):
    alter = None if fault is None else _on_codec(state_unchanged)
    r = run_small(CELL, SEED, tmp_path, alter=alter)
    assert r["correct"] is (fault is None), r["numbers"]
    assert r["failed"] == 0
