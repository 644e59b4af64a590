"""The port's byte-identity triage tools on the CPU (no JAX): ``golden_check``,
``triage_at3`` and ``triage_gain`` against the JAX tools' cases and their
committed reports in tests/golden/, the ``cpu`` key of
``identity_triage.json``, the CUDA-against-CPU stage finder
(``triage_at3.divergent_stages``) on stages nudged by one ulp, and the
tools' command lines (no CPU fallback)."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import golden_check, triage_at3, triage_gain
from atracdenc_tpu_torch.models.atrac3 import encoder, specblocks
from atracdenc_tpu_torch.models.atrac3 import tables as T
from atracdenc_tpu_torch.ops import scale as scale_ops
from atracdenc_tpu_torch.testing import cpu_setup

cpu_setup()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
CASE_NAMES = [c[0] for c in golden_check.CASES]
GAIN_FILES = {"default_stress": "gain_triage_stress.json",
              "js_mono": "gain_triage_js_mono.json"}


def jax_tool(name):
    """tools/<name>.py as a module (the three tools import JAX only inside
    ``main``, which no test here calls)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_tool", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def golden_json(name):
    with open(os.path.join(GOLDEN, name)) as fp:
        return json.load(fp)


def as_json(x):
    return json.loads(json.dumps(x))


@pytest.fixture(scope="module")
def encodes():
    """Each golden case encoded once on the CPU for the whole module
    (``golden_check.encode_case`` is what all three tools encode with)."""
    cache = {}
    orig = golden_check.encode_case

    def encode_case(c, device):
        if (c[0], device) not in cache:
            cache[(c[0], device)] = orig(c, device)
        return cache[(c[0], device)].copy()

    mp = pytest.MonkeyPatch()
    mp.setattr(golden_check, "encode_case", encode_case)
    yield cache
    mp.undo()


@pytest.fixture(scope="module")
def at3_report(encodes):
    return as_json(triage_at3.triage("cpu", log=lambda *a: None))


def test_cases_are_the_jax_tools():
    assert golden_check.CASES == jax_tool("golden_check").CASES
    assert triage_gain.CASES == jax_tool("triage_gain").CASES
    assert triage_at3.PLANE_ORDER == jax_tool("triage_at3").PLANE_ORDER


@pytest.mark.parametrize("name", CASE_NAMES)
def test_triage_at3_equals_the_jax_report(at3_report, name):
    """identity, divergent, frames and the first-plane histogram of each
    case on the CPU equal tests/golden/at3_triage.json."""
    assert at3_report[name] == golden_json("at3_triage.json")[name]


@pytest.mark.parametrize("name", sorted(GAIN_FILES))
def test_triage_gain_equals_the_jax_report(encodes, name):
    got = as_json(triage_gain.triage(name, "cpu", log=lambda *a: None))
    want = golden_json(GAIN_FILES[name])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    assert not any(g["class"] == "LOGIC" for g in got)


def test_identity_triage_key_file():
    """``cpu`` holds the JAX tools' committed reports (and ``triage_at1``'s
    ATRAC1 report, held by tests/test_torch_triage_at1.py); ``cuda`` (taken
    on an H100) has the same layout and cases."""
    with open(triage_at3.KEY_FILE) as fp:
        key = json.load(fp)
    assert set(key) == {"cpu", "cuda"}
    assert {k: v for k, v in key["cpu"].items() if k != "triage_at1"} == {
        "triage_at3": golden_json("at3_triage.json"),
        "gain_triage_stress": golden_json(GAIN_FILES["default_stress"]),
        "gain_triage_js_mono": golden_json(GAIN_FILES["js_mono"])}
    assert "triage_at1" in key["cpu"]
    assert set(key["cuda"]) == set(key["cpu"])
    assert list(key["cuda"]["triage_at3"]) == CASE_NAMES
    for entries in (key["cuda"]["gain_triage_stress"],
                    key["cuda"]["gain_triage_js_mono"]):
        assert all(e["class"] in ("noise", "drain") for e in entries)


def test_ulp_gap():
    one = torch.tensor([1.0, 0.0, 2.0, float("nan")])
    up = torch.tensor([float(np.nextafter(np.float32(1), np.float32(2))),
                       -0.0, 2.0, float("nan")])
    assert triage_at3.ulp_gap(one, up) == (1, 0.5)
    tiny = float(np.nextafter(np.float32(0), np.float32(1)))
    assert triage_at3.ulp_gap(torch.tensor([tiny]), torch.tensor([-tiny]))[0] == 2


def _pcm():
    rng = np.random.default_rng(3)
    return (0.1 * rng.standard_normal((2, 4 * 1024))).astype(np.float32)


MODES = {"plain": dict(frame_bytes=384),
         "default": dict(frame_bytes=384, no_gain_control=False,
                         no_tonal=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_stage_finder_names_a_one_ulp_nudge(monkeypatch, mode):
    """MDCT line 0 of (channel 0, frame 2) is set to a scale-table entry
    above its block's peak in both runs, and one run moves it up by one
    ulp: the scaler's lower_bound picks the next scale factor there.  The
    finder names ``scale_blocks``, a 1-ulp gap in its input, and
    ``knife_edge``: re-run on the other run's inputs, the scaler decides
    as that run did."""
    orig = encoder.mdct_frames
    calls = []

    def nudged(*a, **kw):
        spec = orig(*a, **kw).clone()
        peak = float(specblocks.to_blocks(spec)[0, 2, 0].abs().max())
        table = torch.as_tensor(T.SCALE_TABLE)
        v = table[int((table <= 2 * peak).sum())]
        assert v < 1.0
        if not calls:                    # the run under test
            v = torch.nextafter(v, torch.tensor(2.0))
        calls.append(1)
        spec[0, 2, 0] = v
        return spec

    monkeypatch.setattr(encoder, "mdct_frames", nudged)
    rows = triage_at3.divergent_stages(_pcm(), MODES[mode], device="cpu")
    assert len(calls) == 2
    assert [(e["stream"], e["frame"]) for e in rows] == [(0, 2)]
    e = rows[0]
    assert e["first_plane"] is not None
    assert (e["stage"], e["outputs"], e["class"]) == \
        ("scale_blocks", ["sfi"], "knife_edge")
    assert (e["ulp"], e["input"], e["int_inputs"]) == (1, "values", [])
    assert e["upstream"]["mdct_frames"] > 0
    assert not any(e["upstream"].get(k) for k in ("gain_control",
                                                  "energy_scale"))
    calls.clear()
    one = triage_at3.first_diverging_stage(_pcm(), MODES[mode], 2,
                                           device="cpu")
    assert (one["stage"], one["class"], one["ulp"]) == \
        ("scale_blocks", "knife_edge", 1)


def test_stage_finder_flags_a_faulty_stage(monkeypatch):
    """A scaler that decides differently on the same inputs (one sfi raised
    in the run under test and in the replay, not in the reference run) is
    ``LOGIC``."""
    orig = scale_ops.scale_blocks
    calls = []

    def faulty(*a, **kw):
        sfi, scaled, energy = orig(*a, **kw)
        calls.append(1)
        if len(calls) != 2:              # 1: under test, 2: reference, 3: replay
            sfi = sfi.clone()
            sfi[0, 1, 0] += 1
        return sfi, scaled, energy

    monkeypatch.setattr(scale_ops, "scale_blocks", faulty)
    e = triage_at3.first_diverging_stage(_pcm(), MODES["plain"], 1,
                                         device="cpu")
    assert len(calls) == 3
    assert (e["stage"], e["outputs"], e["ulp"], e["class"]) == \
        ("scale_blocks", ["sfi"], 0, "LOGIC")


def test_stage_finder_on_equal_runs():
    """The CPU against itself: no frame differs; a frame asked for has no
    diverging stage."""
    pcm, kw = _pcm(), MODES["default"]
    assert triage_at3.divergent_stages(pcm, kw, device="cpu") == []
    e = triage_at3.first_diverging_stage(pcm, kw, 1, device="cpu")
    assert (e["first_plane"], e["stage"], e["class"]) == \
        (None, None, "unexplained")


def test_every_stage_replays_from_its_captured_inputs():
    """Each recorded stage, called again on its recorded inputs, gives its
    recorded outputs bit for bit: the records are all a replay needs."""
    kw = MODES["default"]
    stages = triage_at3._stages(kw)
    assert [s[0] for s in stages] == [s[0] for s in triage_at3.STAGES]
    x = torch.from_numpy(_pcm()[None])
    _, recs = triage_at3._run(x, kw, stages)
    for label, mod, attr, names in stages:
        a, k, out = recs[label]
        want = triage_at3._outputs(out, names)
        got = triage_at3._outputs(getattr(mod, attr)(*a, **k), names)
        assert list(got) == list(want), label
        for n, v in want.items():
            assert torch.equal(torch.nan_to_num(got[n]), torch.nan_to_num(v)), \
                (label, n)


@pytest.mark.parametrize("tool", [golden_check, triage_at3, triage_gain])
def test_main_refuses_without_cuda(tool):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: main([]) would run on it")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        tool.main([])


@pytest.mark.parametrize("tool", ["golden_check", "triage_at3", "triage_gain"])
def test_main_writes_the_report(encodes, tmp_path, capsys, tool):
    out = str(tmp_path / "report.json")
    if tool == "golden_check":
        assert golden_check.main(["--device", "cpu", "--json", out]) == 0
        want = {n: round(r["identity"], 6)
                for n, r in golden_json("at3_triage.json").items()}
        with open(out) as fp:
            got = json.load(fp)
        assert {n: got[n]["byte_identity"] for n in CASE_NAMES} == want
        assert got["plain"]["frames_identical"] == "7/8"
        assert "TOTAL" in capsys.readouterr().out
    elif tool == "triage_at3":
        assert triage_at3.main(["--device", "cpu", "--case", "js_mono",
                                "--json", out]) == 0
        with open(out) as fp:
            assert json.load(fp) == {
                "js_mono": golden_json("at3_triage.json")["js_mono"]}
    else:
        assert triage_gain.main(["--device", "cpu", "--case", "js_mono",
                                 "--json", out]) == 0
        with open(out) as fp:
            assert json.load(fp) == golden_json(GAIN_FILES["js_mono"])


def test_update_stores_the_device_key(tmp_path, monkeypatch):
    """--update replaces its entries of the device's key and keeps the
    key's other entries (``triage_at1``'s) and the other keys."""
    path = tmp_path / "identity_triage.json"
    path.write_text(json.dumps({"cpu": {"new": 0, "triage_at1": 2},
                                "cuda": {"kept": 1}}))
    monkeypatch.setattr(triage_at3, "KEY_FILE", str(path))
    monkeypatch.setattr(triage_at3, "identity_key", lambda dev: {"new": dev})
    assert triage_at3.main(["--device", "cpu", "--update"]) == 0
    assert json.loads(path.read_text()) == {
        "cpu": {"new": "cpu", "triage_at1": 2}, "cuda": {"kept": 1}}


def test_chip_smoke_probe_reads_the_oracle_build_script():
    """Phase 17's probe takes the reference sources' path from
    tools/oracle/build.sh and reports libavcodec and the sources."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_module", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    line = smoke._probe_reference_tools()
    with open(os.path.join(ROOT, "tools", "oracle", "build.sh")) as fp:
        src = fp.read().split("R=${R:-", 1)[1].split("}", 1)[0]
    assert line.startswith("libavcodec ") and f"({src}) " in line
    assert line.endswith(("present", "absent"))
