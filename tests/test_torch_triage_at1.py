"""The ATRAC1 stage finder and triage report (``triage_at1``) on the CPU: a
one-ulp nudge of the MDCT's output at a scale-table entry (``knife_edge``
at the scaler), a faulty rate control (``LOGIC``), equal runs, the replay
of every stage from its captured inputs, the sound-unit row order, the
``triage_at1`` entry of ``identity_triage.json`` against a fresh CPU run
and the JAX encoder's identities, and the tool's command line (no CPU
fallback)."""
import json

import jax
import numpy as np
import pytest
import torch

from atracdenc_tpu.models.atrac1 import encoder as jenc
from atracdenc_tpu.models.atrac1 import frame as jframe
from atracdenc_tpu_torch import triage_at1
from atracdenc_tpu_torch.models.atrac1 import device_pack, encoder, frame
from atracdenc_tpu_torch.models.atrac1 import tables as T
from atracdenc_tpu_torch.testing import cpu_setup, roll_jax_scans

cpu_setup()
CASE_NAMES = [c[0] for c in triage_at1.CASES]
PLANES = ("short_mask", "bfu_idx", "wordlen", "sfi", "mant")


@pytest.fixture(scope="module")
def rolled():
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def cpu_report():
    return triage_at1.triage("cpu", log=lambda *a: None)


def _pcm(streams=1, frames=6, seed=5):
    rng = np.random.default_rng(seed)
    return (0.01 * rng.standard_normal((streams, 2, 512 * frames))
            ).astype(np.float32)


@pytest.mark.parametrize("where", [(0, 0, 2), (1, 1, 3)])
def test_stage_finder_names_a_one_ulp_nudge(monkeypatch, where):
    """Line 0 of the low band's MDCT at (stream, channel, frame) ``where``
    is set to a scale-table entry above its BFU's peak in both runs, and
    the run under test moves it up by one ulp: the scaler's lower_bound
    picks the next scale factor there.  The finder names that unit (row
    ``(s * F + f) * C + c``), ``scale.scale_blocks``, a 1-ulp gap in its
    input, and ``knife_edge``.  The MDCT's frame 0 is the one-chunk
    window's warm-up frame, so the track's frame f is the call's f + 1."""
    s, c, f = where
    orig = encoder.mdct_frames
    calls = []

    def nudged(x, mask, band):
        spec = orig(x, mask, band)
        if band != 0:
            return spec
        spec = spec.clone()
        peak = float(spec[s, c, f + 1, :8].abs().max())
        table = torch.as_tensor(T.SCALE_TABLE)
        v = table[int((table <= 2 * peak).sum())]
        assert v < 1.0
        if not calls:                    # the run under test
            v = torch.nextafter(v, torch.tensor(2.0))
        calls.append(1)
        spec[s, c, f + 1, 0] = v
        return spec

    monkeypatch.setattr(encoder, "mdct_frames", nudged)
    rows = triage_at1.divergent_stages(_pcm(streams=2), device="cpu")
    assert len(calls) == 2
    assert [(e["stream"], e["channel"], e["frame"]) for e in rows] == [where]
    e = rows[0]
    assert e["unit"] == (s * 6 + f) * 2 + c
    assert e["first_plane"] == "sfi"
    assert (e["stage"], e["outputs"], e["class"]) == \
        ("scale.scale_blocks", ["sfi"], "knife_edge")
    assert (e["ulp"], e["input"], e["int_inputs"]) == (1, "values", [])
    assert e["upstream"]["encoder.mdct_frames[low]"] > 0
    assert not e["upstream"].get("filterbank.analysis")


def test_stage_finder_flags_a_faulty_rate_control(monkeypatch):
    """A rate control that decides differently on the same inputs (one
    wordlen zeroed in the run under test and in the replay, not in the
    reference run) is ``LOGIC`` at ``encoder.at1_allocate_block``, at the
    channel and frame where it was zeroed."""
    orig = encoder.at1_allocate_block
    calls = []

    def faulty(*a, **kw):
        idx, wl = orig(*a, **kw)
        calls.append(1)
        if len(calls) != 2:              # 1: under test, 2: reference, 3: replay
            wl = wl.clone()
            wl[0, 1, 4, int(torch.nonzero(wl[0, 1, 4])[0])] = 0
        return idx, wl

    monkeypatch.setattr(encoder, "at1_allocate_block", faulty)
    rows = triage_at1.divergent_stages(_pcm(), device="cpu")
    assert len(calls) == 3
    assert len(rows) == 1
    e = rows[0]
    assert (e["unit"], e["channel"], e["frame"]) == (4 * 2 + 1, 1, 4)
    assert e["first_plane"] == "wordlen"
    assert (e["stage"], e["outputs"], e["ulp"], e["class"]) == \
        ("encoder.at1_allocate_block", ["wordlen"], 0, "LOGIC")


def test_stage_finder_on_equal_runs():
    """The CPU against itself: no unit differs; a unit asked for has no
    diverging stage."""
    pcm = _pcm()
    assert triage_at1.divergent_stages(pcm, device="cpu") == []
    (e,) = triage_at1.divergent_stages(pcm, [(0, 1, 3)], device="cpu")
    assert (e["unit"], e["first_plane"], e["stage"], e["class"]) == \
        (3 * 2 + 1, None, None, "unexplained")


@pytest.mark.parametrize("kernel", [True, False])
def test_every_stage_replays_from_its_captured_inputs(kernel):
    """Each recorded stage, called again on its recorded inputs, gives its
    recorded outputs bit for bit, on both rate-control routes (kernel E's
    wrapper, or ``bitalloc.allocate``)."""
    kw = dict(use_rate_kernel=kernel)
    stages = triage_at1._stages(kw)
    assert len(stages) == len(triage_at1.STAGES) == 12
    x = torch.from_numpy(_pcm())
    _, recs = triage_at1._run(x, kw, stages)
    for label, mod, attr, names, _ in stages:
        a, k, out = recs[label]
        want = triage_at1._outputs(out, names)
        got = triage_at1._outputs(getattr(mod, attr)(*a, **k), names)
        assert list(got) == list(want), label
        for n, v in want.items():
            assert torch.equal(got[n], v), (label, n)
    alloc = "encoder.at1_allocate_block" if kernel else "bitalloc.allocate"
    assert alloc in recs


def test_unit_rows_follow_the_bench_order():
    """``unit_of`` / ``unit_index`` name the row that ``merge_channels``
    gives each (stream, channel, frame), for 2 streams x 2 channels x 3
    frames."""
    n_s, n_c, n_f = 2, 2, 3
    tag = torch.arange(n_s * n_c * n_f).reshape(n_s, n_c, n_f)
    planes = {k: tag for k in PLANES}
    rows = device_pack.merge_channels(planes)["bfu_idx"]
    for s in range(n_s):
        for c in range(n_c):
            for f in range(n_f):
                u = triage_at1.unit_of(s, c, f, n_c, n_f)
                assert int(rows[u]) == int(tag[s, c, f])
                assert triage_at1.unit_index(u, n_c, n_f) == (s, c, f)


@pytest.mark.parametrize("name", CASE_NAMES)
def test_whole_track_bytes_equal_encode_track(name):
    """The triage encodes the whole track with ``encode_frames``; its units
    equal ``encode_track`` + ``frame.pack``, the path of the golden
    identities (chip_smoke.py phase 4)."""
    pcm, ref = triage_at1.load(name)
    planes = encoder.encode_track(pcm, device="cpu")
    want = frame.pack({k: np.swapaxes(planes[k], 0, 1).reshape(
        (-1,) + planes[k].shape[2:]) for k in PLANES})
    got = triage_at1.encode_case(name, "cpu")
    assert got.shape == want.shape == ref.shape
    assert np.array_equal(got, want)


def test_cpu_entry_is_a_fresh_run_and_the_jax_identities(rolled, cpu_report):
    """The ``triage_at1`` entry of the ``cpu`` key equals this run, its
    identities equal the JAX encoder's (0.93996 / 0.98019) to the last bit,
    and no unit differs from the CPU path; ``cuda`` has the same cases."""
    with open(triage_at1.KEY_FILE) as fp:
        key = json.load(fp)
    assert key["cpu"]["triage_at1"] == cpu_report
    for name in CASE_NAMES:
        pcm, ref = triage_at1.load(name)
        planes = jenc.encode_track(pcm)
        theirs = jframe.pack({k: np.swapaxes(np.asarray(planes[k]), 0, 1)
                              .reshape((-1,) + np.shape(planes[k])[2:])
                              for k in PLANES})
        r = cpu_report[name]
        assert r["identity"] == float((theirs == ref).mean())
        assert r["units"] == ref.shape[0]
        assert r["divergent"] == sum(r["first_plane"].values())
        assert r["vs_cpu"] == []
    assert round(cpu_report["at1_golden"]["identity"], 5) == 0.93996
    assert round(cpu_report["at1_stress_pcm"]["identity"], 5) == 0.98019
    assert list(key["cuda"]["triage_at1"]) == CASE_NAMES
    for name, r in key["cuda"]["triage_at1"].items():
        assert all(e["class"] == "knife_edge" for e in r["vs_cpu"]), name


def test_main_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: main([]) would run on it")
    with pytest.raises(RuntimeError, match="CUDA requested"):
        triage_at1.main([])


def test_main_json_and_update(tmp_path, monkeypatch, cpu_report):
    """--json writes the report of a case; --update stores the whole
    report under the device key's ``triage_at1`` entry and keeps the
    key's other entries and the other keys."""
    monkeypatch.setattr(triage_at1, "triage",
                        lambda dev, case=None, log=print:
                        {n: r for n, r in cpu_report.items()
                         if case in (None, n)})
    out = tmp_path / "r.json"
    assert triage_at1.main(["--device", "cpu", "--case", "at1_golden",
                            "--json", str(out)]) == 0
    assert json.loads(out.read_text()) == {
        "at1_golden": cpu_report["at1_golden"]}
    path = tmp_path / "identity_triage.json"
    path.write_text(json.dumps({"cpu": {"triage_at3": 1}, "cuda": {"k": 2}}))
    monkeypatch.setattr(triage_at1, "KEY_FILE", str(path))
    assert triage_at1.main(["--device", "cpu", "--update"]) == 0
    assert json.loads(path.read_text()) == {
        "cpu": {"triage_at3": 1, "triage_at1": cpu_report},
        "cuda": {"k": 2}}
