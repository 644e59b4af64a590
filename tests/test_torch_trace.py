"""The port's tracer (``atracdenc_tpu_torch/trace.py``) on the CPU: off
records nothing and changes no byte; the span tree of each codec's batch
call; self times; ``host_sync`` under the innermost span; the
transcoder's ``--trace`` file; the benchmark's readers of the tracer on a
synthetic snapshot; ``trace_encode``'s attribution of device ops and idle
gaps to spans.  The card-side checks (every synchronisation counted, the
profiler's clock) are ``tests/test_torch_cuda_trace.py``."""
import json

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import runtime, trace, trace_encode
from atracdenc_tpu_torch.io import wav
from atracdenc_tpu_torch.models.atrac1 import device_pack as pack1
from atracdenc_tpu_torch.models.atrac1 import encoder as enc1
from atracdenc_tpu_torch.models.atrac3 import device_pack as pack3
from atracdenc_tpu_torch.models.atrac3 import encoder as enc3
from atracdenc_tpu_torch.models.atrac3p import encoder as enc3p
from atracdenc_tpu_torch.ops import bitdeposit
from atracdenc_tpu_torch.tools import transcode
from portbench import manifest, program_trace

AT1_PLANES = ("short_mask", "bfu_idx", "wordlen", "sfi", "mant")

AT3_CHILDREN = {"band_frames", "gain_control", "mdct", "loudness_scan",
                "tonal", "scale_blocks", "quant_tensors", "allocate",
                "final_mantissas"}
AT1_CHILDREN = {"chunk_cat", "qmf_analysis", "transient_masks", "mdct",
                "loudness_scan", "bfu_gather", "scale_blocks",
                "rate_control", "quant_mantissas"}
AT3P_CHILDREN = {"pqf_analysis", "gha_extract", "gha_subtract", "mdct",
                 "scale_blocks", "spectral_planes", "finish_planes"}


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _pcm(spf, frames, seed=3):
    rng = np.random.default_rng(seed)
    x = 0.3 * rng.standard_normal((2, 2, frames * spf))
    return torch.from_numpy(x.astype(np.float32))


def _at3_call(pcm, state=None, nxt=None):
    planes, state = enc3.encode_frames_chunk(
        pcm, state, nxt, no_gain_control=False, no_tonal=False)
    return pack3.pack_device_batch(planes, 384), state


def _at1_call(pcm, state=None, nxt=None):
    planes, state = enc1.encode_frames_chunk(pcm, state, nxt)
    merged = {k: planes[k].transpose(1, 2).reshape((-1,) + planes[k].shape[3:])
              for k in AT1_PLANES}
    return pack1.pack_device(merged), state


def _at3p_call(pcm, state=None, nxt=None):
    return enc3p.encode_chunk_bytes(pcm, state, nxt)


CALLS = {"at3": (_at3_call, 1024), "at1": (_at1_call, 512),
         "at3p": (_at3p_call, 2048)}


def _middle_call(codec):
    """A middle chunk of a track (state and lookahead) -> bytes."""
    call, spf = CALLS[codec]
    x = _pcm(spf, 4)
    _, state = call(x, None, x[..., :spf])
    return lambda: call(x, state, x[..., :spf])[0]


@pytest.mark.parametrize("codec", ["at3", "at1", "at3p"])
def test_off_records_nothing_and_on_changes_no_byte(codec):
    run = _middle_call(codec)
    off = run()
    snap = trace.snapshot()
    assert snap["records"] == [] and snap["spans"] == {}
    assert snap["counters"] == {}
    trace.enable()
    on = run()
    trace.disable()
    assert torch.equal(off, on)
    assert trace.snapshot()["records"]


@pytest.mark.parametrize("codec,children", [("at3", AT3_CHILDREN),
                                            ("at1", AT1_CHILDREN),
                                            ("at3p", AT3P_CHILDREN)])
def test_span_tree_of_the_batch_call(codec, children):
    run = _middle_call(codec)
    trace.enable()
    run()
    recs = trace.snapshot()["records"]
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == [f"{codec}.encode_chunk",
                                          f"{codec}.pack"]
    enc, pack = roots
    assert {r["name"] for r in recs if r["parent"] == enc["id"]} == children
    pack_kids = {r["name"] for r in recs if r["parent"] == pack["id"]}
    if codec == "at3":
        assert pack_kids == {"channel_fields", "deposit_fields"}
        fields = [r for r in recs if r["name"] == "channel_fields"]
        assert len(fields) == 2
        for f in fields:
            kids = {r["name"] for r in recs if r["parent"] == f["id"]}
            assert kids == {"tonal_fields", "offset_scan", "field_cat"}
    elif codec == "at3p":
        assert pack_kids == {"tonal_fields", "spectrum_fields",
                             "deposit_fields"}
        assert sum(r["name"] == "spectrum_fields" for r in recs) == 2
        fin = next(r for r in recs if r["name"] == "finish_planes")
        assert {r["name"] for r in recs if r["parent"] == fin["id"]} == {
            "tonal_fields"}
    else:
        assert pack_kids == {"field_cat", "offset_scan", "deposit_fields"}
    for r in recs:
        assert r["device"] is None and not r["profiled"]
        root = by_id[r["root"]]
        assert root["parent"] is None and r["root_name"] == root["name"]
        if r["parent"] is not None:
            p = by_id[r["parent"]]
            assert p["root"] == r["root"]
            assert p["host"][0] <= r["host"][0] <= r["host"][1] <= p["host"][1]


def test_at3p_call_counts_gha_rounds_and_no_host_sync():
    """An ATRAC3+ call counts 16 greedy rounds (8 on the whole window, 8
    on the truncated-window refit), all under the two ``gha_greedy`` spans
    inside ``gha_extract``, read nothing of the card, and on the CPU path
    no ``host_sync``."""
    run = _middle_call("at3p")
    trace.enable()
    run()
    snap = trace.snapshot()
    assert snap["counters"]["gha_round"] == {
        "total": 16, "by_span": {"gha_greedy": 16}}
    by_id = {r["id"]: r for r in snap["records"]}
    greedy = [r for r in snap["records"] if r["name"] == "gha_greedy"]
    assert len(greedy) == 2
    assert all(by_id[r["parent"]]["name"] == "gha_extract" for r in greedy)
    assert "host_sync" not in snap["counters"]
    assert [r["name"] for r in snap["records"] if r["parent"] is None] == [
        "at3p.encode_chunk", "at3p.pack"]
    trace.disable()
    trace.reset()
    run()
    assert trace.counter("gha_round") == 16         # counted when off too


def test_self_time_is_duration_less_children():
    trace.enable()
    with trace.span("a"):
        with trace.span("b"):
            with trace.span("c"):
                pass
        with trace.span("b"):
            pass
    snap = trace.snapshot()
    recs = {r["name"]: r for r in snap["records"] if r["name"] != "b"}
    bs = [r for r in snap["records"] if r["name"] == "b"]

    def dur(r):
        return (r["host"][1] - r["host"][0]) / 1e6
    s = snap["spans"]
    assert s["b"]["count"] == 2
    assert s["a"]["self_ms"] == pytest.approx(
        dur(recs["a"]) - sum(dur(b) for b in bs), abs=1e-9)
    assert s["b"]["self_ms"] == pytest.approx(
        sum(dur(b) for b in bs) - dur(recs["c"]), abs=1e-9)
    assert s["c"]["self_ms"] == pytest.approx(dur(recs["c"]), abs=1e-9)
    total = sum(v["self_ms"] for v in s.values())
    assert total == pytest.approx(s["a"]["host_ms"], abs=1e-9)


def test_summary_takes_device_self_time_and_counts_by_span():
    recs = [{"name": "p", "id": 1, "parent": None, "root": 1,
             "root_name": "p", "profiled": False, "host": [0, 10_000_000],
             "device": [0, 20_000_000], "counts": {"host_sync": 1}},
            {"name": "k", "id": 2, "parent": 1, "root": 1, "root_name": "p",
             "profiled": False, "host": [2_000_000, 4_000_000],
             "device": [5_000_000, 11_000_000], "counts": {"host_sync": 2}}]
    out = trace.summarize(recs, {"host_sync": 4})
    assert out["spans"]["p"]["self_ms"] == pytest.approx(14.0)
    assert out["spans"]["p"]["host_ms"] == pytest.approx(10.0)
    assert out["spans"]["k"]["device_ms"] == pytest.approx(6.0)
    assert out["counters"]["host_sync"] == {
        "total": 7, "by_span": {"p": 1, "k": 2}}


def test_host_sync_counted_under_the_innermost_span(monkeypatch):
    """A meta tensor stands in for a card's tensor here: it is not on the
    CPU, so reading it on the host counts (the copy out of it then
    raises), as do the ATRAC1 packer's tables made from host data.  The
    packer's deposit takes its plain version (a meta tensor would go to
    the kernel, which needs a card)."""
    monkeypatch.setattr(pack1, "deposit_fields",
                        bitdeposit.deposit_fields_torch)
    meta = torch.device("meta")
    trace.enable()
    with trace.span("outer"):
        with trace.span("inner"):
            with pytest.raises(NotImplementedError):
                runtime.to_numpy(torch.zeros(3, device=meta))
        runtime.to_numpy(torch.zeros(3))              # on the CPU: no sync
        n = 4
        planes = {"short_mask": torch.zeros((n, 3), dtype=torch.bool),
                  "bfu_idx": torch.zeros(n, dtype=torch.int32),
                  "wordlen": torch.zeros((n, 52), dtype=torch.int32),
                  "sfi": torch.zeros((n, 52), dtype=torch.int32),
                  "mant": torch.zeros((n, 52, 20), dtype=torch.int32)}
        pack1.pack_device({k: v.to(meta) for k, v in planes.items()})
    runtime.from_host(np.zeros(2), meta)
    snap = trace.snapshot()
    assert snap["counters"]["host_sync"] == {
        "total": 5, "by_span": {"inner": 1, "at1.pack": 3}}
    assert trace.counter("host_sync") == 5
    trace.disable()
    runtime.to_torch(np.zeros(2), meta)
    assert trace.counter("host_sync") == 6
    assert trace.snapshot()["counters"]["host_sync"]["total"] == 5


def test_profiled_spans_are_marked():
    trace.enable()
    with trace.span("before"):
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("under"):
            torch.ones(4).sum()
    marks = {r["name"]: r["profiled"] for r in trace.snapshot()["records"]}
    assert marks == {"before": False, "under": True}


@pytest.fixture(scope="module")
def short_wav(tmp_path_factory):
    d = tmp_path_factory.mktemp("wav")
    n = np.arange(2048 * 6)
    sig = 0.4 * np.sin(2 * np.pi * 689.0625 * n / 44100)
    path = str(d / "tone.wav")
    wav.write(path, np.stack([sig, 0.7 * sig]).astype(np.float32), 44100)
    return path


@pytest.mark.parametrize("codec,chunk", [("atrac1", "at1.track_chunk"),
                                         ("atrac3", "at3.track_chunk"),
                                         ("atrac3plus", "at3p.track_chunk")])
def test_transcoder_trace_file(codec, chunk, short_wav, tmp_path, capsys):
    out = str(tmp_path / "spans.json")
    assert transcode.main([short_wav, short_wav, "--codec", codec,
                           "--device", "cpu", "--out-dir",
                           str(tmp_path / "enc"), "--trace", out]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert "realtime); read " in last and ", write " in last
    with open(out) as fp:
        doc = json.load(fp)
    assert doc["baseTimeNanoseconds"] % 10 ** 9 == 0
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["tid"] for e in spans} == {0}           # no device on the CPU
    files = [e for e in spans if e["name"] == "file"]
    assert len(files) == 2
    for f in files:
        fid = f["args"]["id"]
        kids = [e for e in spans if e["args"]["parent"] == fid]
        assert [e["name"] for e in kids] == ["read", "encode", "pack", "write"]
        for e in kids:
            assert f["ts"] <= e["ts"]
            assert e["ts"] + e["dur"] <= f["ts"] + f["dur"]
        enc = next(e for e in kids if e["name"] == "encode")
        assert any(e["name"] == chunk and e["args"]["parent"]
                   == enc["args"]["id"] for e in spans)


# the benchmark's readers of the tracer ---------------------------------

READERS = ["span_ms.at1_encode", "span_ms.at1_pack", "span_ms.at1_loudness",
           "host_ms.at1_loudness", "host_syncs_per_call.at1",
           "span_ms.at3_gain_control", "span_ms.at3_pack",
           "host_syncs_per_call.at3", "span_ms.at3p_encode",
           "span_ms.at3p_gha", "span_ms.at3p_pack",
           "host_syncs_per_call.at3p"]


def _rec(rid, name, parent, root, root_name, host, device, syncs=0,
         profiled=False):
    ms = 1_000_000
    return {"name": name, "id": rid, "parent": parent, "root": root,
            "root_name": root_name, "profiled": profiled,
            "host": [host[0] * ms, host[1] * ms],
            "device": [device[0] * ms, device[1] * ms],
            "counts": {"host_sync": syncs} if syncs else {}}


def _synthetic():
    """Two calls of each codec, and one of each made under the profiler
    (10x slower, 9 syncs), which the readers must leave out."""
    recs, rid = [], 0
    for k, profiled in ((0, False), (1, False), (2, True)):
        slow = 10 if profiled else 1
        t = 1000 * k
        rid += 1
        a1 = rid
        recs.append(_rec(a1, "at1.encode_chunk", None, a1, "at1.encode_chunk",
                         (t, t + 80 * slow), (t, t + 70 * slow),
                         1 + 8 * profiled, profiled))
        rid += 1
        recs.append(_rec(rid, "loudness_scan", a1, a1, "at1.encode_chunk",
                         (t + 10, t + 10 + 15 * slow),
                         (t + 10, t + 10 + 20 * slow), 0, profiled))
        rid += 1
        p1 = rid
        recs.append(_rec(p1, "at1.pack", None, p1, "at1.pack",
                         (t + 100, t + 100 + 9 * slow),
                         (t + 100, t + 100 + 8 * slow), 3, profiled))
        rid += 1
        a3 = rid
        recs.append(_rec(a3, "at3.encode_chunk", None, a3, "at3.encode_chunk",
                         (t + 200, t + 900), (t + 200, t + 880), 1, profiled))
        rid += 1
        recs.append(_rec(rid, "gain_control", a3, a3, "at3.encode_chunk",
                         (t + 210, t + 400), (t + 210, t + 460), 0, profiled))
        rid += 1
        recs.append(_rec(rid, "at3.pack", None, rid, "at3.pack",
                         (t + 900, t + 950), (t + 900, t + 990 * slow), 0,
                         profiled))
        rid += 1
        a3p = rid
        recs.append(_rec(a3p, "at3p.encode_chunk", None, a3p,
                         "at3p.encode_chunk", (t + 1, t + 600),
                         (t + 1, t + 1 + 500 * slow), 5 * profiled, profiled))
        for name, dur in (("gha_extract", 300), ("gha_subtract", 40)):
            rid += 1
            recs.append(_rec(rid, name, a3p, a3p, "at3p.encode_chunk",
                             (t + 2, t + 3), (t + 2, t + 2 + dur * slow), 0,
                             profiled))
        rid += 1
        recs.append(_rec(rid, "at3p.pack", None, rid, "at3p.pack",
                         (t + 600, t + 610), (t + 600, t + 660 * slow), 0,
                         profiled))
    return recs


class _Stub:
    def __init__(self, records):
        self.records, self.on = records, False

    def enable(self):
        self.on = True

    def snapshot(self):
        return {"records": self.records}


def test_readers_of_the_program_trace(monkeypatch):
    stub = _Stub(_synthetic())
    monkeypatch.setattr(program_trace, "trace", stub)
    got = {m: manifest.reader(m).read(None) for m in READERS}
    assert stub.on                         # loading a reader switches it on
    assert got == pytest.approx({
        "span_ms.at1_encode": 70.0, "span_ms.at1_pack": 8.0,
        "span_ms.at1_loudness": 20.0, "host_ms.at1_loudness": 15.0,
        "host_syncs_per_call.at1": 4.0, "span_ms.at3_gain_control": 250.0,
        "span_ms.at3_pack": 90.0, "host_syncs_per_call.at3": 1.0,
        "span_ms.at3p_encode": 500.0, "span_ms.at3p_gha": 340.0,
        "span_ms.at3p_pack": 60.0, "host_syncs_per_call.at3p": 0.0})


@pytest.mark.parametrize("stub", [None, _Stub([])])
def test_readers_find_nothing_without_the_tracer(monkeypatch, stub):
    """A program without the tracer (``trace`` None), or a run with no
    call recorded: every reader returns None and none raises."""
    monkeypatch.setattr(program_trace, "trace", stub)
    for m in READERS:
        assert manifest.reader(m).read(None) is None


# trace_encode's reduction of a profiler trace ---------------------------

def _ev(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": 1, "args": args}


def test_trace_encode_attributes_ops_and_gaps_to_spans():
    events = [
        _ev("cpu_op", "at1.encode_chunk", 0, 100),
        _ev("cpu_op", "mdct", 10, 20),
        _ev("cpu_op", "aten::cat", 11, 2),              # not a program span
        _ev("cpu_op", "at1.pack", 100, 50),
        _ev("cpu_op", "offset_scan", 102, 3),
        _ev("cpu_op", "offset_scan", 110, 5),
        _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 120, 1, correlation=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 111, 1, correlation=4),
        _ev("kernel", "CatArrayBatchedCopy<x>", 20, 10, correlation=1),
        _ev("kernel", "tensor_kernel_scan_innermost_dim<long>", 50, 5,
            correlation=2),
        _ev("kernel", "elementwise", 130, 10, correlation=3),
        _ev("kernel", "tensor_kernel_scan_innermost_dim<long>", 140, 2,
            correlation=4),
    ]
    r = trace_encode.attribute(events, 200e-6, {
        "at1.encode_chunk", "mdct", "at1.pack", "offset_scan"})
    assert r["device_busy_ms"] == pytest.approx(0.027)
    assert r["device_idle_share"] == pytest.approx(1 - 27 / 200)
    assert r["kernel_launches"] == 4
    assert r["cat_sites"] == [{"span": "at1.encode_chunk/mdct", "ms": 0.01,
                               "launches": 1}]
    assert r["int64_scan_sites"] == [
        {"span": "at1.encode_chunk", "ms": 0.005, "launches": 1},
        {"span": "at1.pack/offset_scan[1]", "ms": 0.002, "launches": 1}]
    assert [g["span"] for g in r["idle_gaps"]] == ["at1.pack",
                                                  "at1.encode_chunk"]
    assert [g["ms"] for g in r["idle_gaps"]] == pytest.approx([0.075, 0.02])


def test_trace_encode_stage_split_adds_up():
    run = _middle_call("at1")
    trace.enable()
    run()
    stages, syncs, roots_ms = trace_encode.stage_split(
        trace.snapshot()["records"])
    assert set(syncs) == {"at1.encode_chunk", "at1.pack"}
    assert "at1.encode_chunk/loudness_scan" in stages
    assert "at1.pack/deposit_fields" in stages
    assert "at1.pack/offset_scan[0]" in stages
    assert sum(v["self_ms"] for v in stages.values()) == pytest.approx(
        roots_ms, rel=1e-9)



def test_trace_encode_stage_split_of_at3p():
    """The ATRAC3+ call's split: its two roots, the GHA and packer spans by
    path, and self times that add up to the roots'."""
    run = _middle_call("at3p")
    trace.enable()
    run()
    stages, syncs, roots_ms = trace_encode.stage_split(
        trace.snapshot()["records"])
    assert syncs == {"at3p.encode_chunk": 0, "at3p.pack": 0}
    assert "at3p.encode_chunk/gha_extract" in stages
    assert "at3p.encode_chunk/finish_planes/tonal_fields" in stages
    assert stages["at3p.pack/spectrum_fields"]["calls"] == 2
    assert "at3p.pack/deposit_fields" in stages
    assert sum(v["self_ms"] for v in stages.values()) == pytest.approx(
        roots_ms, rel=1e-9)
