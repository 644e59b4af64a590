"""The port's tracer on the card: every synchronising operation of a batch
call is counted as ``host_sync`` under the span it happens in, and the
spans share the profiler's clock.

Needs a GPU, so every test is marked ``cuda`` and skips elsewhere.  The
machine with the card has no JAX, and tests/conftest.py imports it, so run
this file there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_trace.py

The sync check runs a track of three chunks (its first, a middle and its
last: no carry, carry and lookahead, no lookahead) of each codec's batch
call (``encode_frames_chunk``, then the device packer) under
``torch.cuda.set_sync_debug_mode("warn")``, which warns at every operation
that synchronises the host with the card, and holds the warnings, span by
span, equal to the tracer's ``host_sync`` counts.
"""
import collections
import json
import os
import warnings

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.models.atrac1 import device_pack as pack1
from atracdenc_tpu_torch.models.atrac1 import encoder as enc1
from atracdenc_tpu_torch.models.atrac3 import device_pack as pack3
from atracdenc_tpu_torch.models.atrac3 import encoder as enc3

pytestmark = pytest.mark.cuda

AT1_PLANES = ("short_mask", "bfu_idx", "wordlen", "sfi", "mant")
CHUNK_FRAMES = 16
CLOCK_US = 100.0          # a span's ends and its profiler range, at most


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the tracer's device side")
    trace.disable()
    trace.reset()
    yield torch.device("cuda")
    torch.cuda.set_sync_debug_mode(0)
    trace.disable()
    trace.reset()


def _at3_call(pcm, state, nxt):
    planes, state = enc3.encode_frames_chunk(
        pcm, state, nxt, no_gain_control=False, no_tonal=False)
    return pack3.pack_device_batch(planes, 384), state


def _at1_call(pcm, state, nxt):
    planes, state = enc1.encode_frames_chunk(pcm, state, nxt)
    merged = {k: planes[k].transpose(1, 2).reshape((-1,) + planes[k].shape[3:])
              for k in AT1_PLANES}
    return pack1.pack_device(merged), state


CODECS = {"at3": (_at3_call, 1024), "at1": (_at1_call, 512)}


def _track(codec, dev):
    """A function that encodes one track of three chunks of ``codec``."""
    call, spf = CODECS[codec]
    cs = CHUNK_FRAMES * spf
    rng = np.random.default_rng(7)
    pcm = torch.from_numpy((0.3 * rng.standard_normal((4, 2, 3 * cs)))
                           .astype(np.float32)).to(dev)
    chunks = [pcm[..., k * cs:(k + 1) * cs].contiguous() for k in range(3)]
    heads = [pcm[..., (k + 1) * cs:(k + 1) * cs + spf].contiguous()
             for k in range(2)] + [None]

    def run():
        state = None
        for x, nxt in zip(chunks, heads):
            _, state = call(x, state, nxt)
    return run


@pytest.mark.parametrize("codec", ["at3", "at1"])
def test_every_sync_is_counted_under_its_span(dev, codec):
    run = _track(codec, dev)
    run()                                   # warm-up: kernels, cuBLAS
    torch.cuda.synchronize()
    trace.enable()
    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            seen.append((trace.current(), f"{filename}:{lineno}"))
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    recs = trace.snapshot()["records"]
    counted = collections.Counter()
    for r in recs:
        if r["counts"].get("host_sync"):
            counted[r["name"]] += r["counts"]["host_sync"]
    warned = collections.Counter(name for name, _ in seen)
    assert warned == counted, sorted(seen)
    calls = sum(1 for r in recs if r["parent"] is None
                and r["name"] == f"{codec}.encode_chunk")
    assert calls == 3
    per_root = collections.Counter()
    for r in recs:
        per_root[r["root_name"]] += r["counts"].get("host_sync", 0)
    print(f"{codec}: {len(seen)} syncs in {calls} calls, by span "
          f"{dict(warned)}, by root {dict(per_root)}; sites "
          f"{sorted(set(s for _, s in seen))}")


def test_spans_share_the_profilers_clock(dev, tmp_path):
    runs = [_track(c, dev) for c in CODECS]
    for run in runs:
        run()
    torch.cuda.synchronize()
    trace.enable()
    for run in runs:                        # outside the profiler
        run()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        # a profiler's first range does its lazy set-up before its start
        # stamp: a cost of the profiler, not a clock, so it is paid here
        with trace._range("profiler warm-up"):
            pass
        for run in runs:
            run()
        torch.cuda.synchronize()
    recs = trace.snapshot()["records"]
    path = str(tmp_path / "profile.json")
    prof.export_chrome_trace(path)
    with open(path) as fp:
        doc = json.load(fp)
    base_us = doc.get("baseTimeNanoseconds", 0) / 1e3
    names = {r["name"] for r in recs}
    notes = sorted((e for e in doc["traceEvents"] if e.get("ph") == "X"
                    and e.get("cat") == "cpu_op" and e["name"] in names),
                   key=lambda e: (e["ts"], -e["dur"]))
    under = sorted((r for r in recs if r["profiled"]),
                   key=lambda r: (r["host"][0], -r["host"][1]))
    assert len(under) == len(recs) // 2 and len(notes) == len(under)
    gaps = []
    for e, r in zip(notes, under):
        assert e["name"] == r["name"]
        gaps.append((r["name"], r["host"][0] / 1e3 - base_us - e["ts"],
                     base_us + e["ts"] + e["dur"] - r["host"][1] / 1e3))
    worst = max(max(abs(a), abs(b)) for _, a, b in gaps)
    assert worst <= CLOCK_US, [g for g in gaps if max(map(abs, g[1:])) > 20]
    for r in recs:                          # device intervals on one clock
        d = r["device"]
        assert d is not None and d[0] <= d[1]
    spans = str(tmp_path / "spans.json")
    trace.write_chrome(spans)
    with open(spans) as fp:
        mine = json.load(fp)
    xs = [e for e in mine["traceEvents"] if e["ph"] == "X"]
    assert {e["tid"] for e in xs} == {0, 1}
    first = min(r["host"][0] for r in recs)
    assert min(mine["baseTimeNanoseconds"] + 1e3 * e["ts"] for e in xs
               if e["tid"] == 0) == pytest.approx(first, abs=1e3)
    print(f"profiler base {doc.get('baseTimeNanoseconds')} ns; {len(under)} "
          f"spans within {worst:.1f} us of their profiler ranges; "
          f"trace keys {sorted(k for k in doc if k != 'traceEvents')}")
    os.remove(path)
