"""What a traced run records: spans around calls into the program's layers,
and a ``torch.profiler`` stretch of the device.

Spans are put on from the benchmark's own files: a per-layer metric's
reader names the functions it needs (``SPANS``), and ``Spans`` replaces
each named module attribute by a timing wrapper for the stretch, then puts
the original back.  A span's clock is one of

* ``sync``: the host clock with the device synchronised before and after
  (the stage's own time, nothing queued before it counted);
* ``events``: CUDA events recorded around the call on the current stream,
  no synchronisation (the device's time from the end of the work queued
  before it to the end of its own); with a ``work`` function of
  ``portbench/work.py``, the call's least work is kept beside it;
* ``host``: the host clock alone.

``profile`` runs a stretch under the profiler and reduces its trace to the
device's busy time (the union of kernel, copy and set intervals, not
their sum), the kernel launches, the ten device operations that took most
time and the ten longest idle gaps, each named by the innermost host
operation running at its middle.
"""
import collections
import contextlib
import importlib
import json
import os
import time

import torch

from portbench import work

NAME_CHARS = 120


class Trace:
    """Everything a traced run gives the metric readers."""

    def __init__(self, device_name):
        self.device_name = device_name
        self.spans = collections.defaultdict(list)    # name -> [ms]
        self.works = collections.defaultdict(list)    # name -> [(ops, bytes)]
        self.calls = 0                                # calls in the span stretch
        self.profile = None

    def span_ms_per_call(self, *names):
        """Sum of the named spans' ms over the stretch, per call; None if
        none was recorded."""
        if self.calls == 0 or not any(self.spans.get(n) for n in names):
            return None
        return sum(sum(self.spans.get(n, ())) for n in names) / self.calls

    def idle_share(self):
        """The device's idle share of the profiled stretch, in %."""
        if self.profile is None or not self.profile["window_s"]:
            return None
        return 100.0 * (1.0 - self.profile["busy_s"] / self.profile["window_s"])

    def roofline(self, name):
        """Least time over measured time of a span with work, in %."""
        ms, wk = self.spans.get(name), self.works.get(name)
        if not ms or not wk:
            return None
        least = [work.least_seconds(o, b, self.device_name) for o, b in wk]
        if any(x is None for x in least):
            return None
        return 100.0 * sum(least) / (sum(ms) / 1e3)


def resolve(target, modules):
    """``"{encoder}:encode_track"`` -> (module, attribute), or None when
    the codec has no such module."""
    mod, attr = target.split(":")
    if mod.startswith("{"):
        mod = modules.get(mod[1:-1])
        if mod is None:
            return None
    mod = importlib.import_module(mod)
    return (mod, attr) if hasattr(mod, attr) else None


class Spans(contextlib.AbstractContextManager):
    """Install the span wrappers of ``specs`` for a stretch."""

    def __init__(self, specs, modules, trace, cuda):
        self.trace, self.cuda = trace, cuda
        self.installed = []
        self.pending = []                              # (name, e0, e1)
        for spec in specs:
            where = resolve(spec["target"], modules)
            if where is not None:
                self.installed.append((where, spec))

    def _wrap(self, fn, spec):
        name, clock = spec["name"], spec["clock"]
        measure = getattr(work, spec["work"]) if spec.get("work") else None
        trace, cuda = self.trace, self.cuda

        def wrapper(*args, **kwargs):
            if clock == "events" and cuda:
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn(*args, **kwargs)
                e1.record()
                self.pending.append((name, e0, e1))
            else:
                if clock == "sync" and cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if clock == "sync" and cuda:
                    torch.cuda.synchronize()
                trace.spans[name].append((time.perf_counter() - t0) * 1e3)
            if measure is not None:
                trace.works[name].append(measure(args, kwargs, out))
            return out
        return wrapper

    def __enter__(self):
        self.saved = []
        for (mod, attr), spec in self.installed:
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, spec))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        if self.pending:
            torch.cuda.synchronize()
            for name, e0, e1 in self.pending:
                self.trace.spans[name].append(e0.elapsed_time(e1))
        return False


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def profile(stretch, path):
    """Run ``stretch()``, which returns the calls it made, under the
    profiler.  Returns ({"busy_s", "window_s", "launches_per_call",
    "device_ops", "idle_gaps"}, calls); the trace file at ``path`` is
    removed."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = stretch()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(path)
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    os.remove(path)
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev.append(e)
        elif cat == "cpu_op":
            host.append(e)
    launches = sum(1 for e in dev if e["cat"] == "kernel")
    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"][:NAME_CHARS]] += e["dur"] / 1e6
    merged = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_s = sum(b - a for a, b in merged) / 1e6
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    idle = []
    for dur, a, b in gaps:
        mid = (a + b) / 2
        inside = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        what = min(inside, key=lambda e: e["dur"])["name"] if inside \
            else "no host op"
        idle.append([what[:NAME_CHARS], dur / 1e6])
    calls = result
    return {"busy_s": busy_s, "window_s": window_s,
            "launches_per_call": launches / calls if calls else None,
            "device_ops": [[k, v] for k, v in by_name.most_common(10)],
            "idle_gaps": idle}, calls
