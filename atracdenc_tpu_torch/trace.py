"""The port's tracer: spans and counters inside the program, kept in memory
and written out at the end.

    from atracdenc_tpu_torch import trace
    trace.enable()
    with trace.span("at3.encode_chunk"):      # or @trace.span("...") on a def
        ...
        trace.count("host_sync")
    snap = trace.snapshot()                   # synchronises once
    trace.write_chrome("spans.json")
    trace.disable()

Off is the default.  Off, a span is one flag test and a ``yield``: it
records nothing, creates no event and never synchronises.  On, a span
records its name, its id, its parent's id, the id and name of its root
(the outermost open span: one batch call, one ``encode_track`` chunk or one
transcoded file) and its host interval; on a CUDA device also a pair of
CUDA events on the current stream, without a synchronisation; and it opens
a profiler range of its name, so that a profiler trace shows every program
span on the profiler's own clock, as a ``cpu_op`` event of the span's name
(the host interval brackets that range, and the events bracket both).  A span opened while a ``torch.profiler`` is
recording is marked ``profiled``, so that readers can leave out what the
profiler slowed.  On, nothing synchronises outside ``snapshot()`` (and
``enable()``'s anchor).

``count(name, n)`` adds to a counter whatever the switch says (the kernel
launch counters ``launch.*`` are read with tracing off); on, the count is
also attributed to the innermost open span.  ``host_sync`` counts the
places where the program blocks the host on the card (``runtime``).
``device_counter(name, dev)`` gives, while tracing is on, an int64 scalar
on the device that a kernel adds its own counts into (None when off, and
the kernel then counts nothing); ``snapshot()`` reads it after its
synchronisation, as the counter's total (no span attribution).

Clocks.  Host times are ``time.time_ns()``: ns on the Unix epoch clock,
the clock on which ``torch.profiler`` stamps its CPU events; its exported
Chrome trace writes them as ``ts`` in us since the file's
``baseTimeNanoseconds`` (1,790,857,026 s on the Unix epoch with torch 2.11
+ CUDA 12.8 on an H100, and with torch 2.13 on the CPU).  ``write_chrome``
writes on such a base, so that adding each file's ``baseTimeNanoseconds``
to its ``ts`` puts both files on one timeline.  Device
times are put on the host clock through an anchor: an event recorded,
waited for and stamped with the host clock at ``enable()`` (and again after
each ``snapshot()``); a span's device interval runs from its first event to
its second, so it starts when the work queued before it has finished.
"""
import contextlib
import itertools
import json
import time

import torch

__all__ = ["enable", "disable", "reset", "span", "count", "device_counter",
           "counter", "current", "snapshot", "summarize", "write_chrome"]

_on = False
_cuda = False
_anchor = None          # (event, host ns) the device times are put on
_stack = []             # open spans, innermost last
_pending = []           # closed spans whose events are not resolved yet
_done = []              # resolved records (dicts)
_loose = {}             # counts made while on, outside every span
_totals = {}            # every count, whatever the switch
_device = {}            # (name, device) -> int64 [1] that kernels add into
_ids = itertools.count(1)
# A span's profiler range: the RecordFunction that torch.profiler's
# record_function opens, without record_function's dispatcher op.  Its ends
# lie 0.3-82 us inside the span's host interval under CUDA profiling on an
# H100; record_function's lie up to 106 us inside.
_range = torch._C._profiler._RecordFunctionFast


class _Span:
    __slots__ = ("name", "id", "parent", "root", "root_name", "profiled",
                 "t0", "t1", "e0", "e1", "anchor", "counts")

    def __init__(self, name, parent):
        self.name = name
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.root_name = parent.root_name if parent is not None else name
        self.profiled = torch._C._autograd._profiler_enabled()
        self.e0 = self.e1 = None
        self.anchor = _anchor
        self.counts = {}


def _new_anchor():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    ev.synchronize()
    return ev, time.time_ns()


def enable(cuda=None):
    """Switch tracing on (a no-op when on).  ``cuda``: record device
    intervals; None means when ``torch.cuda.is_available()``."""
    global _on, _cuda, _anchor
    if _on:
        return
    _cuda = torch.cuda.is_available() if cuda is None else bool(cuda)
    if _cuda:
        _anchor = _new_anchor()
    _on = True


def disable():
    """Switch tracing off; what was recorded stays for ``snapshot()``."""
    global _on
    _on = False


def reset():
    """Forget every record and zero every counter."""
    _pending.clear()
    _done.clear()
    _loose.clear()
    _totals.clear()
    _device.clear()


@contextlib.contextmanager
def span(name):
    """A span of the program (context manager, or decorator of a def)."""
    if not _on:
        yield
        return
    s = _Span(name, _stack[-1] if _stack else None)
    _stack.append(s)
    try:
        if _cuda:
            s.e0 = torch.cuda.Event(enable_timing=True)
            s.e0.record()
        s.t0 = time.time_ns()
        with _range(name):
            yield
        s.t1 = time.time_ns()
        if _cuda:
            s.e1 = torch.cuda.Event(enable_timing=True)
            s.e1.record()
    finally:
        _stack.pop()
    _pending.append(s)


def count(name, n=1):
    """Add ``n`` to counter ``name`` (and, on, to the innermost span's)."""
    _totals[name] = _totals.get(name, 0) + n
    if _on:
        c = _stack[-1].counts if _stack else _loose
        c[name] = c.get(name, 0) + n


def device_counter(name, dev):
    """On: the int64 [1] tensor on ``dev`` that kernels add counter
    ``name``'s counts into (zero after ``reset()``); off: None."""
    if not _on:
        return None
    key = (name, str(dev))
    if key not in _device:
        _device[key] = torch.zeros(1, dtype=torch.int64, device=dev)
    return _device[key]


def counter(name):
    """The running total of counter ``name`` since the last ``reset()``."""
    return _totals.get(name, 0)


def current():
    """The innermost open span's name, or None."""
    return _stack[-1].name if (_on and _stack) else None


def _device_ns(anchor, ev):
    a_ev, a_ns = anchor
    return a_ns + round(a_ev.elapsed_time(ev) * 1e6)


def _resolve():
    global _anchor
    if not _pending:
        return
    if any(s.e0 is not None for s in _pending):
        torch.cuda.synchronize()
    for s in _pending:
        dev = None
        if s.e0 is not None and s.anchor is not None:
            dev = [_device_ns(s.anchor, s.e0), _device_ns(s.anchor, s.e1)]
        _done.append({"name": s.name, "id": s.id, "parent": s.parent,
                      "root": s.root, "root_name": s.root_name,
                      "profiled": s.profiled, "host": [s.t0, s.t1],
                      "device": dev, "counts": s.counts})
    _pending.clear()
    if _on and _cuda:
        _anchor = _new_anchor()


def _ms(iv):
    return (iv[1] - iv[0]) / 1e6


def summarize(records, loose=None):
    """Plain records -> {"spans": {name: {count, host_ms, device_ms,
    self_ms}}, "counters": {name: {total, by_span}}}.

    ``self_ms`` is a span's duration less its children's (children lie
    inside their parent on both clocks), on the device where the span has
    device times, else on the host."""
    kids = {}
    for r in records:
        if r["parent"] is not None:
            kids.setdefault(r["parent"], []).append(r)
    spans, counters = {}, {}
    for r in records:
        e = spans.setdefault(r["name"], {"count": 0, "host_ms": 0.0,
                                         "device_ms": None, "self_ms": 0.0})
        e["count"] += 1
        e["host_ms"] += _ms(r["host"])
        clock = "host" if r["device"] is None else "device"
        if clock == "device":
            e["device_ms"] = (e["device_ms"] or 0.0) + _ms(r["device"])
        e["self_ms"] += _ms(r[clock]) - sum(
            _ms(c[clock]) for c in kids.get(r["id"], ()))
        for k, n in r["counts"].items():
            c = counters.setdefault(k, {"total": 0, "by_span": {}})
            c["total"] += n
            c["by_span"][r["name"]] = c["by_span"].get(r["name"], 0) + n
    for k, n in (loose or {}).items():
        c = counters.setdefault(k, {"total": 0, "by_span": {}})
        c["total"] += n
    return {"spans": spans, "counters": counters}


def snapshot():
    """Synchronise once, resolve every closed span's events against its
    anchor and free them -> {"records": [plain records], "spans",
    "counters"} (``summarize`` of all records, the counts made outside
    every span and the device counters in the totals).  Each record: name,
    id, parent, root, root_name, profiled, host [t0, t1] ns, device [t0,
    t1] ns or None, counts {counter: n} made while it was the innermost
    span."""
    _resolve()
    records = list(_done)
    out = summarize(records, _loose)
    for (name, _), t in _device.items():
        c = out["counters"].setdefault(name, {"total": 0, "by_span": {}})
        c["total"] += int(t.item())  # waits for the kernels that add to it
    out["records"] = records
    return out


def write_chrome(path):
    """Write every record as a Chrome trace: one host track and one device
    track, ``ts`` in us since ``baseTimeNanoseconds``, the whole second
    before the first record."""
    records = snapshot()["records"]
    first = min((r["host"][0] for r in records), default=time.time_ns())
    base_ns = first // 10 ** 9 * 10 ** 9
    events = [{"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
               "args": {"name": "atracdenc_tpu_torch spans"}},
              {"ph": "M", "name": "thread_name", "pid": 0, "tid": 0,
               "args": {"name": "host"}},
              {"ph": "M", "name": "thread_name", "pid": 0, "tid": 1,
               "args": {"name": "device"}}]
    for r in records:
        args = {"id": r["id"], "parent": r["parent"], "root": r["root"],
                "profiled": r["profiled"], **r["counts"]}
        for tid, iv in ((0, r["host"]), (1, r["device"])):
            if iv is not None:
                events.append({"ph": "X", "cat": "span", "name": r["name"],
                               "pid": 0, "tid": tid,
                               "ts": (iv[0] - base_ns) / 1e3,
                               "dur": (iv[1] - iv[0]) / 1e3, "args": args})
    with open(path, "w") as fp:
        json.dump({"traceEvents": events, "baseTimeNanoseconds": base_ns,
                   "displayTimeUnit": "ms"}, fp)
