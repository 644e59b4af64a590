"""The program's own spans and counters (``atracdenc_tpu_torch/trace.py``)
for the per-layer metrics of a traced run.

A reader that imports this module switches the program's tracer on, after
the cell's set-up (readers load only in ``--trace 1`` runs, so the
end-to-end metrics are of the tracer off).  A reader leaves out the
records made while the profiler recorded, and gives each value per call:
over the number of its codec's ``<codec>.encode_chunk`` root spans.  A
program without the tracer leaves ``trace`` None, and every reader then
returns None.
"""
try:
    from atracdenc_tpu_torch import trace
except ImportError:
    trace = None


def switch_on():
    if trace is not None:
        trace.enable()


def per_call(codec, value):
    """``value(records)`` over the ``<codec>.encode_chunk`` roots of the
    records not made under the profiler; None when the program has no
    tracer, when there is no such root, or when ``value`` gives None."""
    if trace is None:
        return None
    recs = [r for r in trace.snapshot()["records"] if not r["profiled"]]
    calls = sum(1 for r in recs if r["parent"] is None
                and r["name"] == codec + ".encode_chunk")
    v = value(recs) if calls else None
    return None if v is None else v / calls


def span_ms(name, root, clock="device"):
    """A ``value`` for ``per_call``: ms on ``clock`` ("device" or "host")
    of the spans ``name`` under roots named ``root``."""
    def value(recs):
        ivs = [r[clock] for r in recs
               if r["name"] == name and r["root_name"] == root]
        if not ivs or any(iv is None for iv in ivs):
            return None
        return sum(b - a for a, b in ivs) / 1e6
    return value


def counted(counter, codec):
    """A ``value`` for ``per_call``: ``counter``'s count under every root
    of ``codec`` (root names ``<codec>.*``)."""
    def value(recs):
        return sum(r["counts"].get(counter, 0) for r in recs
                   if r["root_name"].startswith(codec + "."))
    return value
