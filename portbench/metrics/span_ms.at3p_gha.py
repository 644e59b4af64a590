"""Device ms of the program's GHA spans under ``at3p.encode_chunk``: the
tonal model's extraction (``gha_extract``) and the synthesis subtracted
from the residual (``gha_subtract``), per call."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    parts = [pt.per_call("at3p", pt.span_ms(name, "at3p.encode_chunk"))
             for name in ("gha_extract", "gha_subtract")]
    return None if None in parts else sum(parts)
