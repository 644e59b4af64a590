"""Device ms of the program's ``loudness_scan`` span under
``at1.encode_chunk`` (the loudness IIR's loop over the chunk's frames,
``ops/psy.py::track_loudness_scan``), per call."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    return pt.per_call("at1", pt.span_ms("loudness_scan", "at1.encode_chunk"))
