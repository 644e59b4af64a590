"""Device ms of the program's ``gain_control`` span (ATRAC3 gain control,
``models/atrac3/gain.py::gain_control``, the span inside the function),
per call."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    return pt.per_call("at3", pt.span_ms("gain_control", "at3.encode_chunk"))
