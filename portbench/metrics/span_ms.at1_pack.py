"""Device ms of the program's ``at1.pack`` span (the ATRAC1 device packer,
``pack_device``), per call."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    return pt.per_call("at1", pt.span_ms("at1.pack", "at1.pack"))
