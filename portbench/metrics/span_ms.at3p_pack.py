"""Device ms of the program's ``at3p.pack`` span (the whole ATRAC3+ device
packer, ``pack_device``), per call."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    return pt.per_call("at3p", pt.span_ms("at3p.pack", "at3p.pack"))
