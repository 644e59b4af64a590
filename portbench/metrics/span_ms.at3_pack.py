"""Device ms of the program's ``at3.pack`` span (the whole ATRAC3 device
packer, ``pack_device_batch``), per call."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    return pt.per_call("at3", pt.span_ms("at3.pack", "at3.pack"))
