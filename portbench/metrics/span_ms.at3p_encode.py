"""Device ms of the program's ``at3p.encode_chunk`` span (the ATRAC3+
encoder of one batch call: ``encode_chunk_device``), per call."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    return pt.per_call("at3p", pt.span_ms("at3p.encode_chunk",
                                          "at3p.encode_chunk"))
