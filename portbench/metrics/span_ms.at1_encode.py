"""Device ms of the program's ``at1.encode_chunk`` span (the ATRAC1
encoder of one batch call: ``encode_frames_chunk``), per call."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    return pt.per_call("at1", pt.span_ms("at1.encode_chunk",
                                         "at1.encode_chunk"))
