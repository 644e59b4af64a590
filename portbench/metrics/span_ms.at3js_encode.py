"""Device ms of the program's ``at3.encode_chunk`` span (the ATRAC3
encoder of one batch call, on the joint-stereo route), per call."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    return pt.per_call("at3", pt.span_ms("at3.encode_chunk",
                                         "at3.encode_chunk"))
