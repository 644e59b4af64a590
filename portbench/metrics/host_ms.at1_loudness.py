"""Host ms of the program's ``loudness_scan`` span under
``at1.encode_chunk``, per call: the time the host takes to enqueue the
loop.  Near ``span_ms.at1_loudness``, the host paces the loop."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    return pt.per_call("at1", pt.span_ms("loudness_scan", "at1.encode_chunk",
                                         "host"))
