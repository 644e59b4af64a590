"""Device ms of what joint stereo adds to an ATRAC3 batch call, per call:
the M/S matrixing (``ms_matrix``) and the byte shift with the channels'
bit targets (``ms_shift``) under ``at3.encode_chunk``, and the packer's
reversal of channel 1 and merge at the boundary (``js_assemble``) under
``at3.pack``.  None where the program has none of these spans."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()

PARTS = (("ms_matrix", "at3.encode_chunk"), ("ms_shift", "at3.encode_chunk"),
         ("js_assemble", "at3.pack"))


def read(trace):
    parts = [pt.per_call("at3", pt.span_ms(name, root))
             for name, root in PARTS]
    return None if None in parts else sum(parts)
