"""The program's ``host_sync`` count (the host blocked on the card: a
copy between pageable host memory and the card, a device value read on
the host) under the ATRAC3+ roots (``at3p.*``), per call."""
from portbench import program_trace as pt

SPANS = []
pt.switch_on()


def read(trace):
    return pt.per_call("at3p", pt.counted("host_sync", "at3p"))
