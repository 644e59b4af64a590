"""The device's idle share over the profiled stretch of ATRAC3+ batch
calls: one minus the union of kernel, copy and set intervals over the
stretch's wall time, in %."""
SPANS = []


def read(trace):
    return trace.idle_share()
