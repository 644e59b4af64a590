"""The loudness IIR (``ops/psy.py::track_loudness_scan``, a loop over the
chunk's frames): ms per call, the device synchronised around the stage."""
SPANS = [{"name": "loudness_scan", "target": "{psy}:track_loudness_scan",
          "clock": "sync"}]


def read(trace):
    return trace.span_ms_per_call("loudness_scan")
