"""ATRAC3 gain control (``models/atrac3/gain.py::gain_control``): ms per
call, the device synchronised around each call of the stage."""
SPANS = [{"name": "at3_gain_control", "target": "{gain}:gain_control",
          "clock": "sync"}]


def read(trace):
    return trace.span_ms_per_call("at3_gain_control")
