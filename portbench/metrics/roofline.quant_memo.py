"""The ATRAC3 quantisation-cost memo (``bitalloc.quant_tensors``, kernels A
and B, or D with ``fused_memo``): its least time on the card
(``portbench/work.py::quant_memo``) over its device time between CUDA
events, in %."""
SPANS = [{"name": "quant_memo", "target": "{encoder}:quant_tensors",
          "clock": "events", "work": "quant_memo"}]


def read(trace):
    return trace.roofline("quant_memo")
