"""atracdenc_tpu_torch — the ATRAC3 encoder of ``atracdenc_tpu`` in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``atracdenc_tpu`` is the reference; every stage here is
held against it on the same inputs (tests/test_torch_*.py).  Host-only
modules that import no JAX (tables, the frame packer, containers, audio
I/O) are imported from ``atracdenc_tpu`` as they are.

Layout mirrors ``atracdenc_tpu``:
  runtime.py   device selection, f32 policy, numpy <-> torch
  shared.py    the numpy-only modules taken from ``atracdenc_tpu``
  kernels.py   builds csrc/*.cu with nvcc and loads them with ctypes
  ops/         DSP stages and the kernel wrappers (quant_cost, greedy,
               rate_control), each beside its plain PyTorch version
  models/atrac3/  the ATRAC3 encoder and its CLI glue
  cli.py       the command-line driver (ATRAC3 encode)
"""

__version__ = "0.1.0"
