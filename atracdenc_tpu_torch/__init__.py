"""atracdenc_tpu_torch — the ATRAC1 and ATRAC3 codecs of ``atracdenc_tpu``
in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package ``atracdenc_tpu`` is the reference; every stage here is
held against it on the same inputs (tests/test_torch_*.py).  The port
imports nothing of it: the numpy-only host modules (tables, the frame
packers, containers, audio I/O, the exact-semantics paths, the YAML gain
log, the OMA tools, the native bit packer) are copies kept at the same
paths, so each has its counterpart there.

Layout mirrors ``atracdenc_tpu``:
  runtime.py   device selection, f32 policy, numpy <-> torch
  kernels.py   builds csrc/*.cu with nvcc and loads them with ctypes
  ops/         DSP stages, the bit deposit and the kernel wrappers
               (quant_cost, greedy, rate_control, at1_alloc), each beside
               its plain PyTorch version
  models/atrac3/  the ATRAC3 encoder, its device packer and CLI glue, the
               QA decoder, the tables, the host frame packer, the
               exact-semantics encoder and the YAML gain log
  models/atrac1/  the ATRAC1 encoder, decoder and device packer, the
               tables, the host frame packer and the exact-semantics paths
  containers/, io/  AEA / OMA / AT3 / RM / RAW files, WAV and audio I/O
  utils/       host bit packing (native/bitpack.cpp when a compiler is
               present, else numpy), operator messages, progress
  tools/       omainfo and omacp (OMA header info, frame-by-frame copy)
  cli.py       the command-line entry point (ATRAC1 and ATRAC3 encode /
               decode)
"""

__version__ = "0.1.0"
