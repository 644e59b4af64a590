"""The host modules the port shares with ``atracdenc_tpu``.

They use numpy and the standard library only, never JAX, so the port
imports them as they are instead of copying them: the ATRAC3 and ATRAC1
tables, the host frame packers, the containers, audio I/O, the CLI's
operator messages and the ATRAC1 exact-semantics QA paths.  Every module
of the port, and ``chip_smoke.py``, takes them from here, so this file is
the one list of what the port needs from the JAX package;
tests/test_torch_port_hygiene.py holds the port to it.
"""
from atracdenc_tpu.containers import aea, at3, oma, raw, rm
from atracdenc_tpu.io import audio, wav
from atracdenc_tpu.models.atrac1 import exact_enc as at1_exact_enc
from atracdenc_tpu.models.atrac1 import exact_synth as at1_exact_synth
from atracdenc_tpu.models.atrac1 import frame as at1_frame
from atracdenc_tpu.models.atrac1 import tables as at1_tables
from atracdenc_tpu.models.atrac3 import frame, tables
from atracdenc_tpu.utils import operator_log, progress

__all__ = ["aea", "at1_exact_enc", "at1_exact_synth", "at1_frame",
           "at1_tables", "at3", "audio", "frame", "oma", "operator_log",
           "progress", "raw", "rm", "tables", "wav"]
