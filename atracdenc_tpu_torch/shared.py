"""The host modules the port shares with ``atracdenc_tpu``.

They use numpy and the standard library only, never JAX, so the port
imports them as they are instead of copying them: the ATRAC3 tables, the
host frame packer, the containers, audio I/O and the CLI's operator
messages.  Every module of the port, and ``chip_smoke.py``, takes them
from here, so this file is the one list of what the port needs from the
JAX package; tests/test_torch_port_hygiene.py holds the port to it.
"""
from atracdenc_tpu.containers import at3, oma, raw, rm
from atracdenc_tpu.io import audio, wav
from atracdenc_tpu.models.atrac3 import frame, tables
from atracdenc_tpu.utils import operator_log, progress

__all__ = ["at3", "audio", "frame", "oma", "operator_log", "progress", "raw",
           "rm", "tables", "wav"]
