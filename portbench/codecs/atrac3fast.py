"""The ATRAC3 call path of ``atrac3.py``, under the name whose reference,
``portbench/reference/atrac3fast.py``, codes the upstream encoder's frames
fast enough for a cell to check past its first 512-frame carry."""
from portbench.codecs.atrac3 import (CHANNELS_PER_ROW, MODULES,  # noqa: F401
                                     SAMPLES_PER_FRAME, Codec)
