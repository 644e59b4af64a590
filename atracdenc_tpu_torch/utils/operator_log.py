"""Operator-feedback warnings shared by the codec CLI paths.

The reference prints a scale warning per clipped spectral value
(atrac_scale.cpp:150-167); the batched pipeline aggregates the count and
the maximum over the whole track.
"""
import sys

import numpy as np


def warn_clipping(planes, pop=False):
    """Print the aggregate scale-clip warning if any value clipped.

    pop=True removes the clip_* diagnostic planes from `planes` (the AT1
    packer consumes every plane, so diagnostics must not reach it)."""
    take = planes.pop if pop else planes.get
    count = int(np.asarray(take("clip_count", 0)).sum())
    mx = float(np.asarray(take("clip_max", 0.0)).max())
    if count:
        print(f"Scale error: absSpec > MAX_SCALE, val: {mx:g} "
              f"({count} clipped spectral values)", file=sys.stderr)
