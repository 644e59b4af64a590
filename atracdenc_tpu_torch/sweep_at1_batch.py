"""Batch-shape sweep of the ATRAC1 encode path on one GPU.

    python -m atracdenc_tpu_torch.sweep_at1_batch [--iters 4] [--repeats 3]
        [--grid 8x512,16x512,...] [--pallas] [--device cpu]

The counterpart of ``tools/sweep_at1_batch.py`` (the JAX package): the
sound units/s (one unit = 512 samples of one channel) of the bench's
ATRAC1 leg (``bench.at1_encode``: encode + device packer) at each grid
point of (streams, frames per stream), stereo.  ``--pallas`` runs kernel E
in the rate control; without it the rate control runs as tensor ops
(``bitalloc.allocate``, ``use_rate_kernel=False``), as the JAX tool runs
XLA without it.  Both routes give the same bytes.

A point's corpus is ``bench.corpus`` cut to ``frames`` x 512 samples a
channel, as the bench cuts its ATRAC1 leg (8 x 512 is the bench's leg).
Bytes are checked before they are timed (``bench.check_at1``), then timed
and reported as in ``sweep_at3_batch`` (x ref: bench.py's 11670.0 units/s),
with the same handling of ``torch.cuda.OutOfMemoryError`` and no fallback.
"""
import functools
import json

import torch

from atracdenc_tpu_torch import bench, runtime
from atracdenc_tpu_torch.sweep_at3_batch import (arguments, card_info, measure,
                                                 parse_grid, row_line)

DEFAULT_GRID = ("8x512", "16x512", "32x512", "64x512", "32x1024", "64x1024",
                "128x512")


def at1_corpus(streams, frames, dev):
    """[streams, 2, 512 * frames] on ``dev``: the bench corpus of
    ceil(frames / 2) stereo frames, cut to whole sound units."""
    pcm = bench.corpus(streams, -(-frames // 2))[:, :, :512 * frames]
    return torch.from_numpy(pcm).to(dev)


def main(argv=None):
    p = arguments("sweep_at1_batch", __doc__.split("\n\n")[0], DEFAULT_GRID)
    p.add_argument("--pallas", action="store_true",
                   help="kernel E in the rate control; default: tensor ops")
    args = p.parse_args(argv)
    if args.repeats < 1 or args.iters < 1:
        p.error("--repeats and --iters must be >= 1")
    grid = parse_grid(args.grid)
    dev = runtime.device(args.device)
    encode = functools.partial(bench.at1_encode, use_rate_kernel=args.pallas)
    check = functools.partial(bench.check_at1, use_rate_kernel=args.pallas)
    print(f"backend: {dev.type}  pallas={args.pallas}", flush=True)
    rows = []
    for s, f in grid:
        units = s * 2 * f
        row = {"streams": s, "frames": f, "items": units}
        row.update(measure(dev, encode, lambda: at1_corpus(s, f, dev), units,
                           check, args.repeats, args.iters, "units_per_s",
                           bench.REF_AT1_UNITS_PER_S))
        rows.append(row)
        print(row_line(f"{s:4d} x {f:5d} ({units:7d} units)", row,
                       "units_per_s", "units"), flush=True)
    line = {"tool": "sweep_at1_batch", "backend": dev.type, **card_info(dev),
            "pallas": args.pallas, "repeats": args.repeats,
            "iters": args.iters, "rows": rows}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
