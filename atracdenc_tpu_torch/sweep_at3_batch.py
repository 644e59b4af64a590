"""Batch-shape sweep of the ATRAC3 encode path on one GPU.

    python -m atracdenc_tpu_torch.sweep_at3_batch [--iters 4] [--repeats 3]
        [--grid 32x256,64x256,...] [--pallas] [--fused-memo] [--device cpu]

The counterpart of ``tools/sweep_at3_batch.py`` (the JAX package): the
stereo frames/s of the bench's ATRAC3 leg (``bench.at3_encode``: default
mode, encode + device packer, LP2 384 B) at each grid point of (streams,
frames per stream), to find where the rate levels off with the shape and
how much of the card a shape takes.  ``--pallas`` runs the kernel route
(kernels A, B and C); without it the rate control runs as tensor ops
(``use_rate_kernel=False``), as the JAX tool runs XLA without it.
``--fused-memo`` computes the memo in kernel D (``fused_memo=True``, the
port's counterpart of the JAX package's ``ATRACDENC_TPU_PALLAS`` memo).

A point's corpus is ``bench.corpus(streams, frames)`` (seed 42).  Its
bytes are checked before they are timed (``bench.check_at3``: the device
packer's bytes of the route's planes, stream 0 equal to ``frame.pack``);
then ``--repeats`` windows of ``bench.pipelined`` (``--iters`` calls, 2 in
flight, every byte in pinned host memory; each window asserts that its
last copy equals the checked bytes).  A row gives the shape, the median
frames/s with [min, max] over the windows, x ref (bench.py's 1046.0), the
peak device memory of the point in GiB and its share of the card's
``total_memory``, and the SHA-256 of the point's bytes.  The last line is
one JSON object: the card's ``name`` and ``power.limit`` (nvidia-smi) and
every row.

A point that raises ``torch.cuda.OutOfMemoryError`` is recorded as
``"oom"``, the allocator's cache is emptied and the sweep goes on; any
other exception ends the run with a non-zero exit.  There is no fallback:
without a card the tool exits non-zero unless ``--device cpu`` asks for
the CPU (the kernels' plain versions; a liveness check, not a
measurement).

``measure``, ``parse_grid``, ``card_info``, ``row_line`` and ``arguments``
are shared with ``sweep_at1_batch`` and ``perf_campaign``.
"""
import argparse
import functools
import json
import statistics

import torch

from atracdenc_tpu_torch import bench, runtime

DEFAULT_GRID = ("32x256", "64x256", "128x256", "32x512", "64x512",
                "128x512", "32x1024", "64x1024", "256x256")


def arguments(prog, description, grid=None):
    """The sweeps' common options (``--grid`` only where ``grid`` is the
    tool's default grid)."""
    p = argparse.ArgumentParser(prog=f"python -m atracdenc_tpu_torch.{prog}",
                                description=description)
    p.add_argument("--iters", type=int, default=4,
                   help="calls a window (2 in flight)")
    p.add_argument("--repeats", type=int, default=3,
                   help="windows a point; a rate is their median")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (default; no fallback) or cpu (plain versions)")
    if grid is not None:
        p.add_argument("--grid", default=",".join(grid),
                       help="points STREAMSxFRAMES, comma-separated")
    return p


def parse_grid(spec):
    """"32x256,64x512" -> [(32, 256), (64, 512)]."""
    return [tuple(int(v) for v in s.lower().split("x"))
            for s in spec.split(",") if s]


def card_info(dev):
    """{"name", "power.limit", "total_memory_gib"} of the card (None on the
    CPU)."""
    name, limit = bench.card(dev)
    total = (torch.cuda.get_device_properties(dev).total_memory
             if dev.type == "cuda" else None)
    return {"name": name, "power.limit": limit,
            "total_memory_gib": None if total is None else total / 2 ** 30}


def _point(dev, encode, make_x, n_items, check, repeats, iters):
    x = make_x()
    out = encode(x)
    check(x, out)
    window = bench.pipelined(dev, encode, x, n_items, out.cpu(), calls=iters)
    rates = [window() for _ in range(repeats)]
    return rates, bench.sha256(out)


def measure(dev, encode, make_x, n_items, check, repeats, iters, unit,
            ref_rate):
    """One grid point: ``make_x()`` on ``dev``, ``encode(x)``'s bytes
    checked by ``check(x, out)`` (it asserts), then ``repeats`` pipelined
    windows of ``iters`` calls.  Returns the row's measured keys: ``status``
    ("ok" or "oom"), ``{unit}`` (median items/s), ``spread`` [min, max],
    ``vs_ref``, ``peak_gib``, ``mem_share`` and ``sha256`` (peak memory
    None on the CPU)."""
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        rates, digest = _point(dev, encode, make_x, n_items, check, repeats,
                               iters)
    except torch.cuda.OutOfMemoryError:
        rates = None
    if rates is None:                    # the point's tensors are gone
        torch.cuda.empty_cache()
        return {"status": "oom"}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    med = statistics.median(rates)
    return {"status": "ok", unit: med,
            "spread": [min(rates), max(rates)], "vs_ref": med / ref_rate,
            "peak_gib": None if peak is None else peak / 2 ** 30,
            "mem_share": None if peak is None else
            peak / torch.cuda.get_device_properties(dev).total_memory,
            "sha256": digest}


def row_line(label, row, unit, word):
    """A row as a line of text (``word``: what the rate counts)."""
    if row["status"] != "ok":
        return f"{label}: {row['status']}"
    lo, hi = row["spread"]
    mem = ("" if row["peak_gib"] is None else
           f"  peak {row['peak_gib']:.2f} GiB ({100 * row['mem_share']:.1f}%)")
    return (f"{label}: {row[unit]:10.1f} {word}/s [{lo:.1f}, {hi:.1f}]  "
            f"({row['vs_ref']:6.2f}x ref){mem}  sha256 {row['sha256'][:12]}")


def main(argv=None):
    p = arguments("sweep_at3_batch", __doc__.split("\n\n")[0], DEFAULT_GRID)
    p.add_argument("--pallas", action="store_true",
                   help="kernel route (A, B, C); default: tensor-op rate "
                        "control")
    p.add_argument("--fused-memo", action="store_true",
                   help="compute the memo in kernel D (fused_memo=True)")
    args = p.parse_args(argv)
    if args.repeats < 1 or args.iters < 1:
        p.error("--repeats and --iters must be >= 1")
    grid = parse_grid(args.grid)
    dev = runtime.device(args.device)
    route = dict(use_rate_kernel=args.pallas, fused_memo=args.fused_memo)
    encode = functools.partial(bench.at3_encode, **route)
    check = functools.partial(bench.check_at3, **route)
    print(f"backend: {dev.type}  pallas={args.pallas}  "
          f"fused_memo={args.fused_memo}", flush=True)
    rows = []
    for s, f in grid:
        row = {"streams": s, "frames": f, "items": s * f}
        row.update(measure(
            dev, encode,
            lambda: torch.from_numpy(bench.corpus(s, f)).to(dev),
            s * f, check, args.repeats, args.iters, "frames_per_s",
            bench.REF_FRAMES_PER_S))
        rows.append(row)
        print(row_line(f"{s:4d} x {f:5d} ({s * f:7d} frames)", row,
                       "frames_per_s", "frames"), flush=True)
    line = {"tool": "sweep_at3_batch", "backend": dev.type, **card_info(dev),
            "pallas": args.pallas, "fused_memo": args.fused_memo,
            "repeats": args.repeats, "iters": args.iters, "rows": rows}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
