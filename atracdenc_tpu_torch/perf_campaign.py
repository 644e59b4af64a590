"""The perf campaign on one GPU: both rate-control routes at several stream
counts.

    python -m atracdenc_tpu_torch.perf_campaign [--seconds 47.5] [--iters 4]
        [--streams 16,32,64] [--repeats 3] [--device cpu]

The counterpart of ``tools/perf_campaign.py`` (the JAX package), with its
report keys.  The corpus is ``bench.corpus(max streams, F)`` (seed 42),
F = ``--seconds`` of 44.1 kHz audio in whole 1024-sample frames (2,045 at
47.5 s: the JAX tool's corpus, draw for draw); a stream count takes its
first streams.

* ``at3.s{N}_xla`` / ``at3.s{N}_pallas``: ATRAC3 default mode, encode +
  device packer (``bench.at3_encode``) on N streams of F stereo frames;
  ``_xla`` is the tensor-op rate control (``use_rate_kernel=False``, the
  JAX XLA path's counterpart), ``_pallas`` kernel C (with A and B in the
  memo on both routes; the port has no global that a route flips).
* ``at1.xla`` / ``at1.pallas``: ATRAC1 encode + device packer
  (``bench.at1_encode``) on the first min(8, N) streams cut to 512 x 512
  samples (or the whole corpus if shorter); ``xla`` runs
  ``bitalloc.allocate`` as tensor ops, ``pallas`` kernel E.

Each entry is a ``sweep_at3_batch.measure`` row (bytes checked before
they are timed, median ``frames_per_s`` / ``units_per_s`` with its spread,
``vs_ref`` against bench.py's 1046.0 and 11670.0, peak device memory,
SHA-256) or ``{"status": "oom"}``.  Both routes' bytes are asserted equal.
The last line is the JSON report with the card's ``name`` and
``power.limit``.  No fallback: without a card the tool exits non-zero
unless ``--device cpu`` is given.
"""
import functools
import json

import numpy as np
import torch

from atracdenc_tpu_torch import bench, runtime
from atracdenc_tpu_torch.sweep_at3_batch import (arguments, card_info, measure,
                                                 row_line)

ROUTES = (("xla", False), ("pallas", True))


def _same_bytes(a, b, what):
    if a["status"] == b["status"] == "ok":
        assert a["sha256"] == b["sha256"], f"{what}: the routes' bytes differ"


def main(argv=None):
    p = arguments("perf_campaign", __doc__.split("\n\n")[0])
    p.add_argument("--seconds", type=float, default=47.5)
    p.add_argument("--streams", default="16,32,64")
    args = p.parse_args(argv)
    if args.repeats < 1 or args.iters < 1:
        p.error("--repeats and --iters must be >= 1")
    counts = [int(s) for s in args.streams.split(",")]
    nframes = int(args.seconds * 44100) // 1024
    if nframes < 1:
        p.error("--seconds gives no whole frame")
    dev = runtime.device(args.device)
    pcm = bench.corpus(max(counts), nframes)
    report = {"platform": dev.type,
              "device": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
              **card_info(dev), "seconds": args.seconds,
              "frames_per_stream": nframes, "repeats": args.repeats,
              "iters": args.iters, "at3": {}, "at1": {}}

    for s in counts:
        for name, kernel in ROUTES:
            report["at3"][f"s{s}_{name}"] = row = measure(
                dev, functools.partial(bench.at3_encode,
                                       use_rate_kernel=kernel),
                lambda: torch.from_numpy(pcm[:s]).to(dev), s * nframes,
                functools.partial(bench.check_at3, use_rate_kernel=kernel),
                args.repeats, args.iters, "frames_per_s",
                bench.REF_FRAMES_PER_S)
            print(row_line(f"at3 s={s} {name}", row, "frames_per_s",
                           "frames"), flush=True)
        _same_bytes(report["at3"][f"s{s}_xla"], report["at3"][f"s{s}_pallas"],
                    f"ATRAC3 s={s}")

    s1, t1 = min(8, max(counts)), min(512 * 512, pcm.shape[2])
    units = s1 * 2 * (t1 // 512)
    for name, kernel in ROUTES:
        report["at1"][name] = row = measure(
            dev, functools.partial(bench.at1_encode, use_rate_kernel=kernel),
            lambda: torch.from_numpy(np.ascontiguousarray(pcm[:s1, :, :t1]))
            .to(dev), units,
            functools.partial(bench.check_at1, use_rate_kernel=kernel),
            args.repeats, args.iters, "units_per_s", bench.REF_AT1_UNITS_PER_S)
        print(row_line(f"at1 {name}", row, "units_per_s", "units"), flush=True)
    _same_bytes(report["at1"]["xla"], report["at1"]["pallas"], "ATRAC1")
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
