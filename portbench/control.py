"""The control of ``correct``: the program with its TF32 path switched on
(``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32``, the
precision below the configurations' float32 with TF32 off), through the
rest of a run at the cell's own size.

    python3 -m portbench.control --workload atrac3-lp2.batch \\
        --seeds 11,12,13 --seconds 10

Prints one JSON line per seed with every number the comparison computes,
the numbers held to limits and whether the run came out correct (it has to
come out not correct).  The benchmark's own runs never run it.
"""
import argparse
import contextlib
import json
import sys
import tempfile
import time


@contextlib.contextmanager
def tf32():
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def alter(ctx):
    """TF32 on from set-up to the window's close (see the module)."""
    return tf32()


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    args = p.parse_args(argv)
    import torch

    from portbench import manifest, run
    cell = manifest.cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="portbench-") as wd:
            r = run.run_cell(cell, seed, args.seconds, 0, dev, t0, wd,
                             alter=alter)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "tf32", "correct": r["correct"],
                          "attempted": r["attempted"],
                          "numbers": r["numbers"], "checks": r["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
