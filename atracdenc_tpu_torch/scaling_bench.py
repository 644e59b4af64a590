"""Scaling harness: ATRAC3 encode throughput at 1, 2 and 4 rank processes.

    python -m atracdenc_tpu_torch.scaling_bench [--dp K] [--device cpu]

The counterpart of ``tools/scaling_bench.py`` (the JAX package over
``jax.distributed``).  The JAX tool's configurations are "1 device",
"1 proc x 8 dev" and "2 proc x 4 dev"; here one rank owns one device, so
they become 1, 2 and 4 rank processes, started by
``parallel/distributed.launch`` (fresh interpreters, a free localhost port,
gloo).  Each rank runs ``initialize``, ``global_mesh(dp)``,
``local_batch_slice`` and ``encode_batch_global`` (ATRAC3 default mode,
LP2 384 B, device packer) on the global batch ``make_pcm`` (seed 11, a
997 Hz tone plus noise) of ``SHAPES[device]`` streams x stereo frames: the
JAX tool's 8 x 8 on the CPU, the port bench's 64 x 256 on a card.  ``--dp
K`` gives each configuration min(K, ranks) dp rows and the rest as sp
columns (the default: all dp).

Timing: each rank warms once, then times 3 calls; on CUDA it synchronises
before the clock stops.  A configuration's time is its slowest rank's mean
call, so process start-up (7-9 s a process on the card's host) and the
build are outside it.  frames/s counts stereo frames of the global batch.

Byte check: each configuration's dp rows, concatenated, must equal the 1-rank
bytes.  On the CPU they must be byte-equal.  On a card the dp shards change
the batch of every GEMM, so cuBLAS may sum in another order (the ATRAC1
knife edge's class): there the identity must be >= 0.999, and the frames
that differ are printed.

Output: one line per configuration, the JAX tool's table (configuration,
ranks, frames/s, throughput kept), ``torch.cuda.device_count()`` and, when
ranks outnumber cards, a line saying that the ranks time-slice one card (the
numbers then measure sharing, not scaling), and last one JSON line of the
rows.  Without a card and without ``--device cpu`` it exits non-zero with
``runtime.device``'s message.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from atracdenc_tpu_torch import kernels, runtime
from atracdenc_tpu_torch.parallel import distributed as D

SHAPES = {"cuda": (64, 256), "cpu": (8, 8)}     # (streams, stereo frames)
RANKS = (1, 2, 4)
ITERS = 3
MIN_IDENTITY = 0.999                           # on a card; the CPU: equal


def make_pcm(streams, frames):
    """tools/scaling_bench.py's batch: [streams, 2, 1024 * frames] f32, a
    997 Hz tone at 0.4 plus 0.05 Gaussian noise from seed 11, clipped."""
    t = 1024 * frames
    rng = np.random.default_rng(11)
    n = np.arange(t, dtype=np.float64)
    base = 0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
    return np.clip(
        base[None, None, :] + 0.05 * rng.standard_normal((streams, 2, t)),
        -1, 1).astype(np.float32)


def rank_dp(ranks, dp):
    """dp rows of a configuration of ``ranks`` ranks under ``--dp``."""
    k = ranks if dp is None else min(dp, ranks)
    if ranks % k:
        raise ValueError(f"--dp {dp}: {k} dp rows do not divide {ranks} ranks")
    return k


def worker(rank, ranks, coordinator, device, dp, out_dir):
    """One rank: encode its dp row of the global batch, warm once, time
    ITERS calls; rank 0 writes every rank's seconds a call, and each sp
    column 0 its row's bytes, under ``out_dir``."""
    dev = D.initialize(coordinator, ranks, rank, device=device)
    mesh = D.global_mesh(dp=rank_dp(ranks, dp), device=dev)
    streams, frames = SHAPES[dev.type]
    start, count = D.local_batch_slice(streams, mesh)
    local = make_pcm(streams, frames)[start:start + count]

    out = D.encode_batch_global(local, mesh)                  # warm
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if dist.is_initialized():
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = D.encode_batch_global(local, mesh)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = (time.perf_counter() - t0) / ITERS
    if mesh.col == 0:
        np.save(os.path.join(out_dir, f"row{mesh.row}.npy"), out)
    every = [dt]
    if dist.is_initialized():
        every = [None] * ranks
        dist.all_gather_object(every, dt)
    if rank == 0:
        with open(os.path.join(out_dir, "times.json"), "w") as fp:
            json.dump({"seconds": every, "dp": mesh.dp, "sp": mesh.sp,
                       "device": str(dev)}, fp)
    D.finalize()
    return 0


def run_config(ranks, device, dp, out_dir):
    """Launch ``ranks`` rank processes; -> (seconds a call of the slowest
    rank, the mesh's (dp, sp), the dp rows' bytes concatenated)."""
    os.makedirs(out_dir, exist_ok=True)
    D.launch(lambda r, coord: [
        sys.executable, "-m", "atracdenc_tpu_torch.scaling_bench",
        "--rank", str(r), "--ranks", str(ranks), "--coordinator", coord,
        "--out-dir", out_dir, "--device", device]
        + ([] if dp is None else ["--dp", str(dp)]), ranks, timeout=600)
    with open(os.path.join(out_dir, "times.json")) as fp:
        info = json.load(fp)
    rows = np.concatenate([np.load(os.path.join(out_dir, f"row{i}.npy"))
                           for i in range(info["dp"])])
    return max(info["seconds"]), (info["dp"], info["sp"]), rows


def differing_frames(a, b, limit=20):
    """(stream, frame) pairs whose bytes differ, at most ``limit``."""
    return [tuple(ix) for ix in
            np.argwhere((a != b).any(axis=-1)).tolist()[:limit]]


def run(device=None, dp=None):
    """Every configuration of RANKS on ``device``; asserts the byte checks
    and returns the rows [{"config", "ranks", "dp", "sp", "frames_per_s",
    "kept", "identity", "differing"}]."""
    dev = runtime.device(device)
    if dev.type == "cuda":
        kernels.build()              # once here, not by every rank's nvcc
    streams, frames = SHAPES[dev.type]
    n_frames = streams * frames
    rows, base, ref = [], None, None
    with tempfile.TemporaryDirectory() as tmp:
        for ranks in RANKS:
            sec, (n_dp, n_sp), got = run_config(
                ranks, dev.type, dp, os.path.join(tmp, f"r{ranks}"))
            assert got.shape == (streams, frames, 384), got.shape
            if ref is None:
                ref = got
            ident = float(np.mean(got == ref))
            diff = differing_frames(got, ref)
            fps = n_frames / sec
            base = base or fps
            label = "1 rank" if ranks == 1 else f"{ranks} ranks"
            rows.append({"config": f"{label} ({n_dp} dp x {n_sp} sp)",
                         "ranks": ranks, "dp": n_dp, "sp": n_sp,
                         "frames_per_s": fps, "kept": fps / base,
                         "identity": ident, "differing": diff})
            print(f"{rows[-1]['config']:22s} {fps:12.1f} stereo frames/s  "
                  f"byte identity with 1 rank {ident!r}, (stream, frame) "
                  f"that differ {diff}", flush=True)
            if dev.type == "cpu":
                assert np.array_equal(got, ref), \
                    f"{ranks} ranks: bytes differ from 1 rank at {diff}"
            else:
                assert ident >= MIN_IDENTITY, \
                    f"{ranks} ranks: byte identity {ident} < {MIN_IDENTITY}"
    cards = torch.cuda.device_count()
    print(f"\n{streams} x {frames} stereo frames, ATRAC3 default mode, "
          f"device {dev.type}; torch.cuda.device_count() = {cards}")
    if dev.type == "cuda" and max(RANKS) > cards:
        print(f"ranks outnumber cards ({max(RANKS)} > {cards}): the ranks "
              f"time-slice {'one card' if cards == 1 else f'{cards} cards'}, "
              f"so these numbers measure sharing, not scaling")
    print(f"{'config':22s} {'ranks':>5s} {'frames/s':>12s}   throughput kept")
    for r in rows:
        print(f"{r['config']:22s} {r['ranks']:5d} {r['frames_per_s']:12.1f}   "
              f"{100 * r['kept']:6.1f}%")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m atracdenc_tpu_torch.scaling_bench",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--dp", type=int, default=None,
                   help="dp rows of each configuration, at most its ranks "
                        "(default: all dp)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (default; no fallback) or cpu (plain versions)")
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--ranks", type=int, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", help=argparse.SUPPRESS)
    p.add_argument("--out-dir", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.dp is not None and args.dp < 1:
        p.error("--dp must be >= 1")
    if args.rank is not None:
        return worker(args.rank, args.ranks, args.coordinator,
                      args.device or "cuda", args.dp, args.out_dir)
    rows = run(args.device, args.dp)
    print(json.dumps({"rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
