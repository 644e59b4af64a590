"""Kernel time against wrapper time for kernels A to F on one GPU.

    python -m atracdenc_tpu_torch.profile_kernels [--out PATH.json]

Captures the inputs that kernels A (``quant_cost_plain``, 1 call), B
(``greedy_scan``, 9 calls) and C (``rate_control_block``, 1 call) get
during one ATRAC3 default-mode encode of the bench corpus (64 streams x
256 stereo frames, seed 42), as chip_smoke.py phase 3 does; D
(``quant_cost_full``) gets A's inputs, which are what the encode with
``fused_memo=True`` hands it, and a second time frames whose every kept
value is an eligible candidate at wordlen 7 (``all_candidates``: the
longest rank and recurrence its EA lanes can get); F (``bisect_block``)
runs on C's inputs; E (``at1_allocate_block``) gets the inputs that one
ATRAC1 encode of the bench leg's corpus (its first 8 streams, 2 x 512
frames: 8,192 channel-frames) hands it, as chip_smoke.py phase 3 does.
The last group, a one-element ``add_``, is the launch floor.
For each wrapper it measures, per run (for B, a run is all 9 calls):
  * the wrapper's time: CUDA events around REPS runs, after a warm-up;
  * a torch.profiler run of the same: the device time of the kernel itself
    (the kernel whose name holds ``quant_cost_plain``, ``quant_cost_full``,
    ``greedy``, ``rate_control``, ``bisect`` or ``at1_allocate``) and of
    every other kernel the wrapper launches (layout copies and casts), with
    their names.
Then E's device time a call on the first 8,192 / 4,096 / 132 / 1 of its
rows, in auto mode and at one bisection a row (``bfu_idx_const`` 8), with
the launches queued behind a sleeping kernel so that the host's launch
cost is off the clock: one row gives the length of a row's chain, many
rows add the instructions of their evaluations.
Writes JSON to --out and prints a summary.  Needs CUDA.
"""
import argparse
import json
import os
import subprocess

import torch

from atracdenc_tpu_torch import kernels
from atracdenc_tpu_torch.trace_encode import (FRAMES, STREAMS, _corpus,
                                              capture, cuda_ms, device_kernels)

REPS = 10


def _split(fn, key):
    """Per run: device ms and launches of the kernel named like `key`, and
    {name: (ms, launches)} of every other kernel (launches of one name are
    summed)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    kernel_ms, kernel_n, other = 0.0, 0.0, {}
    for name, ms, count in device_kernels(prof):
        if key in name:
            kernel_ms += ms / REPS
            kernel_n += count / REPS
        else:
            other[name] = (ms / REPS, count / REPS)
    return kernel_ms, kernel_n, other


def _queued_ms(fn, reps=50):
    """Device ms a call of fn, its launches queued behind a sleeping kernel
    (~25 ms, longer than the host takes to launch them)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(kernels.BUILD_DIR,
                                                 "profile_kernels.json"))
    args = p.parse_args(argv)

    from atracdenc_tpu_torch import runtime
    from atracdenc_tpu_torch.models.atrac1 import encoder as at1_encoder
    from atracdenc_tpu_torch.models.atrac3 import bitalloc, encoder
    from atracdenc_tpu_torch.ops import at1_alloc, greedy, quant_cost, rate_control

    dev = runtime.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    x = _corpus(STREAMS, FRAMES, dev)
    calls = capture([(bitalloc, "quant_cost_plain", "A"),
                     (bitalloc, "greedy_scan", "B"),
                     (bitalloc, "rate_control_block", "C")],
                    lambda: encoder.encode_frames(x, no_gain_control=False,
                                                  no_tonal=False))
    calls.update(capture([(at1_encoder, "at1_allocate_block", "E")],
                         lambda: at1_encoder.encode_frames(x[:8])))
    del x
    (a_args, _), = calls["A"]
    b_calls = [a for a, _ in calls["B"]]
    (c_args, c_kw), = calls["C"]
    (e_args, e_kw), = calls["E"]
    # x * 31.5 = k + 0.3: rounds down, |delta| 0.2, the pass moves up
    gen = torch.Generator(device=dev).manual_seed(0)
    k = torch.randint(0, 30, a_args[0].shape, generator=gen, device=dev)
    all_cand = ((k + 0.3) / 31.5 * a_args[1]).to(torch.float32)
    del k
    one = torch.zeros(1, device=dev)
    groups = {
        "A quant_cost_plain": (lambda: quant_cost.quant_cost_plain(*a_args),
                               "quant_cost_plain", [tuple(a_args[0].shape)]),
        "D quant_cost_full": (lambda: quant_cost.quant_cost_full(*a_args),
                              "quant_cost_full", [tuple(a_args[0].shape)]),
        "D quant_cost_full, all_candidates": (
            lambda: quant_cost.quant_cost_full(all_cand, a_args[1]),
            "quant_cost_full", [tuple(all_cand.shape)]),
        "B greedy_scan": (lambda: [greedy.greedy_scan(*a) for a in b_calls],
                          "greedy", [tuple(a[0].shape) for a in b_calls]),
        "C rate_control_block": (
            lambda: rate_control.rate_control_block(*c_args, **c_kw),
            "rate_control", [tuple(c_args[0].shape)]),
        "F bisect_block": (lambda: rate_control.bisect_block(*c_args),
                           "bisect", [tuple(c_args[0].shape)]),
        "E at1_allocate_block": (
            lambda: at1_alloc.at1_allocate_block(*e_args, **e_kw),
            "at1_allocate", [tuple(e_args[0].shape)]),
        # the floor no wrapper goes under: one launch of the smallest kernel
        "launch floor (one-element add_)": (lambda: one.add_(1.0), "add",
                                            [(1,)]),
    }
    out = {"card": card, "reps": REPS, "groups": {}}
    for name, (fn, key, shapes) in groups.items():
        wrapper_ms = cuda_ms(fn, REPS)
        kernel_ms, kernel_n, other = _split(fn, key)
        out["groups"][name] = {
            "shapes": shapes, "wrapper_ms": wrapper_ms, "kernel_ms": kernel_ms,
            "kernel_launches": kernel_n,
            "other_ms": sum(ms for ms, _ in other.values()),
            "other_launches": sum(n for _, n in other.values()),
            "other_kernels": {k: {"ms": ms, "launches": n} for k, (ms, n) in
                              sorted(other.items(), key=lambda kv: -kv[1][0])}}
    flat = [a.reshape((-1,) + a.shape[3:]) for a in e_args]
    by_rows = {"one-element add_": _queued_ms(lambda: one.add_(1.0))}
    for n in (8192, 4096, 132, 1):
        part = [a[:n].contiguous() for a in flat]
        for const in (0, 8):
            by_rows[f"{n} rows, bfu_idx_const {const}"] = min(
                _queued_ms(lambda: at1_alloc.at1_allocate_block(
                    *part, bfu_idx_const=const)) for _ in range(3))
    out["E_device_ms_by_rows"] = by_rows
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(out, fp, indent=1)
    print(card)
    for name, r in out["groups"].items():
        print(f"{name} {r['shapes']}: wrapper {r['wrapper_ms']:.4f} ms (CUDA "
              f"events); profiler: kernel {r['kernel_ms']:.4f} ms in "
              f"{r['kernel_launches']:g} launches, other kernels "
              f"{r['other_ms']:.4f} ms in {r['other_launches']:g}")
        for k, v in list(r["other_kernels"].items())[:6]:
            print(f"    {v['ms']:9.4f} ms {v['launches']:g}x  {k[:100]}")
    print("device ms a call, launches queued behind a sleeping kernel:")
    for k, ms in by_rows.items():
        print(f"    {ms:9.4f} ms  {k}")


if __name__ == "__main__":
    main()
