"""Kernel time against wrapper time for kernels A, B, C, D and F on one GPU.

    python -m atracdenc_tpu_torch.profile_kernels [--out PATH.json]

Captures the inputs that kernels A (``quant_cost_plain``, 1 call), B
(``greedy_scan``, 9 calls) and C (``rate_control_block``, 1 call) get
during one ATRAC3 default-mode encode of the bench corpus (64 streams x
256 stereo frames, seed 42), as chip_smoke.py phase 3 does; D
(``quant_cost_full``) gets A's inputs, which are what the encode with
``fused_memo=True`` hands it, and a second time frames whose every kept
value is an eligible candidate at wordlen 7 (``all_candidates``: the
longest rank and recurrence its EA lanes can get); F (``bisect_block``)
runs on C's inputs.
For each wrapper it measures, per run (for B, a run is all 9 calls):
  * the wrapper's time: CUDA events around REPS runs, after a warm-up;
  * a torch.profiler run of the same: the device time of the kernel itself
    (the kernel whose name holds ``quant_cost_plain``, ``quant_cost_full``,
    ``greedy``, ``rate_control`` or ``bisect``) and of every other kernel
    the wrapper launches (layout copies and casts), with their names.
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
    """Device ms per run: the kernel named like `key`, and the rest."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    kernel_ms, other = 0.0, {}
    for name, ms, _ in device_kernels(prof):
        if key in name:
            kernel_ms += ms / REPS
        else:
            other[name] = ms / REPS
    return kernel_ms, other


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(kernels.BUILD_DIR,
                                                 "profile_kernels.json"))
    args = p.parse_args(argv)

    from atracdenc_tpu_torch import runtime
    from atracdenc_tpu_torch.models.atrac3 import bitalloc, encoder
    from atracdenc_tpu_torch.ops import greedy, quant_cost, rate_control

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
    del x
    (a_args, _), = calls["A"]
    b_calls = [a for a, _ in calls["B"]]
    (c_args, c_kw), = calls["C"]
    # x * 31.5 = k + 0.3: rounds down, |delta| 0.2, the pass moves up
    gen = torch.Generator(device=dev).manual_seed(0)
    k = torch.randint(0, 30, a_args[0].shape, generator=gen, device=dev)
    all_cand = ((k + 0.3) / 31.5 * a_args[1]).to(torch.float32)
    del k
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
    }
    out = {"card": card, "reps": REPS, "groups": {}}
    for name, (fn, key, shapes) in groups.items():
        wrapper_ms = cuda_ms(fn, REPS)
        kernel_ms, other = _split(fn, key)
        out["groups"][name] = {
            "shapes": shapes, "wrapper_ms": wrapper_ms, "kernel_ms": kernel_ms,
            "other_ms": sum(other.values()),
            "other_kernels": dict(sorted(other.items(), key=lambda kv: -kv[1]))}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(out, fp, indent=1)
    print(card)
    for name, r in out["groups"].items():
        print(f"{name} {r['shapes']}: wrapper {r['wrapper_ms']:.4f} ms (CUDA "
              f"events); profiler: kernel {r['kernel_ms']:.4f} ms, other "
              f"kernels {r['other_ms']:.4f} ms")
        for k, v in list(r["other_kernels"].items())[:6]:
            print(f"    {v:9.4f} ms  {k[:100]}")


if __name__ == "__main__":
    main()
