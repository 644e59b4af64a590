"""Where the port's encode time goes on one GPU.

    python -m atracdenc_tpu_torch.trace_encode [--out PATH.json]

Traces two paths on the bench corpus (seed 42, 997 Hz tone + noise):
  * ATRAC3, the main path: 64 streams x 256 stereo frames, default mode,
    encode + device packer (``encode_frames_bytes``), the shape of
    chip_smoke.py and bench.py's AT3 leg;
  * ATRAC1, bench.py's AT1 leg: 8 streams x 2 ch x 512 frames, encode +
    device packer.
Each is run once to warm up, then
  1. each stage is timed with the device synchronised around it (stage
     wall times, which add up to the synchronised time);
  2. one unsynchronised run is profiled with torch.profiler: wall time,
     summed kernel time (device busy), the device's idle share, and the
     kernels with the most device time.
Writes the numbers as JSON to --out and prints a summary.  Needs CUDA.
"""
import argparse
import json
import os
import subprocess
import time

import torch

from atracdenc_tpu_torch import kernels
from atracdenc_tpu_torch.bench import (AT1_FRAMES, AT1_STREAMS, SHAPES,
                                       at1_units, corpus, device_seconds)

STREAMS, FRAMES = SHAPES["cuda"]


def _corpus(streams, nframes, dev):
    return torch.from_numpy(corpus(streams, nframes)).to(dev)


def cuda_ms(fn, reps, warmup=1):
    """Mean ms of fn() over reps runs, by CUDA events, after warmup runs."""
    for _ in range(warmup):
        fn()
    return 1e3 * device_seconds(torch.device("cuda"),
                                lambda: [fn() for _ in range(reps)]) / reps


def capture(sites, fn, outputs=False):
    """Run fn() with each (module, name, key) call site wrapped to record
    its arguments; returns {key: [(args, kwargs), ...]}, or with
    ``outputs`` {key: [(args, kwargs, result), ...]}.  A call made while
    another site's call runs (a stage inside a stage) is not recorded."""
    calls = {key: [] for _, _, key in sites}
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    depth = [0]
    for (mod, name, key), (_, _, orig) in zip(sites, originals):
        def wrapped(*a, _orig=orig, _key=key, **kw):
            if depth[0]:
                return _orig(*a, **kw)
            depth[0] += 1
            try:
                out = _orig(*a, **kw)
            finally:
                depth[0] -= 1
            calls[_key].append((a, kw, out) if outputs else (a, kw))
            return out
        setattr(mod, name, wrapped)
    try:
        fn()
    finally:
        for mod, name, orig in originals:
            setattr(mod, name, orig)
    assert all(calls.values()), {k: len(v) for k, v in calls.items()}
    return calls


def device_kernels(prof):
    """[(kernel name, device ms, launches)] of a torch.profiler run: the
    device-side kernel events only (a CPU op's self device time is the same
    kernels counted again)."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if dt > 0 and getattr(ev, "device_type", cuda) == cuda:
            out.append((ev.key, dt / 1e3, ev.count))
    return out


def _stage_times(x, encode, stages):
    """Wrap the stages (module, name, label) with synchronised timers;
    returns ms per stage for one run."""
    ms = {}
    saved = []
    depth = [0]                  # a stage called inside another is not split out
    for mod, name, label in stages:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def timed(*a, _fn=fn, _label=label, **kw):
            if depth[0]:
                return _fn(*a, **kw)
            depth[0] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = _fn(*a, **kw)
                torch.cuda.synchronize()
            finally:
                depth[0] -= 1
            ms[_label] = ms.get(_label, 0.0) + 1e3 * (time.perf_counter() - t0)
            return out
        setattr(mod, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encode(x)
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - t0)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    ms["other (glue)"] = total - sum(ms.values())
    return total, ms


def _trace(x, encode, stages, items):
    """Warm-up, synchronised stage times, then one profiled run."""
    encode(x)
    torch.cuda.synchronize()
    sync_total, stage_ms = _stage_times(x, encode, stages)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        encode(x)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kern = sorted(device_kernels(prof), key=lambda r: -r[1])
    busy = sum(r[1] for r in kern)
    return {"items": items, "wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if wall > 0 else None,
            "kernel_launches": sum(r[2] for r in kern),
            "sync_ms": sync_total, "stage_ms": stage_ms,
            "top_kernels": [{"name": k, "ms": v, "count": c}
                            for k, v, c in kern[:25]]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(kernels.BUILD_DIR,
                                                 "trace_encode.json"))
    args = p.parse_args(argv)

    from atracdenc_tpu_torch import runtime
    from atracdenc_tpu_torch.models.atrac1 import device_pack as pack1
    from atracdenc_tpu_torch.models.atrac1 import encoder as enc1
    from atracdenc_tpu_torch.models.atrac1 import filterbank as fb1
    from atracdenc_tpu_torch.models.atrac3 import device_pack as pack3
    from atracdenc_tpu_torch.models.atrac3 import encoder, gain, tonal
    from atracdenc_tpu_torch.ops import psy, scale

    dev = runtime.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]

    at3_stages = [(encoder, "band_frames", "qmf bands"),
                  (gain, "gain_control", "gain control"),
                  (gain, "energy_scale", "gain energy scale"),
                  (encoder, "mdct_frames", "mdct"),
                  (psy, "track_loudness_scan", "loudness IIR"),
                  (tonal, "flatness_per_bfu", "tonal flatness"),
                  (tonal, "extract", "tonal extract"),
                  (tonal, "scale_groups", "tonal scale"),
                  (scale, "scale_blocks", "scale"),
                  (encoder, "quant_tensors", "quant memo (A, B)"),
                  (encoder, "allocate", "rate control (C)"),
                  (encoder, "final_mantissas", "final mantissas (B)"),
                  (pack3, "channel_fields", "pack fields"),
                  (pack3, "deposit_fields", "bit deposit")]
    at1_stages = [(fb1, "analysis", "qmf bands"),
                  (enc1, "transient_mask", "transient detect"),
                  (enc1, "mdct_frames", "mdct"),
                  (psy, "track_loudness_scan", "loudness IIR"),
                  (enc1, "gather_bfu_blocks", "bfu blocks"),
                  (scale, "scale_blocks", "scale"),
                  (enc1, "at1_allocate_block", "rate control (E)"),
                  (scale, "quant_mantissas", "mantissas"),
                  (pack1, "pack_device", "device pack")]

    def at1_path(xx):
        return pack1.pack_device(at1_units(enc1.encode_frames(xx)))

    x3 = _corpus(STREAMS, FRAMES, dev)
    out = {"card": card, "atrac3": _trace(
        x3, lambda xx: encoder.encode_frames_bytes(
            xx, no_gain_control=False, no_tonal=False),
        at3_stages, {"stereo_frames": STREAMS * FRAMES})}
    x1 = x3[:AT1_STREAMS].contiguous()     # 256 x 1024 = 512 x 512 samples
    del x3
    out["atrac1"] = _trace(x1, at1_path, at1_stages,
                           {"sound_units": AT1_STREAMS * 2 * AT1_FRAMES})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(out, fp, indent=1)
    for path in ("atrac3", "atrac1"):
        r = out[path]
        print(f"{card} | {path} {r['items']}: wall {r['wall_ms']:.1f} ms, "
              f"device busy {r['device_busy_ms']:.1f} ms, idle share "
              f"{r['device_idle_share']:.3f}, {r['kernel_launches']} kernel "
              f"launches")
        print(f"synchronised stage times (total {r['sync_ms']:.1f} ms):")
        for k, v in sorted(r["stage_ms"].items(), key=lambda kv: -kv[1]):
            print(f"  {k:24s} {v:9.2f} ms")
        print("top kernels by device time:")
        for k in r["top_kernels"][:15]:
            print(f"  {k['ms']:9.3f} ms  x{k['count']:<5d} {k['name'][:90]}")


if __name__ == "__main__":
    main()
