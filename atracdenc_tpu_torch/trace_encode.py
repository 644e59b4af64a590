"""Where the port's encode time goes on one GPU.

    python -m atracdenc_tpu_torch.trace_encode [--out PATH.json]

Encodes the bench corpus (seed 42, 997 Hz tone + noise, 64 streams x 256
stereo frames, default mode: the shape of chip_smoke.py and bench.py) once
to warm up, then
  1. times each encoder stage with the device synchronised around it
     (stage wall times, which add up to the synchronised encode time);
  2. profiles one unsynchronised encode with torch.profiler: wall time,
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

STREAMS, FRAMES = 64, 256


def _corpus(streams, nframes, dev):
    import numpy as np
    t = 1024 * nframes
    rng = np.random.default_rng(42)
    n = np.arange(t, dtype=np.float64)
    base = 0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
    pcm = np.clip(base[None, None, :] * np.asarray([1.0, 0.8])[None, :, None]
                  + 0.05 * rng.standard_normal((streams, 2, t)), -1, 1)
    return torch.from_numpy(pcm.astype(np.float32)).to(dev)


def _stage_times(x, encode):
    """Wrap the encoder's stages with synchronised timers; returns ms per
    stage for one encode."""
    from atracdenc_tpu_torch.models.atrac3 import encoder, gain, tonal
    from atracdenc_tpu_torch.ops import psy, scale

    stages = [(encoder, "band_frames", "qmf bands"),
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
              (encoder, "final_mantissas", "final mantissas (B)")]
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


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(kernels.BUILD_DIR,
                                                 "trace_encode.json"))
    args = p.parse_args(argv)

    from atracdenc_tpu_torch import runtime
    from atracdenc_tpu_torch.models.atrac3.encoder import encode_frames

    dev = runtime.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    x = _corpus(STREAMS, FRAMES, dev)

    def encode(xx):
        return encode_frames(xx, no_gain_control=False, no_tonal=False)

    encode(x)
    torch.cuda.synchronize()
    sync_total, stages = _stage_times(x, encode)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        encode(x)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kern = []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        # device-side kernel events only (a CPU op's self device time is
        # the same kernels counted again)
        if dt > 0 and getattr(ev, "device_type", cuda) == cuda:
            kern.append((ev.key, dt / 1e3, ev.count))
    kern.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in kern)
    n_launch = sum(r[2] for r in kern)
    out = {"card": card, "streams": STREAMS, "frames": FRAMES,
           "stereo_frames": STREAMS * FRAMES,
           "encode_wall_ms": wall, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall if wall > 0 else None,
           "kernel_launches": n_launch,
           "sync_encode_ms": sync_total, "stage_ms": stages,
           "top_kernels": [{"name": k, "ms": v, "count": c}
                           for k, v, c in kern[:25]]}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(out, fp, indent=1)
    print(f"{card} | {out['stereo_frames']} stereo frames: wall {wall:.1f} ms,"
          f" device busy {busy:.1f} ms, idle share "
          f"{out['device_idle_share']:.3f}, {n_launch} kernel launches")
    print(f"synchronised stage times (total {sync_total:.1f} ms):")
    for k, v in sorted(stages.items(), key=lambda kv: -kv[1]):
        print(f"  {k:24s} {v:9.2f} ms")
    print("top kernels by device time:")
    for k, v, c in kern[:15]:
        print(f"  {v:9.3f} ms  x{c:<5d} {k[:90]}")


if __name__ == "__main__":
    main()
