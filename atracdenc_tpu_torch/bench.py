"""The port's benchmark: encode throughput of the three codecs on one GPU.

    python -m atracdenc_tpu_torch.bench [--repeats 5] [--seed 42] [--device cpu]

The counterpart of the repo root's ``bench.py`` (the JAX package on a TPU).
It prints one JSON line, last, with bench.py's keys: ``metric``, ``value``,
``unit``, ``vs_baseline`` and bench.py's 12 ``extra`` keys, plus the card's
``device_name`` and ``power_limit_w`` (nvidia-smi), ``repeats``, ``shapes``
(streams and stereo frames or sound units of each leg), a ``spread`` of
[min, max] over the repeats for every rate, the ``sha256`` of each leg's
bytes, and ``at3_fps_fused_memo``, a diagnostic that never becomes
``value``.

Corpus (bench.py:153-165): ``corpus`` — seed 42, a 997 Hz tone at 0.4
(channel 1 at 0.8) plus 0.05 Gaussian noise, clipped, f32, [64, 2, 256 x
1024] on a card and bench.py's CPU shape [4, 2, 32 x 1024] with ``--device
cpu``.  The legs:

* ATRAC3, default mode (gain control and tonal components, LP2 384 B):
  ``models/atrac3/encoder.py::encode_frames_bytes`` (encode + device packer)
  on the whole batch, with kernel C (``at3_fps_pallas_rate_ctl``) and with
  the tensor-op rate path (``at3_fps_xla_rate_ctl``, the JAX XLA path's
  counterpart); ``value`` is the larger.  Before any window both routes'
  bytes are asserted equal, and stream 0's equal to ``frame.pack`` of the
  same planes.  ``at3_fps_compute_only`` is the kernel route with its
  output left on the device.  ``at3_fps_fused_memo`` is the kernel route
  with ``fused_memo=True`` (kernel D), whose bytes must be the default's to
  0.999 (chip_smoke.py phase 9's gate).
* ``d2h_link_mbps``: three copies of a fresh 8 MiB device buffer each into
  pinned host memory (MiB/s, as bench.py counts it): the PCIe link.
* ATRAC1 (bench.py:68-91,220-229): the corpus cut to 8 streams x 512 x 512
  samples, ``models/atrac1/encoder.py::encode_frames``, the planes merged
  per stream (``device_pack.merge_channels``) and
  ``device_pack.pack_device``; stream 0's units are asserted equal to
  ``frame.pack``'s.  bench.py takes the better
  of two routes (XLA and Pallas) here; the port has one on the card, kernel
  E, whose plain version is a test reference that never runs on a card.
* ATRAC3+ (bench.py:94-110,230-236): the corpus cut to 8 streams x 128 x
  2048 samples, ``models/atrac3p/encoder.py::encode_frames_bytes(x, 2,
  gha_mask=7)`` on [8, 2, T]; the stream axis replaces JAX's ``vmap``.

Timing.  A pipelined rate (``at3_fps_*_rate_ctl``, ``at3_fps_fused_memo``,
``atrac1_units_per_s``, ``at3p_gha_frames_per_s``) is 6 calls on the host
clock with up to 2 in flight, as bench.py's ``_pipeline_rate`` (bench.py:
35-65): each call's bytes are copied on a side stream into a pinned host
buffer with ``non_blocking=True``, the host waits on a buffer's copy before
it reuses the buffer, and every byte is on the host before the clock stops.
A compute-only rate (``*_compute_only``) is 4 back-to-back calls between two
CUDA events, the card's counterpart of bench.py's RTT-corrected drain.
Every rate is the median of ``--repeats`` windows; the windows of all the
legs take turns within a repeat, and the calls that validate the bytes
(which build the kernels and fill the allocator) run before every window.

There is no fallback.  Without a card the module exits non-zero with
``runtime.device``'s message and prints no line, unless ``--device cpu``
asks for the CPU: that runs the same code on the kernels' plain versions,
reports ``"platform": "cpu"``, and is a liveness check, not a measurement.
A failure in any leg fails the run.
"""
import argparse
import functools
import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.models.atrac1 import device_pack as at1_pack
from atracdenc_tpu_torch.models.atrac1 import encoder as at1_encoder
from atracdenc_tpu_torch.models.atrac1 import frame as at1_frame
from atracdenc_tpu_torch.models.atrac3 import device_pack as at3_pack
from atracdenc_tpu_torch.models.atrac3 import encoder as at3_encoder
from atracdenc_tpu_torch.models.atrac3 import frame as at3_frame
from atracdenc_tpu_torch.models.atrac3p import encoder as at3p_encoder

# bench.py:24-27: the reference C++ encoders on one core of the JAX round's
# host (BASELINE.md), not of the GPU's host
REF_FRAMES_PER_S = 1046.0        # reference at3enc, default mode
REF_AT1_UNITS_PER_S = 11670.0    # reference at1enc
REF_AT3P_FRAMES_PER_S = 930.0    # at3p_oracle (GHA-off flow)

SHAPES = {"cuda": (64, 256), "cpu": (4, 32)}    # (streams, stereo frames)
AT1_STREAMS, AT1_FRAMES = 8, 512                # bench.py:220
AT3P_STREAMS, AT3P_FRAMES = 8, 128              # bench.py:230
AT3_DEFAULT = dict(frame_bytes=384, js=False, no_gain_control=False,
                   no_tonal=False)
PIPELINE_CALLS, PIPELINE_DEPTH, COMPUTE_CALLS = 6, 2, 4


def corpus(streams, nframes, seed=42):
    """bench.py's corpus: [streams, 2, 1024 * nframes] f32, a 997 Hz tone at
    0.4 (channel 1 at 0.8) + 0.05 Gaussian noise from ``seed``, clipped."""
    t = 1024 * nframes
    rng = np.random.default_rng(seed)
    n = np.arange(t, dtype=np.float64)
    base = 0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
    return np.clip(base[None, None, :] * np.asarray([1.0, 0.8])[None, :, None]
                   + 0.05 * rng.standard_normal((streams, 2, t)),
                   -1, 1).astype(np.float32)


def device_seconds(dev, fn):
    """Seconds from before fn() to the end of the device work it queued:
    CUDA events around it on a card (the device synchronised before and
    after), the host clock on the CPU."""
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(dev)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def pipelined(dev, fn, x, n_items, expect, calls=PIPELINE_CALLS):
    """A window of ``calls`` calls of fn(x) with up to PIPELINE_DEPTH in
    flight -> items/s on the host clock, every byte on the host inside it
    (bench.py:35-65).  ``expect``: fn(x)'s bytes on the host, which the
    last call's copy must equal."""
    cuda = dev.type == "cuda"
    bufs = [torch.empty(expect.shape, dtype=expect.dtype, pin_memory=cuda)
            for _ in range(PIPELINE_DEPTH)]
    side = torch.cuda.Stream(dev) if cuda else None

    def window():
        copied = [None] * PIPELINE_DEPTH
        if cuda:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for i in range(calls):
            y = fn(x)
            slot = i % PIPELINE_DEPTH
            if copied[slot] is not None:
                copied[slot].synchronize()          # its bytes are on the host
            if cuda:
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    bufs[slot].copy_(y, non_blocking=True)
                y.record_stream(side)
                copied[slot] = torch.cuda.Event()
                copied[slot].record(side)
            else:
                bufs[slot].copy_(y)
        for ev in copied:
            if ev is not None:
                ev.synchronize()
        dt = time.perf_counter() - t0
        assert torch.equal(bufs[(calls - 1) % PIPELINE_DEPTH],
                           expect), "pipelined bytes differ from the checked ones"
        return n_items * calls / dt
    return window


def compute_only(dev, fn, x, n_items):
    """A window of COMPUTE_CALLS back-to-back calls, output left on the
    device -> items/s by CUDA events (the host clock on the CPU)."""
    def window():
        return n_items * COMPUTE_CALLS / device_seconds(
            dev, lambda: [fn(x) for _ in range(COMPUTE_CALLS)])
    return window


def d2h_link(dev, mib=8, copies=3):
    """A window of ``copies`` copies of a fresh ``mib`` MiB device buffer
    each into pinned host memory -> MiB/s."""
    cuda = dev.type == "cuda"
    dst = torch.empty(mib << 20, dtype=torch.uint8, pin_memory=cuda)

    def window():
        srcs = [torch.full((mib << 20,), i, dtype=torch.uint8, device=dev)
                for i in range(copies)]
        return mib * copies / device_seconds(
            dev, lambda: [dst.copy_(s, non_blocking=True) for s in srcs])
    window()                                       # pins and maps the buffer
    return window


def sha256(t):
    return hashlib.sha256(runtime.to_numpy(t).tobytes()).hexdigest()


def at3_encode(x, use_rate_kernel=True, fused_memo=False):
    """The ATRAC3 leg's call: x [S, 2, T] -> [S, F, 384] bytes, encode and
    device packer in the default mode, on the route the options name."""
    return at3_encoder.encode_frames_bytes(
        x, use_rate_kernel=use_rate_kernel, fused_memo=fused_memo,
        **AT3_DEFAULT)


def check_at3(x, frames, **route):
    """Assert that ``frames`` (``at3_encode(x, **route)``) are the device
    packer's bytes of the route's planes, and that stream 0's equal
    ``frame.pack``'s."""
    planes = at3_encoder.encode_frames(x, **route, **AT3_DEFAULT)
    assert torch.equal(at3_pack.pack_device_batch(planes, 384), frames)
    host0 = at3_frame.pack({k: runtime.to_numpy(v[0])
                            for k, v in planes.items()}, 384)
    assert np.array_equal(host0, runtime.to_numpy(frames[0])), \
        "ATRAC3: stream 0's device bytes differ from frame.pack"


def at3_leg(dev, x):
    """The ATRAC3 windows, after checking the bytes of both routes."""
    n = x.shape[0] * x.shape[2] // 1024
    kernel = at3_encode
    tensor_ops = functools.partial(at3_encode, use_rate_kernel=False)
    fused = functools.partial(at3_encode, fused_memo=True)
    frames = kernel(x)
    assert torch.equal(tensor_ops(x), frames), \
        "ATRAC3: kernel C and the tensor-op rate path give other bytes"
    check_at3(x, frames)
    fused_frames = fused(x)
    ident = float((fused_frames == frames).double().mean())
    assert ident >= 0.999, f"ATRAC3 fused memo: byte identity {ident}"
    expect = frames.cpu()
    windows = {"at3_fps_pallas_rate_ctl": pipelined(dev, kernel, x, n, expect),
               "at3_fps_xla_rate_ctl": pipelined(dev, tensor_ops, x, n, expect),
               "at3_fps_compute_only": compute_only(dev, kernel, x, n),
               "at3_fps_fused_memo": pipelined(dev, fused, x, n,
                                               fused_frames.cpu())}
    return windows, sha256(frames), [x.shape[0], x.shape[2] // 1024]


def at1_encode(x1, use_rate_kernel=True):
    """The ATRAC1 leg's call: x1 [S, 2, T] -> [S * F * 2, 212] sound units,
    encode and device packer, kernel E (or ``bitalloc.allocate`` with
    ``use_rate_kernel=False``) in the rate control."""
    return at1_pack.pack_device(at1_pack.merge_channels(
        at1_encoder.encode_frames(x1, use_rate_kernel=use_rate_kernel)))


def check_at1(x1, units, **route):
    """Assert that ``units`` (``at1_encode(x1, **route)``) are the device
    packer's bytes of the route's planes, and that stream 0's equal
    ``frame.pack``'s."""
    n = x1.shape[0] * 2 * (x1.shape[2] // 512)
    assert units.shape == (n, 212), units.shape
    planes = at1_pack.merge_channels(at1_encoder.encode_frames(x1, **route))
    assert torch.equal(at1_pack.pack_device(planes), units)
    per_stream = n // x1.shape[0]
    host0 = at1_frame.pack({k: runtime.to_numpy(v[:per_stream])
                            for k, v in planes.items()})
    assert np.array_equal(host0, runtime.to_numpy(units[:per_stream])), \
        "ATRAC1: stream 0's device bytes differ from frame.pack"


def at1_leg(dev, x1):
    """The ATRAC1 windows, after checking stream 0 against frame.pack."""
    n = x1.shape[0] * 2 * (x1.shape[2] // 512)
    units = at1_encode(x1)
    check_at1(x1, units)
    windows = {"atrac1_units_per_s": pipelined(dev, at1_encode, x1, n,
                                               units.cpu()),
               "at1_units_per_s_compute_only": compute_only(dev, at1_encode,
                                                            x1, n)}
    return windows, sha256(units), [x1.shape[0], n // x1.shape[0]]


def at3p_leg(dev, x3p):
    """The ATRAC3+ windows (full GHA, mask 7)."""
    def encode(xx):
        return at3p_encoder.encode_frames_bytes(xx, 2, gha_mask=7)
    s, f = x3p.shape[0], x3p.shape[2] // 2048
    frames = encode(x3p)
    assert frames.shape == (s, f, 2048), frames.shape
    windows = {"at3p_gha_frames_per_s": pipelined(dev, encode, x3p, s * f,
                                                  frames.cpu()),
               "at3p_fps_compute_only": compute_only(dev, encode, x3p, s * f)}
    return windows, sha256(frames), [s, f]


def card(dev):
    """(name, power limit in W) from nvidia-smi; (None, None) on the CPU."""
    if dev.type != "cuda":
        return None, None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    name, limit = smi.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), float(limit.split()[0])


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m atracdenc_tpu_torch.bench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="cuda (default; no fallback) or cpu (plain versions)")
    p.add_argument("--repeats", type=int, default=5,
                   help="windows a rate; each rate is their median")
    p.add_argument("--seed", type=int, default=42)
    args = p.parse_args(argv)
    if args.repeats < 1:
        p.error("--repeats must be >= 1")
    dev = runtime.device(args.device)
    streams, frames = SHAPES[dev.type]

    x = torch.from_numpy(corpus(streams, frames, args.seed)).to(dev)
    f1, f3p = min(AT1_FRAMES, 2 * frames), min(AT3P_FRAMES, frames // 2)
    x1 = x[:AT1_STREAMS, :, :512 * f1].contiguous()
    x3p = x[:AT3P_STREAMS, :, :2048 * f3p].contiguous()
    windows, digests, shapes = {}, {}, {}
    for leg, fn, xx in (("at3", at3_leg, x), ("at1", at1_leg, x1),
                        ("at3p", at3p_leg, x3p)):
        t0 = time.perf_counter()
        w, digests[leg], shapes[leg] = fn(dev, xx)
        windows.update(w)
        print(f"bench: {leg} {shapes[leg]} checked in "
              f"{time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    windows["d2h_link_mbps"] = d2h_link(dev)
    samples = {k: [] for k in windows}
    for r in range(args.repeats):
        for k, window in windows.items():
            samples[k].append(window())
        print(f"bench: repeat {r + 1}/{args.repeats}: "
              + ", ".join(f"{k} {v[-1]:.1f}" for k, v in samples.items()),
              file=sys.stderr, flush=True)
    med = {k: statistics.median(v) for k, v in samples.items()}
    fps = max(med["at3_fps_xla_rate_ctl"], med["at3_fps_pallas_rate_ctl"])
    name, limit = card(dev)
    line = {
        "metric": "atrac3_default_encode_throughput",
        "value": fps,
        "unit": "stereo_frames_per_s",
        "vs_baseline": fps / REF_FRAMES_PER_S,
        "extra": {
            "platform": dev.type,
            "at3_fps_xla_rate_ctl": med["at3_fps_xla_rate_ctl"],
            "at3_fps_pallas_rate_ctl": med["at3_fps_pallas_rate_ctl"],
            "at3_fps_compute_only": med["at3_fps_compute_only"],
            "d2h_link_mbps": med["d2h_link_mbps"],
            "atrac1_units_per_s": med["atrac1_units_per_s"],
            "atrac1_vs_baseline": med["atrac1_units_per_s"] / REF_AT1_UNITS_PER_S,
            "at1_units_per_s_compute_only": med["at1_units_per_s_compute_only"],
            "at1_vs_baseline_compute_only":
                med["at1_units_per_s_compute_only"] / REF_AT1_UNITS_PER_S,
            "at3p_fps_compute_only": med["at3p_fps_compute_only"],
            "at3p_gha_frames_per_s": med["at3p_gha_frames_per_s"],
            "at3p_vs_gha_off_oracle":
                med["at3p_gha_frames_per_s"] / REF_AT3P_FRAMES_PER_S,
            "at3_fps_fused_memo": med["at3_fps_fused_memo"],
            "device_name": name,
            "power_limit_w": limit,
            "repeats": args.repeats,
            "shapes": shapes,
            "spread": {k: [min(v), max(v)] for k, v in samples.items()},
            "sha256": digests,
        },
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
