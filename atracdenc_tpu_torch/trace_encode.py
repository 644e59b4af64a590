"""Where the port's encode time goes on one GPU, read from its own spans.

    python -m atracdenc_tpu_torch.trace_encode [--out PATH.json]

Traces one batch call of each codec on the bench corpus (seed 42, 997 Hz
tone + noise): a middle chunk (the carry of a first chunk of the same PCM,
its first frame as the lookahead), ``encode_frames_chunk`` then the device
packer, as a library user batches tracks:
  * ATRAC3, the main path: 64 streams x 256 stereo frames, default mode,
    ``pack_device_batch`` (the shape of chip_smoke.py and bench.py);
  * ATRAC1: the same PCM as 64 streams x 2 ch x 512 frames (the
    ``atrac1-sp.batch`` cell's call), ``pack_device``;
  * ATRAC3+: the same PCM as 64 streams x 128 stereo frames of 2048
    samples, GHA mask 7, ``encode_chunk_bytes`` (``encode_chunk_device``
    and ``pack_device``: the ``atrac3plus.batch`` cell's call at a
    quarter of its frames).
Each call runs twice to warm up, then
  1. once with the port's tracer on (``trace.py``): per span path (root /
     ... / span) the calls, host ms, device ms and self ms (the device time
     its child spans leave; the self times add up to the roots' time), the
     ``host_sync`` count under each root, and ATRAC3+'s GHA lane-rounds:
     those kernel H computed (``gha.lane_rounds``) of those the plain
     greedy would (``gha.lane_rounds_offered``);
  2. once more with the tracer on under ``torch.profiler``: the device's
     busy time (the union of its kernel, copy and set intervals, not their
     sum) and idle share, the device ops with most time, and every device
     op and idle gap put under the innermost program span: the span whose
     profiler range holds the host time of the runtime call that launched
     the op (for a gap, the op that ends it), on the profiler's own clock.  The sites of ``CatArrayBatchedCopy`` and of the
     int64 scans are listed by span path; a function that opens one site
     span name at several sites (``offset_scan``, ``field_cat``) has them
     apart as ``name[k]``, the k-th in the function.
Writes the numbers as JSON to --out and prints a summary.  Needs CUDA.
"""
import argparse
import collections
import json
import os
import subprocess
import tempfile
import time

import torch

from atracdenc_tpu_torch import kernels, trace
from atracdenc_tpu_torch.bench import SHAPES, corpus, device_seconds

STREAMS, FRAMES = SHAPES["cuda"]
TOP = 10
# span names that one function opens at several sites: kept apart as
# name[k], the k-th of its name under one parent
SITES = ("offset_scan", "field_cat")
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH = ("cuda_runtime", "cuda_driver")


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


def span_paths(records):
    """Records -> copies named by their path ("root/.../name", a site span
    as name[k])."""
    by_id = {r["id"]: r for r in records}
    order = collections.defaultdict(list)
    for r in sorted(records, key=lambda r: r["host"][0]):
        if r["name"] in SITES:
            order[r["parent"], r["name"]].append(r["id"])

    def label(r):
        if r["name"] not in SITES:
            return r["name"]
        return f"{r['name']}[{order[r['parent'], r['name']].index(r['id'])}]"

    def path(r):
        names = [label(r)]
        while r["parent"] is not None and r["parent"] in by_id:
            r = by_id[r["parent"]]
            names.append(label(r))
        return "/".join(reversed(names))
    return [dict(r, name=path(r)) for r in records]


def stage_split(records):
    """The tracer's records of one call -> ({path: {calls, host_ms,
    device_ms, self_ms}}, {root: host_sync count}, the roots' ms)."""
    records = [r for r in records if not r["profiled"]]
    spans = trace.summarize(span_paths(records))["spans"]
    stages = {k: {"calls": v["count"], "host_ms": v["host_ms"],
                  "device_ms": v["device_ms"], "self_ms": v["self_ms"]}
              for k, v in spans.items()}
    syncs = collections.Counter()
    for r in records:
        syncs[r["root_name"]] += r["counts"].get("host_sync", 0)
    roots = sum(v["device_ms"] if v["device_ms"] is not None else v["host_ms"]
                for k, v in spans.items() if "/" not in k)
    return stages, dict(syncs), roots


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _contains(p, e):
    return p is not e and p["ts"] <= e["ts"] \
        and e["ts"] + e["dur"] <= p["ts"] + p["dur"]


def _labels(notes):
    """id(annotation) -> its name, a site span's as name[k]."""
    order = collections.defaultdict(list)
    for e in sorted(notes, key=lambda e: e["ts"]):
        if e["name"] in SITES:
            parent = min((p for p in notes if _contains(p, e)),
                         key=lambda p: p["dur"], default=None)
            order[id(parent), e["name"]].append(e)
    labels = {id(e): e["name"] for e in notes}
    for sites in order.values():
        for k, e in enumerate(sites):
            labels[id(e)] = f"{e['name']}[{k}]"
    return labels


def _innermost(annotations, labels, t):
    """The path of program spans whose host range holds time ``t``,
    outermost first ("(no span)" if none)."""
    inside = [e for e in annotations if e["ts"] <= t <= e["ts"] + e["dur"]]
    inside.sort(key=lambda e: -e["dur"])
    return "/".join(labels[id(e)] for e in inside) or "(no span)"


def attribute(events, wall_s, names):
    """A profiler trace's events (Chrome format) and the program's span
    ``names`` -> busy / idle, top ops, and every device op and idle gap
    under its innermost program span."""
    dev = [e for e in events if e.get("ph") == "X" and "dur" in e
           and e.get("cat") in _DEVICE]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("ph") == "X" and e.get("cat") in _LAUNCH
              and "correlation" in e.get("args", {})}
    notes = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "cpu_op" and e["name"] in names]
    labels = _labels(notes)

    def where(op):
        call = launch.get(op.get("args", {}).get("correlation"))
        if call is None:
            return "(no launch)"
        return _innermost(notes, labels, call["ts"])

    merged = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_s = sum(b - a for a, b in merged) / 1e6
    by_op, by_span = collections.Counter(), collections.Counter()
    cats, scans = collections.Counter(), collections.Counter()
    n_cat, n_scan = collections.Counter(), collections.Counter()
    for e in dev:
        ms = e["dur"] / 1e3
        site = where(e)
        by_op[e["name"][:120]] += ms
        by_span[site] += ms
        name = e["name"]
        if "CatArrayBatchedCopy" in name:
            cats[site] += ms
            n_cat[site] += 1
        elif "scan" in name.lower() and ("long" in name or "int64" in name):
            scans[site] += ms
            n_scan[site] += 1
    starts = sorted(dev, key=lambda e: e["ts"])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i + 1][0])
                   for i in range(len(merged) - 1)), reverse=True)[:TOP]
    idle = []
    for dur, b in gaps:
        op = next(e for e in starts if e["ts"] >= b)
        idle.append({"ms": dur / 1e3, "span": where(op),
                     "next_op": op["name"][:120]})

    def top(c, n=None):
        return [{"span": k, "ms": v, **({"launches": n[k]} if n else {})}
                for k, v in c.most_common(TOP)]
    return {"wall_ms": 1e3 * wall_s, "device_busy_ms": 1e3 * busy_s,
            "device_idle_share": 1.0 - busy_s / wall_s if wall_s else None,
            "kernel_launches": sum(1 for e in dev if e["cat"] == "kernel"),
            "top_ops": [{"name": k, "ms": v}
                        for k, v in by_op.most_common(15)],
            "device_ms_by_span": top(by_span), "cat_sites": top(cats, n_cat),
            "int64_scan_sites": top(scans, n_scan),
            "idle_gaps": idle}


def _trace(call, items):
    """Warm-up, one traced call, one traced call under the profiler."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    trace.reset()
    trace.enable()
    call()
    snap = trace.snapshot()
    stages, syncs, roots_ms = stage_split(snap["records"])
    lane_rounds = {k: v["total"] for k, v in snap["counters"].items()
                   if k.startswith("gha.lane_rounds")}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    names = {r["name"] for r in trace.snapshot()["records"]}
    trace.disable()
    trace.reset()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "profile.json")
        prof.export_chrome_trace(path)
        with open(path) as fp:
            events = json.load(fp)["traceEvents"]
    out = {"items": items, "roots_ms": roots_ms,
           "self_ms_sum": sum(v["self_ms"] for v in stages.values()),
           "stages": stages, "host_syncs": syncs, "lane_rounds": lane_rounds}
    out.update(attribute(events, wall_s, names))
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(kernels.BUILD_DIR,
                                                 "trace_encode.json"))
    args = p.parse_args(argv)

    from atracdenc_tpu_torch import runtime
    from atracdenc_tpu_torch.models.atrac1 import device_pack as pack1
    from atracdenc_tpu_torch.models.atrac1 import encoder as enc1
    from atracdenc_tpu_torch.models.atrac3 import device_pack as pack3
    from atracdenc_tpu_torch.models.atrac3 import encoder as enc3
    from atracdenc_tpu_torch.models.atrac3p import encoder as enc3p

    dev = runtime.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]

    x3 = _corpus(STREAMS, FRAMES, dev)
    opts3 = dict(no_gain_control=False, no_tonal=False)
    _, st3 = enc3.encode_frames_chunk(x3, None, x3[..., :1024], **opts3)

    def at3_call():
        planes, _ = enc3.encode_frames_chunk(x3, st3, x3[..., :1024], **opts3)
        return pack3.pack_device_batch(planes, 384)

    out = {"card": card, "atrac3": _trace(at3_call, {
        "stereo_frames": STREAMS * FRAMES})}
    # the same PCM: 256 x 1024 = 512 x 512 samples a stream
    _, st1 = enc1.encode_frames_chunk(x3, None, x3[..., :512])

    def at1_call():
        planes, _ = enc1.encode_frames_chunk(x3, st1, x3[..., :512])
        return pack1.pack_device(pack1.merge_channels(planes))

    out["atrac1"] = _trace(at1_call, {
        "sound_units": STREAMS * 2 * FRAMES * 2})
    # the same PCM: 256 x 1024 = 128 x 2048 samples a stream
    _, st3p = enc3p.encode_chunk_bytes(x3, None, x3[..., :2048])

    def at3p_call():
        return enc3p.encode_chunk_bytes(x3, st3p, x3[..., :2048])[0]

    out["atrac3plus"] = _trace(at3p_call, {
        "stereo_frames": STREAMS * FRAMES // 2})
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fp:
        json.dump(out, fp, indent=1)
    for codec in ("atrac3", "atrac1", "atrac3plus"):
        r = out[codec]
        print(f"{card} | {codec} {r['items']}: wall {r['wall_ms']:.1f} ms, "
              f"device busy {r['device_busy_ms']:.1f} ms, idle share "
              f"{r['device_idle_share']:.4f}, {r['kernel_launches']} kernel "
              f"launches; host syncs by root {r['host_syncs']}")
        lr = r["lane_rounds"]
        if lr:
            done = lr.get("gha.lane_rounds", 0)
            offered = lr["gha.lane_rounds_offered"]
            print(f"GHA greedy: {done} lane-rounds computed of {offered} "
                  f"offered ({done / offered:.4f})")
        print(f"spans (roots {r['roots_ms']:.2f} ms, self times add to "
              f"{r['self_ms_sum']:.2f} ms): path, calls, host ms, device ms, "
              "self ms")
        for k, v in sorted(r["stages"].items(),
                           key=lambda kv: -kv[1]["self_ms"]):
            print(f"  {k:58s} {v['calls']:4d} {v['host_ms']:9.3f} "
                  f"{v['device_ms'] or 0.0:9.3f} {v['self_ms']:9.3f}")
        for key, title in (("device_ms_by_span", "device ms by span"),
                           ("cat_sites", "CatArrayBatchedCopy by span"),
                           ("int64_scan_sites", "int64 scans by span")):
            print(f"{title}:")
            for s in r[key]:
                n = f" x{s['launches']}" if "launches" in s else ""
                print(f"  {s['ms']:9.3f} ms{n:7s} {s['span']}")
        print("idle gaps: ms, span, the op that ends the gap")
        for g in r["idle_gaps"]:
            print(f"  {g['ms']:7.3f} {g['span']:50s} {g['next_op'][:60]}")
        print("top device ops:")
        for o in r["top_ops"]:
            print(f"  {o['ms']:9.3f} ms  {o['name'][:100]}")


if __name__ == "__main__":
    main()
