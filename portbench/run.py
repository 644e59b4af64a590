"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m portbench.run --workload atrac3-lp2.batch --seed 7 \
        --seconds 40 --trace 0

Sets the cell up (the program's kernels built or loaded, the traffic made
from ``--seed``, every shape the cell uses warmed up), drives it for
``--seconds``, checks what the window produced against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
traced ``breakdown``, ``numbers`` (every number the comparison computes),
and, last in the line, ``checks``: each number compared with its limit
(also the last lines of standard error).

It exits non-zero and prints no line when there is no CUDA card (there is
no CPU fallback), when the cell needs more cards than there are, and when
``jax``, ``jaxlib``, ``flax`` or ``atracdenc_tpu`` is loaded once the
window has closed.  Build and kernel caches stay inside the checkout
(``.build/``); the traffic's files go under ``TMPDIR``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "atracdenc_tpu"}
CACHE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".build", "portbench")


class Context:
    """What a driver gets: the cell's files, its codec and the run."""

    def __init__(self, cell, seed, device, workdir):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.codec_module = cell.codec_module()
        self.codec = self.codec_module.Codec(cell.config)
        self.seed = seed
        self.device = device
        self.workdir = workdir


def loaded_forbidden():
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``atracdenc_tpu_torch`` is not ``atracdenc_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


def run_cell(cell, seed, seconds, trace, device, t_start, workdir,
             alter=None):
    """One run of ``cell`` (a ``manifest.Cell``) on ``device`` -> the
    result dict (``checks`` last).  ``alter(ctx)``, for the control and
    the fault tests, may replace ``ctx.codec`` and returns a context
    manager held from set-up to the end of the window."""
    ctx = Context(cell, seed, device, workdir)
    held = alter(ctx) if alter is not None else contextlib.nullcontext()
    driver = cell.driver_module().Driver(ctx)
    try:
        with held:
            values, wanted, attempted, dev_info, breakdown = _drive(
                cell, ctx, driver, seconds, trace, t_start)
        t_check = time.perf_counter()
        reference = cell.reference_module().Reference(cell.config)
        tally = driver.check(reference)
        numbers = tally.numbers(reference.spectra)
        print(f"portbench: {cell.name} seed {seed}: window closed "
              f"{t_check - t_start:.1f} s after start, check "
              f"{time.perf_counter() - t_check:.1f} s; rows {tally.rows}, "
              f"numbers {json.dumps(numbers)}", file=sys.stderr)
    finally:
        driver.close()
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in cell.limits.items()}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": attempted,
        "failed": tally.lost_units,
        "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                    for m in wanted},
        "device": dev_info,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["numbers"] = numbers
    result["checks"] = checks
    return result


def _drive(cell, ctx, driver, seconds, trace, t_start):
    """Set-up and the window (untraced or traced) -> (values, the metric
    entries to report, attempted, device info, breakdown)."""
    import torch

    from portbench import manifest, tracing

    device = ctx.device
    cuda = device.type == "cuda"
    driver.setup()
    setup_s = time.perf_counter() - t_start
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                "count": 1}
    breakdown = None
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if not trace:
        values, attempted = driver.measure(seconds)
        values["setup_s"] = setup_s
        wanted = [m for m in cell.end_to_end if m["name"] in values]
    else:
        tr = tracing.Trace(kind)
        readers = [(m, manifest.reader(m["name"])) for m in cell.per_layer]
        specs = [s for _, r in readers for s in getattr(r, "SPANS", ())]
        prof_s = min(cell.traffic["profile_seconds"], seconds / 3)
        attempted = 0
        if cuda:
            path = os.path.join(ctx.workdir, "profile.json")
            tr.profile, n = tracing.profile(
                lambda: driver.window(prof_s), path)
            attempted += n
            dev_info["busy_s"] = tr.profile["busy_s"]
            dev_info["window_s"] = tr.profile["window_s"]
            breakdown = {k: tr.profile[k]
                         for k in ("device_ops", "idle_gaps")}
        with tracing.Spans(specs, ctx.codec_module.MODULES, tr, cuda):
            tr.calls = driver.window(max(seconds - prof_s, 1e-3))
        attempted += tr.calls
        values = {}
        for m, r in readers:
            v = r.read(tr)
            if v is not None:
                values[m["name"]] = v
        wanted = [m for m in cell.per_layer if m["name"] in values]
    if cuda:
        dev_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)
        torch.cuda.empty_cache()
    return values, wanted, attempted, dev_info, breakdown


def main(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(CACHE, sub)
    from portbench import manifest
    cell = manifest.cell(args.workload)

    import torch
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="portbench-") as workdir:
        result = run_cell(cell, args.seed, args.seconds, args.trace, device,
                          T_START, workdir)
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
