"""Divergence triage of the ATRAC3 encoder's bytes: by plane, and by stage.

    python -m atracdenc_tpu_torch.triage_at3 [--case NAME] [--json OUT]
        [--device cpu] [--update]

The counterpart of ``tools/triage_at3.py`` (the JAX package).  For each
golden case (``golden_check.CASES``) the port's frames and the reference's
are parsed back into planes (``frame.unpack``) and compared plane by plane
in wire order; each divergent frame is put down to the FIRST plane that
differs, which names the machinery that decided differently:

  gain     -> gain-control curves (plateau/sticky/point0 knife edges)
  tonal    -> tonal extraction / grouping
  num_bfu  -> BFU-count shrink loop
  wordlen  -> bit-allocation bisection (lambda tie-break)
  sfi      -> scaler (lower_bound knife edge)
  mant     -> quantizer rounding (EA tie order)

It prints the per-case histogram of first planes and one exemplar frame
per plane.  ``--update`` stores this report and both ``triage_gain``
reports under the device's key of ``identity_triage.json`` beside this
file (``cpu`` equals the JAX tools' reports in ``tests/golden/``; ``cuda``
was taken on an H100), keeping the key's other entries (``triage_at1``'s).
The device is CUDA unless ``--device cpu`` is given (no CPU fallback).

``divergent_stages`` / ``first_diverging_stage`` go one level further for
the bytes by which two devices differ (CUDA against the CPU path): they run
the same encode on both under ``trace_encode.capture``, find the first
stage of ``encode_frames_chunk`` whose integer or decision outputs differ
at a (stream, frame), and re-run that stage on the device under test with
the reference device's inputs.  Equal decisions make the divergence a
``knife_edge`` (float noise upstream crossed a threshold); different ones
are ``LOGIC``, a fault of the port.
"""
import argparse
import inspect
import json
import os
import sys

import numpy as np
import torch

from atracdenc_tpu_torch import golden_check, runtime, triage_gain
from atracdenc_tpu_torch.models.atrac3 import encoder, frame, gain, tonal
from atracdenc_tpu_torch.ops import psy, scale as scale_ops
from atracdenc_tpu_torch.trace_encode import capture

KEY_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "identity_triage.json")

# plane comparison order == wire order within a channel
PLANE_ORDER = ["gain", "tonal", "num_bfu", "coding_mode", "wordlen",
               "sfi", "mant"]


def classify_frame(ours, ref, channels, js):
    """(first_plane, channel) naming the earliest divergence, or None."""
    po = frame.unpack(ours[None], channels, js=js)[0]
    pr = frame.unpack(ref[None], channels, js=js)[0]
    for ch, (a, b) in enumerate(zip(po, pr)):
        for key in PLANE_ORDER:
            va, vb = a[key], b[key]
            if isinstance(va, np.ndarray):
                same = np.array_equal(va, vb)
            else:
                same = va == vb
            if not same:
                return key, ch
    return "padding", -1     # identical planes; slack-byte noise only


def triage(device=None, case=None, log=print):
    """The report {case: {identity, divergent, frames, first_plane}} of
    every golden case (or only ``case``) on ``device``."""
    dev = runtime.device(device)
    report = {}
    for c in golden_check.CASES:
        name, _, pk, _, kw = c
        if case and name != case:
            continue
        pcm, ref = golden_check.load(c)
        ours = golden_check.encode_case(c, dev.type)
        bad = np.nonzero(~(ours == ref).all(axis=1))[0]
        channels = 1 if pk in ("pcm_mono",) else pcm.shape[0]
        hist, examples = {}, {}
        for f in bad:
            try:
                plane, ch = classify_frame(ours[f], ref[f], channels,
                                           kw.get("js", False))
            except Exception as e:          # parser tripped on the stream
                plane, ch = f"parse_error:{type(e).__name__}", -1
            hist[plane] = hist.get(plane, 0) + 1
            examples.setdefault(plane, (int(f), ch))
        ident = float((ours == ref).mean())
        log(f"{name:16s} {100 * ident:8.4f}%  divergent frames "
            f"{len(bad)}/{ref.shape[0]}  first-plane: "
            + ", ".join(f"{k}={v}" for k, v in
                        sorted(hist.items(), key=lambda x: -x[1])))
        for k, (f, ch) in examples.items():
            log(f"    e.g. {k}: frame {f} ch {ch}")
        report[name] = {"identity": ident, "divergent": int(len(bad)),
                        "frames": int(ref.shape[0]), "first_plane": hist}
    return report


def identity_key(device=None, log=print):
    """What ``--update`` stores under the device's key: this tool's report
    and both ``triage_gain`` reports, as JSON values."""
    key = {"triage_at3": triage(device, log=log)}
    for name, tag in (("default_stress", "stress"), ("js_mono", "js_mono")):
        key[f"gain_triage_{tag}"] = triage_gain.triage(name, device, log=log)
    return json.loads(json.dumps(key))


# --------------------------------------------------------------------------
# CUDA against the CPU path: the first stage whose decisions differ
# --------------------------------------------------------------------------

# (label, module, attribute, output names) of encode_frames_chunk's stages
# in call order, patched where the encoder looks them up
STAGES = (
    ("band_frames", encoder, "band_frames", ("bands",)),
    ("gain_control", gain, "gain_control",
     ("levels", "locs", "npoints", "ctx")),
    ("energy_scale", gain, "energy_scale", ("gain_scale", "carry")),
    ("mdct_frames", encoder, "mdct_frames", ("specs",)),
    ("track_loudness_scan", psy, "track_loudness_scan", ("loudness",)),
    ("tonal.extract", tonal, "extract", ("specs", "tonal")),
    ("tonal.scale_groups", tonal, "scale_groups", ("tonal",)),
    ("scale_blocks", scale_ops, "scale_blocks", ("sfi", "scaled", "energy")),
    ("quant_tensors", encoder, "quant_tensors", ("memo",)),
    ("allocate", encoder, "allocate", ("num_bfu", "coding_mode", "wordlen")),
    ("final_mantissas", encoder, "final_mantissas", ("mant",)),
)
_GAIN = ("gain_control", "energy_scale")
_TONAL = ("tonal.extract", "tonal.scale_groups")


def _stages(kw):
    """The STAGES that an encode with options ``kw`` runs."""
    return [s for s in STAGES
            if not (s[0] in _GAIN and kw.get("no_gain_control", True))
            and not (s[0] in _TONAL and kw.get("no_tonal", True))]


def _leaves(x, name):
    """(name, tensor) of every tensor in a nest of tuples, lists and
    dicts."""
    if isinstance(x, torch.Tensor):
        yield name, x
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from _leaves(v, f"{name}.{k}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{name}[{i}]")


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x


def _outputs(out, names):
    """{name: tensor} of a stage's result."""
    if not isinstance(out, tuple):
        out = (out,)
    return dict(kv for n, o in zip(names, out) for kv in _leaves(o, n))


def _inputs(fn, args, kwargs):
    """{parameter name: tensor} of a stage's call."""
    bound = inspect.signature(fn).bind(*args, **kwargs).arguments
    return dict(kv for n, v in bound.items() for kv in _leaves(v, n))


def _at(t, rows, nframes, stream, fi, channels):
    """The (stream, frame) slice of a [rows, F, ...] tensor (rows =
    streams x channels, the encoder's flattened axis), on the CPU; None for
    a tensor without that layout (constants, carries)."""
    if t.dim() < 2 or t.shape[0] != rows or t.shape[1] != nframes:
        return None
    return t[stream * channels:(stream + 1) * channels, fi].cpu()


def _is_decision(t):
    return not torch.is_floating_point(t)


def _ordered(t):
    """f32 -> int64 that orders like the floats (-0.0 and 0.0 equal)."""
    i = t.contiguous().view(torch.int32).long()
    return torch.where(i >= 0, i, -(1 << 31) - i)


def ulp_gap(a, b):
    """(largest distance in f32 units in the last place, largest |a - b| in
    units of the spacing at max |a|) of two f32 tensors; NaN on both sides
    counts as equal."""
    a, b = a.float(), b.float()
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, 0, (_ordered(a) - _ordered(b)).abs())
    peak = float(torch.nan_to_num(a.abs()).max()) if a.numel() else 0.0
    diff = torch.nan_to_num(torch.where(both_nan, 0.0, (a - b).abs()))
    spacing = float(np.spacing(np.float32(peak))) if peak > 0 else 1.0
    return (int(d.max()) if d.numel() else 0,
            float(diff.max()) / spacing if diff.numel() else 0.0)


def _run(x, kw, stages):
    """Encode ``x`` [S, C, T] with every stage's call recorded; returns
    (numpy planes, {label: (args, kwargs, result)})."""
    got = {}
    calls = capture([(m, a, label) for label, m, a, _ in stages],
                    lambda: got.update(encoder.encode_frames(x, **kw)),
                    outputs=True)
    recs = {}
    for label, _, _, _ in stages:
        (recs[label],) = calls[label]
    return {k: runtime.to_numpy(v) for k, v in got.items()}, recs


def _pack(planes, s, kw):
    return frame.pack({k: v[s] for k, v in planes.items()},
                      kw.get("frame_bytes", 384), js=kw.get("js", False))


def divergent_stages(pcm, kw, frames=None, device=None, ref_device="cpu",
                     streams=None):
    """Classify the frames by which ``device``'s bytes (CUDA unless "cpu")
    differ from ``ref_device``'s for the same encode.

    pcm [C, T] or [S, C, T] numpy; kw: ``encode_frames`` options.
    ``streams`` (start, stop) limits the reference device's encode to those
    streams (the device under test always encodes the whole batch, as the
    run whose bytes are in question did); ``frames`` [(stream, frame)]
    (default: every frame whose packed bytes differ).  Returns one dict per
    frame: ``first_plane`` (wire order, ``classify_frame``; None where the
    bytes are equal), ``stage`` (the first of ``STAGES`` whose integer or
    decision outputs differ at that stream and frame), ``outputs`` (those
    outputs), ``ulp`` / ``peak_ulp`` (``ulp_gap`` of the stage's float
    inputs there, the largest over its inputs, and ``input``, whose it
    is), ``int_inputs`` (integer inputs that already differ there),
    ``upstream`` ({stage: the largest ``peak_ulp`` of its float outputs
    there} for the stages before it: where the float noise came from) and
    ``class``: ``knife_edge`` when the stage re-run on ``device`` with the
    reference device's inputs gives the reference's decisions, ``LOGIC``
    when it does not, ``unexplained`` when no stage's decisions differ."""
    pcm = np.asarray(pcm, np.float32)
    pcm = pcm.reshape((1,) * (3 - pcm.ndim) + pcm.shape)
    pcm = np.pad(pcm, ((0, 0), (0, 0), (0, (-pcm.shape[-1]) % 1024)))
    n_streams, c, t = pcm.shape
    nf = t // 1024
    lo, hi = (0, n_streams) if streams is None else streams
    dev, ref = runtime.device(device), runtime.device(ref_device)
    stages = _stages(kw)
    planes_d, rec_d = _run(runtime.to_torch(pcm, dev), kw, stages)
    planes_r, rec_r = _run(runtime.to_torch(pcm[lo:hi], ref), kw, stages)
    bytes_d = {s: _pack(planes_d, s, kw) for s in range(lo, hi)}
    bytes_r = {s: _pack(planes_r, s - lo, kw) for s in range(lo, hi)}
    if frames is None:
        frames = [(s, int(f)) for s in range(lo, hi) for f in
                  np.nonzero((bytes_d[s] != bytes_r[s]).any(axis=1))[0]]
    js = kw.get("js", False)
    rows_d, rows_r = n_streams * c, (hi - lo) * c

    def at_d(x, s, fi):
        return _at(x, rows_d, nf, s, fi, c)

    def at_r(x, s, fi):
        return _at(x, rows_r, nf, s - lo, fi, c)

    replays = {}
    out = []
    for s, fi in frames:
        e = {"stream": s, "frame": fi, "first_plane": None, "stage": None,
             "outputs": [], "ulp": 0, "peak_ulp": 0.0, "input": None,
             "int_inputs": [], "upstream": {}, "class": "unexplained"}
        if not np.array_equal(bytes_d[s][fi], bytes_r[s][fi]):
            e["first_plane"] = classify_frame(bytes_d[s][fi], bytes_r[s][fi],
                                              c, js)[0]
        for label, mod, attr, names in stages:
            a_r, k_r, o_r = rec_r[label]
            a_d, k_d, o_d = rec_d[label]
            out_r, out_d = _outputs(o_r, names), _outputs(o_d, names)
            differ = [n for n, v in out_r.items() if _is_decision(v)
                      and at_r(v, s, fi) is not None
                      and not torch.equal(at_r(v, s, fi), at_d(out_d[n], s, fi))]
            if not differ:
                gaps = [ulp_gap(at_r(v, s, fi), at_d(out_d[n], s, fi))[1]
                        for n, v in out_r.items() if not _is_decision(v)
                        and at_r(v, s, fi) is not None]
                if gaps:
                    e["upstream"][label] = max(gaps)
                continue
            fn = getattr(mod, attr)
            in_r, in_d = _inputs(fn, a_r, k_r), _inputs(fn, a_d, k_d)
            for n, v in in_r.items():
                vr, vd = at_r(v, s, fi), at_d(in_d[n], s, fi)
                if vr is None:
                    continue
                if _is_decision(vr):
                    if not torch.equal(vr, vd):
                        e["int_inputs"].append(n)
                    continue
                gap, peak = ulp_gap(vr, vd)
                if gap > e["ulp"]:
                    e["ulp"], e["input"] = gap, n
                e["peak_ulp"] = max(e["peak_ulp"], peak)
            if label not in replays:
                replays[label] = _outputs(fn(*_to(a_r, dev), **_to(k_r, dev)),
                                          names)
            same = all(torch.equal(at_r(v, s, fi), at_r(replays[label][n], s, fi))
                       for n, v in out_r.items() if _is_decision(v)
                       and at_r(v, s, fi) is not None)
            e.update(stage=label, outputs=differ,
                     **{"class": "knife_edge" if same else "LOGIC"})
            break
        out.append(e)
    return out


def first_diverging_stage(pcm, kw, frame, stream=0, device=None,
                          ref_device="cpu"):
    """``divergent_stages`` for one (stream, frame): the first stage whose
    decisions differ there between ``device`` (CUDA unless "cpu") and
    ``ref_device``, the ulp gap of its float inputs, and its class."""
    return divergent_stages(pcm, kw, [(stream, frame)], device,
                            ref_device)[0]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m atracdenc_tpu_torch.triage_at3",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default=None,
                    choices=[c[0] for c in golden_check.CASES])
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (default; no fallback) or cpu (plain versions)")
    ap.add_argument("--update", action="store_true",
                    help="store this report and both triage_gain reports "
                         "under the device's key of identity_triage.json")
    args = ap.parse_args(argv)
    dev = runtime.device(args.device)
    if args.update:
        key = identity_key(dev.type)
        stored = {}
        if os.path.exists(KEY_FILE):
            with open(KEY_FILE) as fp:
                stored = json.load(fp)
        stored.setdefault(dev.type, {}).update(key)
        with open(KEY_FILE, "w") as fp:
            json.dump(stored, fp, indent=1)
            fp.write("\n")
        print(f"updated {KEY_FILE} [{dev.type}]")
        return 0
    report = triage(dev.type, args.case)
    if args.json:
        with open(args.json, "w") as fp:
            json.dump(report, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
