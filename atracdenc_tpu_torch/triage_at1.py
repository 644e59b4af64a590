"""Divergence triage of the ATRAC1 encoder's sound units: by plane, and by stage.

    python -m atracdenc_tpu_torch.triage_at1 [--case NAME] [--json OUT]
        [--device cpu] [--update]

The ATRAC1 counterpart of ``triage_at3`` (the JAX package has no ATRAC1
triage tool).  Each case (``CASES``: ``tests/golden/<name>.npz["pcm_in"]``
and the reference encoder's AEA) is encoded whole with
``models/atrac1/encoder.py::encode_frames`` on the device and packed with
``frame.pack``; for a track of at most ``encode_track``'s chunk these are
``encode_track``'s bytes.  The report of a case holds the byte identity
against the reference's units, the units that differ, the histogram of
their first plane in wire order (``PLANE_ORDER``, from ``frame.unpack``)
and ``vs_cpu``: ``divergent_stages`` of the device against the CPU path,
one entry per unit whose bytes differ (none on the CPU).  ``--update``
stores the report under the ``triage_at1`` entry of the device's key of
``identity_triage.json`` (``cpu``: the JAX encoder's identities; ``cuda``:
taken on an H100).  The device is CUDA unless ``--device cpu`` is given
(no CPU fallback).

``divergent_stages`` runs the same encode on two devices under
``trace_encode.capture``, finds for each sound unit whose bytes differ the
first stage of ``encode_frames`` (``STAGES``) whose integer or decision
outputs differ at that (stream, channel, frame), and re-runs that stage on
the device under test with the reference device's inputs: ``knife_edge``
if it then decides as the reference did, ``LOGIC`` (a fault of the port)
if not, ``unexplained`` if no stage's decisions differ.
"""
import argparse
import json
import os
import sys

import numpy as np

from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.containers import aea
from atracdenc_tpu_torch.golden_check import GOLDEN
from atracdenc_tpu_torch.models.atrac1 import bitalloc, encoder, filterbank
from atracdenc_tpu_torch.models.atrac1.device_pack import merge_channels
from atracdenc_tpu_torch.models.atrac1 import frame
from atracdenc_tpu_torch.models.atrac1 import tables as T
from atracdenc_tpu_torch.ops import psy, scale as scale_ops
from atracdenc_tpu_torch.trace_encode import capture
from atracdenc_tpu_torch.triage_at3 import (KEY_FILE, _inputs, _is_decision,
                                            _outputs, _to, ulp_gap)

# (name, reference AEA) under tests/golden/
CASES = (("at1_golden", "at1_ref.aea"),
         ("at1_stress_pcm", "at1_stress_ref.aea"))

# plane comparison order == wire order within a sound unit
PLANE_ORDER = ["short_mask", "bfu_idx", "wordlen", "sfi", "mant"]

# what a ``vs_cpu`` entry keeps in the report (the float gaps are logged)
KEPT = ("unit", "stream", "channel", "frame", "first_plane", "stage",
        "outputs", "class")

# (label, module, attribute, output names, call index) of encode_frames'
# stages in call order, patched where the encoder looks them up; the
# transient detector and the MDCT run once per band (low, mid, hi)
_BANDS = ("low", "mid", "hi")
STAGES = (
    (("filterbank.analysis", filterbank, "analysis", _BANDS, 0),)
    + tuple((f"encoder.transient_mask[{b}]", encoder, "transient_mask",
             ("mask",), i) for i, b in enumerate(_BANDS))
    + tuple((f"encoder.mdct_frames[{b}]", encoder, "mdct_frames", ("specs",),
             i) for i, b in enumerate(_BANDS))
    + (("psy.track_loudness_scan", psy, "track_loudness_scan", ("loud",), 0),
       ("encoder.gather_bfu_blocks", encoder, "gather_bfu_blocks",
        ("blocks",), 0),
       ("scale.scale_blocks", scale_ops, "scale_blocks",
        ("sfi", "scaled", "energy"), 0),
       ("encoder.at1_allocate_block", encoder, "at1_allocate_block",
        ("bfu_idx", "wordlen"), 0),
       ("scale.quant_mantissas", scale_ops, "quant_mantissas", ("mant",), 0)))
# the rate-control stage of ``use_rate_kernel=False``
_TENSOR_OP_ALLOC = ("bitalloc.allocate", bitalloc, "allocate",
                    ("bfu_idx", "wordlen"), 0)
# the frames a stage sees before and after the track's in the one-chunk
# window of ``encoder._encode_window``: the QMF reads the context frames and
# the lookahead, the transient detector the lookahead, and the MDCT one
# warm-up frame before the first; every other stage sees the track's
_WINDOW = {"analysis": (encoder.CHUNK_LEFT, encoder.CHUNK_RIGHT),
           "transient_mask": (0, encoder.CHUNK_RIGHT),
           "mdct_frames": (1, 0)}


def _stages(kw):
    """The STAGES that an encode with options ``kw`` runs."""
    if kw.get("use_rate_kernel", True):
        return STAGES
    return tuple(_TENSOR_OP_ALLOC if s[0] == "encoder.at1_allocate_block"
                 else s for s in STAGES)


def _at(t, grid, s, c, fi, window=(0, 0)):
    """The (stream, channel, frame) slice of an encoder tensor, on the CPU:
    [S, C, F, ...] planes, [S, C, F * n] band signals (n samples a frame)
    and [S, F] loudness tracks, F counting the stage's ``window`` frames
    before and after the track's; None for any other layout (constants)."""
    n_s, n_c, n_f = grid[0], grid[1], grid[2] + sum(window)
    grid, fi = (n_s, n_c, n_f), fi + window[0]
    if t.dim() >= 3 and tuple(t.shape[:3]) == grid:
        return t[s, c, fi].cpu()
    if t.dim() == 3 and tuple(t.shape[:2]) == (n_s, n_c) \
            and t.shape[2] > n_f and t.shape[2] % n_f == 0:
        n = t.shape[2] // n_f
        return t[s, c, fi * n:(fi + 1) * n].cpu()
    if t.dim() == 2 and tuple(t.shape) == (n_s, n_f):
        return t[s, fi].cpu()
    return None


def unit_of(s, c, fi, channels, frames):
    """Row of (stream, channel, frame) in ``merge_channels``' order:
    stream-major, frame-major, channel-minor."""
    return (s * frames + fi) * channels + c


def unit_index(u, channels, frames):
    """(stream, channel, frame) of row ``u`` (``unit_of``'s inverse)."""
    return u // (frames * channels), u % channels, u // channels % frames


def pack_units(planes):
    """Planes [S, C, F, ...] (tensors) -> [S * F * C, 212] uint8 units."""
    return frame.pack({k: runtime.to_numpy(v)
                       for k, v in merge_channels(planes).items()})


def first_plane(ours, ref):
    """The first plane in wire order that differs between two units, or
    ``padding`` when their planes are equal."""
    po, pr = frame.unpack(ours[None]), frame.unpack(ref[None])
    for key in PLANE_ORDER:
        if not np.array_equal(po[key], pr[key]):
            return key
    return "padding"


def _run(x, kw, stages):
    """Encode ``x`` [S, C, T] with every stage's call recorded; returns
    (units, {label: (args, kwargs, result)})."""
    got = {}
    sites = {(m, a) for _, m, a, _, _ in stages}
    calls = capture([(m, a, a) for m, a in sites],
                    lambda: got.update(encoder.encode_frames(x, **kw)),
                    outputs=True)
    return pack_units(got), {label: calls[a][i]
                             for label, _, a, _, i in stages}


def _whole_frames(pcm):
    pcm = np.asarray(pcm, np.float32)
    pcm = pcm.reshape((1,) * (3 - pcm.ndim) + pcm.shape)
    return np.pad(pcm, ((0, 0), (0, 0), (0, (-pcm.shape[-1]) % T.NUM_SAMPLES)))


def divergent_stages(pcm, frames=None, device=None, ref_device="cpu", **kw):
    """Classify the sound units by which ``device``'s bytes (CUDA unless
    "cpu") differ from ``ref_device``'s for the same encode.

    pcm [C, T] or [S, C, T] numpy; kw: ``encode_frames`` options.
    ``frames`` [(stream, channel, frame)] (default: every unit whose packed
    bytes differ).  Returns one dict per unit: ``unit`` (its row in
    ``merge_channels``' order), ``stream``, ``channel``, ``frame``,
    ``first_plane`` (wire order; None where the bytes are equal),
    ``stage`` (the first of ``STAGES`` whose integer or decision outputs
    differ there), ``outputs`` (those outputs), ``ulp`` / ``peak_ulp``
    (``ulp_gap`` of the stage's float inputs there, the largest over its
    inputs, and ``input``, whose it is), ``int_inputs`` (integer inputs that
    already differ there), ``upstream`` ({stage: the largest ``peak_ulp``
    of its float outputs there} for the stages before it) and ``class``:
    ``knife_edge`` when the stage re-run on ``device`` with the reference
    device's inputs gives the reference's decisions, ``LOGIC`` when it does
    not, ``unexplained`` when no stage's decisions differ."""
    pcm = _whole_frames(pcm)
    grid = (pcm.shape[0], pcm.shape[1], pcm.shape[2] // T.NUM_SAMPLES)
    dev, ref = runtime.device(device), runtime.device(ref_device)
    stages = _stages(kw)
    units_d, rec_d = _run(runtime.to_torch(pcm, dev), kw, stages)
    units_r, rec_r = _run(runtime.to_torch(pcm, ref), kw, stages)
    if frames is None:
        frames = [unit_index(int(u), grid[1], grid[2]) for u in
                  np.nonzero((units_d != units_r).any(axis=1))[0]]
    replays = {}
    out = []
    for s, c, fi in frames:
        u = unit_of(s, c, fi, grid[1], grid[2])
        e = {"unit": u, "stream": s, "channel": c, "frame": fi,
             "first_plane": None, "stage": None, "outputs": [], "ulp": 0,
             "peak_ulp": 0.0, "input": None, "int_inputs": [], "upstream": {},
             "class": "unexplained"}
        if not np.array_equal(units_d[u], units_r[u]):
            e["first_plane"] = first_plane(units_d[u], units_r[u])
        for label, mod, attr, names, _ in stages:
            a_r, k_r, o_r = rec_r[label]
            a_d, k_d, o_d = rec_d[label]
            win = _WINDOW.get(attr, (0, 0))
            out_r = {n: _at(v, grid, s, c, fi, win)
                     for n, v in _outputs(o_r, names).items()}
            out_d = {n: _at(v, grid, s, c, fi, win)
                     for n, v in _outputs(o_d, names).items()}
            differ = [n for n, v in out_r.items() if v is not None
                      and _is_decision(v) and not v.equal(out_d[n])]
            if not differ:
                gaps = [ulp_gap(v, out_d[n])[1] for n, v in out_r.items()
                        if v is not None and not _is_decision(v)]
                if gaps:
                    e["upstream"][label] = max(gaps)
                continue
            fn = getattr(mod, attr)
            in_d = _inputs(fn, a_d, k_d)
            for n, v in _inputs(fn, a_r, k_r).items():
                vr = _at(v, grid, s, c, fi, win)
                vd = _at(in_d[n], grid, s, c, fi, win)
                if vr is None:
                    continue
                if _is_decision(vr):
                    if not vr.equal(vd):
                        e["int_inputs"].append(n)
                    continue
                gap, peak = ulp_gap(vr, vd)
                if gap > e["ulp"]:
                    e["ulp"], e["input"] = gap, n
                e["peak_ulp"] = max(e["peak_ulp"], peak)
            if label not in replays:
                replays[label] = _outputs(fn(*_to(a_r, dev), **_to(k_r, dev)),
                                          names)
            same = all(v.equal(_at(replays[label][n], grid, s, c, fi, win))
                       for n, v in out_r.items()
                       if v is not None and _is_decision(v))
            e.update(stage=label, outputs=differ,
                     **{"class": "knife_edge" if same else "LOGIC"})
            break
        out.append(e)
    return out


def load(name):
    """(pcm [C, T], reference units [N, 212]) of the case ``name``."""
    ref_file = dict(CASES)[name]
    pcm = np.load(os.path.join(GOLDEN, f"{name}.npz"))["pcm_in"]
    return pcm, aea.read(os.path.join(GOLDEN, ref_file))[0]


def encode_case(name, device):
    """The port's units [F * C, 212] of the case ``name``: the whole track
    through ``encode_frames`` on ``device``, then ``frame.pack``."""
    pcm, _ = load(name)
    x = runtime.to_torch(_whole_frames(pcm), runtime.device(device))
    return pack_units(encoder.encode_frames(x))


def entry_line(e):
    """One log line of a ``divergent_stages`` entry."""
    return (f"unit {e['unit']} (channel {e['channel']}, frame {e['frame']}): "
            f"first plane {e['first_plane']}, first stage {e['stage']} "
            f"{e['outputs']}, ulp gap {e['ulp']} ({e['input']}; "
            f"{e['peak_ulp']!r} of the spacing at its peak), integer inputs "
            f"that differ {e['int_inputs']}, upstream output gaps in spacings "
            f"at their peak {e['upstream']}, class {e['class']}")


def triage(device=None, case=None, log=print):
    """The report {case: {identity, divergent, units, first_plane, vs_cpu}}
    of every case (or only ``case``) on ``device``."""
    dev = runtime.device(device)
    report = {}
    for name, _ in CASES:
        if case and name != case:
            continue
        pcm, ref = load(name)
        ours = encode_case(name, dev.type)
        assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
        bad = np.nonzero(~(ours == ref).all(axis=1))[0]
        hist = {}
        for u in bad:
            plane = first_plane(ours[u], ref[u])
            hist[plane] = hist.get(plane, 0) + 1
        ident = float((ours == ref).mean())
        stages = divergent_stages(pcm, device=dev.type)
        log(f"{name:16s} {100 * ident:8.4f}%  divergent units "
            f"{len(bad)}/{ref.shape[0]}  first-plane: "
            + ", ".join(f"{k}={v}" for k, v in
                        sorted(hist.items(), key=lambda x: -x[1]))
            + f"; units that differ from the CPU path: {len(stages)}")
        for e in stages:
            log(f"    {entry_line(e)}")
        report[name] = {"identity": ident, "divergent": int(len(bad)),
                        "units": int(ref.shape[0]), "first_plane": hist,
                        "vs_cpu": [{k: e[k] for k in KEPT} for e in stages]}
    return json.loads(json.dumps(report))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m atracdenc_tpu_torch.triage_at1",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default=None, choices=[c[0] for c in CASES])
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (default; no fallback) or cpu (plain versions)")
    ap.add_argument("--update", action="store_true",
                    help="store the report under the triage_at1 entry of the "
                         "device's key of identity_triage.json")
    args = ap.parse_args(argv)
    dev = runtime.device(args.device)
    report = triage(dev.type, None if args.update else args.case)
    if args.update:
        with open(KEY_FILE) as fp:
            stored = json.load(fp)
        stored.setdefault(dev.type, {})["triage_at1"] = report
        with open(KEY_FILE, "w") as fp:
            json.dump(stored, fp, indent=1)
            fp.write("\n")
        print(f"updated {KEY_FILE} [{dev.type}] triage_at1")
    if args.json:
        with open(args.json, "w") as fp:
            json.dump(report, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
