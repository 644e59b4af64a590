"""Root cause of each gain-plane divergence from the reference's frames.

    python -m atracdenc_tpu_torch.triage_gain [--case default_stress|js_mono]
        [--json OUT] [--device cpu]

The counterpart of ``tools/triage_gain.py`` (the JAX package).  For each
(frame, channel, band) whose gain curve differs from the reference
bitstream's, it separates the two possible causes:

  logic — the port's batched gain curves (``models/atrac3/gain.py``)
          make a different decision than the reference's CalcCurve /
          CreateSubbandInfo on the SAME analysis values;
  noise — the curve logic is faithful, but float noise upstream (the QMF
          and the upsampler's matmuls against the reference's scalar FIR
          and kissfft) crosses a hard threshold.

Three curve sets per (frame, ch, band):

  A = the port's curves (parsed back from its frames);
  D = the op-exact oracle (``exact_gain.create_subband_info``, reference
      float semantics op for op) replayed over the band samples that the
      port's ``band_frames`` gives on the device under test;
  C = the same oracle over the exact path's band samples: the reference
      bitstream's curves by construction.

  A == D != C  ->  ``noise`` at a knife edge;
  A != D       ->  ``LOGIC``, a fault of the port's gain curves (``drain``
                   when it is the track's last frame, whose lookahead the
                   reference takes from a stale buffer).

The device is CUDA unless ``--device cpu`` is given (no CPU fallback).
"""
import argparse
import json
import sys

import numpy as np
import torch

from atracdenc_tpu_torch import golden_check, runtime
from atracdenc_tpu_torch.models.atrac3 import encoder, exact_gain, frame
from atracdenc_tpu_torch.models.atrac3.exact_enc import _analysis_tree

f32 = np.float32

CASES = {
    "default_stress": ("at3_default_golden.npz", "pcm_stress", "ref_stress",
                       dict(frame_bytes=384, no_gain_control=False,
                            no_tonal=False)),
    "js_mono": ("at3_js_golden.npz", "pcm_mono", "ref_mono",
                dict(frame_bytes=192, js=True, no_gain_control=False,
                     no_tonal=False)),
}


def curves_from_planes(p, ci, fi):
    """plane dict entry -> list of 4 [(level, loc)] lists."""
    out = []
    for band in range(4):
        n = int(p["gain_npoints"][ci, fi, band])
        out.append([(int(p["gain_levels"][ci, fi, band, k]),
                     int(p["gain_locs"][ci, fi, band, k]))
                    for k in range(n)])
    return out


def replay_oracle(bands_ext, nf):
    """Run the op-exact CreateSubbandInfo chain over [C, F+1, 4, 256] band
    samples; returns curves[c][f][band] point lists."""
    c = bands_ext.shape[0]
    ctxs = [[exact_gain.CurveCtx() for _ in range(4)] for _ in range(c)]
    curves = [[None] * nf for _ in range(c)]
    for fi in range(nf):
        for ci in range(c):
            ups = []
            for band in range(4):
                prev_tail = (bands_ext[ci, fi - 1, band, 128:] if fi > 0
                             else np.zeros(128, f32))
                nxt = bands_ext[ci, fi + 1, band, :128]
                ups.append(np.concatenate(
                    [prev_tail, bands_ext[ci, fi, band], nxt]))
            curves[ci][fi] = exact_gain.create_subband_info(ups, ctxs[ci])
    return curves


def fast_bands_ext(pcm, js, device=None):
    """The port's band samples on ``device`` (CUDA unless "cpu"), taken as
    ``encode_frames_chunk`` takes them (``band_frames`` behind one frame of
    zero history), and extended with its lookahead at track end (silence
    after the last frame: ``next_pcm=None``)."""
    dev = runtime.device(device)
    x = runtime.to_torch(np.atleast_2d(np.asarray(pcm, f32)), dev)
    ext = torch.cat([torch.zeros_like(x[:, :1024]), x], dim=-1)
    bands = runtime.to_numpy(encoder.band_frames(ext[None])[0, :, 1:])
    if js and bands.shape[0] == 2:
        # mono JS input has no side channel to matrix (encoder gate:
        # `if js and c == 2`, models/atrac3/encoder.py)
        bands = np.stack([(bands[0] + bands[1]) * f32(0.5),
                          (bands[0] - bands[1]) * f32(0.5)])
    c = bands.shape[0]
    return np.concatenate(
        [bands, np.zeros((c, 1, 4, 256), f32)], axis=1)


def exact_bands_ext(pcm, js):
    """The EXACT path's band samples incl. the reference drain-pass stale
    lookahead (exact_enc.encode_track_exact semantics)."""
    pcm = np.atleast_2d(np.asarray(pcm, f32))
    nf = pcm.shape[1] // 1024
    pcm4 = (pcm / f32(4.0)).astype(f32)
    if nf % 4 == 0 and nf >= 4:
        stale = pcm4[:, (nf - 4) * 1024: (nf - 3) * 1024]
    else:
        stale = np.zeros((pcm.shape[0], 1024), f32)
    ext = np.concatenate([pcm4, stale], axis=1)
    bands_ext = _analysis_tree(ext)
    if js and bands_ext.shape[0] == 2:
        bands_ext = np.stack([(bands_ext[0] + bands_ext[1]) * f32(0.5),
                              (bands_ext[0] - bands_ext[1]) * f32(0.5)])
    return bands_ext


def _pts(chplanes, band):
    """(level, loc) points of one band of a channel parsed by
    ``frame.unpack``."""
    return [(int(lv), int(lc)) for lv, lc in chplanes["gain"][band]]


def triage(name, device=None, log=print):
    """The report of case ``name`` on ``device``: one entry per divergent
    (frame, ch, band), as the JAX tool's ``--json``."""
    npz, pk, rk, kw = CASES[name]
    c_ = golden_check.case(name)
    assert c_[1:] == (npz, pk, rk, kw), (c_, CASES[name])
    pcm, ref = golden_check.load(c_)
    js = kw.get("js", False)
    dev = runtime.device(device)
    ours = golden_check.encode_case(c_, dev.type)
    nf = ref.shape[0]
    c = 1 if pcm.ndim == 1 or pcm.shape[0] == 1 else 2
    po = frame.unpack(ours, c, js=js)
    pr = frame.unpack(ref, c, js=js)

    log(f"case {name}: {nf} frames; replaying oracles ...")
    fb = fast_bands_ext(pcm, js, dev.type)
    eb = exact_bands_ext(pcm, js)
    curves_d = replay_oracle(fb, nf)
    curves_c = replay_oracle(eb, nf)

    report = []
    for fi in range(nf):
        for ci in range(c):
            for band in range(4):
                a = _pts(po[fi][ci], band)
                b = _pts(pr[fi][ci], band)
                if a == b:
                    continue
                dp = [(lv, lc) for lv, lc in curves_d[ci][fi][band]]
                cp = [(lv, lc) for lv, lc in curves_c[ci][fi][band]]
                cls = ("noise" if a == dp else
                       ("drain" if fi == nf - 1 else "LOGIC"))
                report.append({
                    "frame": fi, "ch": ci, "band": band, "class": cls,
                    "ours": a, "ref": b,
                    "oracle_on_fast_inputs": dp,
                    "oracle_on_exact_inputs": cp,
                    "oracle_matches_ref": cp == b,
                })
                log(f"f{fi:3d} ch{ci} band{band}: {cls:6s} "
                    f"A{a} B{b} D{dp} C{cp} C==B:{cp == b}")
    n_logic = sum(r["class"] == "LOGIC" for r in report)
    log(f"{len(report)} divergent (frame,ch,band) entries; "
        f"{n_logic} unexplained-logic")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m atracdenc_tpu_torch.triage_gain",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default="default_stress", choices=CASES)
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (default; no fallback) or cpu (plain versions)")
    args = ap.parse_args(argv)
    report = triage(args.case, args.device)
    if args.json:
        with open(args.json, "w") as fp:
            json.dump(report, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
