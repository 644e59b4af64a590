"""Byte identity of the ATRAC3 encoder against the reference's golden frames.

    python -m atracdenc_tpu_torch.golden_check [--json OUT] [--diff]
        [--device cpu]

The counterpart of ``tools/golden_check.py`` (the JAX package).  Each of
the seven ``CASES`` loads PCM and the reference encoder's frames from
``tests/golden/*.npz``, encodes the PCM with the port's ``encode_track`` on
the device, packs it with the host packer ``frame.pack`` and prints the
byte identity and the count of identical frames; ``--diff`` adds the first
differing byte of each frame that differs.  The golden frames are the
input of divergence triage (``triage_at3``, ``triage_gain``).

The device is CUDA unless ``--device cpu`` is given: without a card the
tool exits non-zero with ``runtime.device``'s message (no CPU fallback).
"""
import argparse
import json
import os
import sys

import numpy as np

from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.models.atrac3 import encoder, frame

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests", "golden")

CASES = [
    # (name, npz, pcm key, ref key, encode kwargs)
    ("plain", "at3_golden.npz", "pcm_in", "ref_frames",
     dict(frame_bytes=384)),
    ("default", "at3_default_golden.npz", "pcm_in", "ref_frames",
     dict(frame_bytes=384, no_gain_control=False, no_tonal=False)),
    ("default_stress", "at3_default_golden.npz", "pcm_stress", "ref_stress",
     dict(frame_bytes=384, no_gain_control=False, no_tonal=False)),
    ("tonal", "at3_tonal_golden.npz", "pcm_in", "ref_frames",
     dict(frame_bytes=384, no_tonal=False)),
    ("tonal_dense", "at3_tonal_dense_golden.npz", "pcm_in", "ref_frames",
     dict(frame_bytes=384, no_tonal=False)),
    ("js", "at3_js_golden.npz", "pcm_in", "ref_frames",
     dict(frame_bytes=192, js=True, no_gain_control=False, no_tonal=False)),
    ("js_mono", "at3_js_golden.npz", "pcm_mono", "ref_mono",
     dict(frame_bytes=192, js=True, no_gain_control=False, no_tonal=False)),
]


def case(name):
    """The ``CASES`` tuple called ``name``."""
    for c in CASES:
        if c[0] == name:
            return c
    raise ValueError(f"unknown case {name!r}; cases are "
                     f"{[c[0] for c in CASES]}")


def load(c):
    """(pcm, reference frames) of a ``CASES`` tuple."""
    _, npz, pk, rk, _ = c
    d = np.load(os.path.join(GOLDEN, npz))
    return d[pk], d[rk]


def encode_case(c, device):
    """The port's frames [F, frame_bytes] uint8 for a ``CASES`` tuple:
    ``encode_track`` on ``device``, then ``frame.pack``."""
    kw = c[4]
    pcm, _ = load(c)
    planes = encoder.encode_track(pcm, device=device, **kw)
    return frame.pack(planes, kw["frame_bytes"], js=kw.get("js", False))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m atracdenc_tpu_torch.golden_check",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=None, help="write the report here")
    ap.add_argument("--diff", action="store_true",
                    help="print first diverging byte per non-identical frame")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda (default; no fallback) or cpu (plain versions)")
    args = ap.parse_args(argv)
    dev = runtime.device(args.device)

    report = {}
    total_ok = total = 0
    for c in CASES:
        name = c[0]
        _, ref = load(c)
        ours = encode_case(c, dev.type)
        assert ours.shape == ref.shape, (name, ours.shape, ref.shape)
        eq = ours == ref
        ident = float(eq.mean())
        frames_ok = int(eq.all(axis=1).sum())
        report[name] = {"byte_identity": round(ident, 6),
                        "frames_identical": f"{frames_ok}/{ref.shape[0]}"}
        total_ok += eq.sum()
        total += eq.size
        print(f"{name:16s} bytes {ident*100:8.4f}%   frames "
              f"{frames_ok}/{ref.shape[0]}")
        if args.diff and frames_ok < ref.shape[0]:
            for f in np.nonzero(~eq.all(axis=1))[0]:
                b = int(np.nonzero(ours[f] != ref[f])[0][0])
                print(f"  frame {f}: first diff at byte {b} "
                      f"(ours {ours[f, b]:02x} ref {ref[f, b]:02x})")
    print(f"{'TOTAL':16s} bytes {100.0 * total_ok / total:8.4f}%")
    report["total"] = round(float(total_ok / total), 6)
    if args.json:
        with open(args.json, "w") as fp:
            json.dump(report, fp, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
