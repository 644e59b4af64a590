"""Byte-identity guard over every key mode of the three encoders.

    python -m atracdenc_tpu_torch.selfcheck [--update] [--platform-key KEY]
        [--device cpu]

The counterpart of ``tools/selfcheck.py`` (the JAX package).  It encodes a
small deterministic corpus (``corpus``: seed 7, 4 streams x 2 ch x 65,536
samples, a 997 Hz and a 3001 Hz tone with a 7 kHz attack at the midpoint,
plus noise) in five modes and compares the SHA-256 of each mode's bytes
(first 32 hex digits) against ``selfcheck_hashes.json`` beside this file,
which holds one key per platform in the JAX file's layout (``{platform:
{mode: hash}}``):

* ``at3_full``  ATRAC3 LP2 384 B, gain control and tonal components on;
* ``at3_plain`` ATRAC3 LP2 384 B, both off;
* ``at3_js``    ATRAC3 LP4 192 B joint stereo, gain control and tonal on;
  the three through ``encode_frames_bytes`` (encode + device packer) on the
  whole [4, 2, T] batch (the stream axis replaces the JAX tool's ``vmap``);
* ``at1``       stream 0 through the ATRAC1 encoder, merged per frame and
  packed by ``frame.pack``;
* ``at3p``      stream 0 through the ATRAC3+ ``encode_track`` (GHA mask 7)
  and ``frame.pack``.

A hash that changes means the bitstream changed: re-run the golden suites
before taking a new key with ``--update``.  Hashes are device-specific
(float knife edges differ between cuBLAS and the CPU), so the default key is
the device type: ``cuda``, or ``cpu`` with ``--device cpu``.

Exit codes, as the JAX tool's: 0 every mode equal, 1 a mode differs (one
``MISMATCH`` line per mode), 2 no stored key for the platform.  Without a
card and without ``--device cpu`` it exits non-zero with
``runtime.device``'s message: there is no CPU fallback.
"""
import argparse
import hashlib
import json
import os
import sys

import numpy as np

from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.models.atrac1 import device_pack as at1_pack
from atracdenc_tpu_torch.models.atrac1 import encoder as at1_encoder
from atracdenc_tpu_torch.models.atrac1 import frame as at1_frame
from atracdenc_tpu_torch.models.atrac3 import encoder as at3_encoder
from atracdenc_tpu_torch.models.atrac3p import encoder as at3p_encoder
from atracdenc_tpu_torch.models.atrac3p import frame as at3p_frame

HASH_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "selfcheck_hashes.json")
MODES = ("at3_full", "at3_plain", "at3_js", "at1", "at3p")
AT3_MODES = {
    "at3_full": dict(frame_bytes=384, js=False, no_gain_control=False,
                     no_tonal=False),
    "at3_plain": dict(frame_bytes=384, js=False, no_gain_control=True,
                      no_tonal=True),
    "at3_js": dict(frame_bytes=192, js=True, no_gain_control=False,
                   no_tonal=False),
}


def corpus(streams=4, channels=2, seconds=1.5):
    """tools/selfcheck.py's corpus: [streams, channels, T] f32, T = 1.5 s
    cut to a multiple of 2048 (65,536)."""
    t = int(44100 * seconds)
    t -= t % 2048
    rng = np.random.default_rng(7)
    n = np.arange(t, dtype=np.float64)
    base = (0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
            + 0.1 * np.sin(2 * np.pi * 3001.0 * n / 44100.0))
    # an attack transient so gain control has real work
    base[t // 2: t // 2 + 2000] += 0.4 * np.sin(
        2 * np.pi * 7000.0 * n[:2000] / 44100.0)
    return np.clip(base[None, None, :] * np.asarray([1.0, 0.8])[None, :, None]
                   + 0.05 * rng.standard_normal((streams, channels, t)),
                   -1, 1).astype(np.float32)


def compute(device=None, modes=None):
    """{mode: frame bytes as a numpy uint8 array} of ``modes`` (all five by
    default) on ``device`` (CUDA unless "cpu").  The ATRAC3 modes are [4, F,
    frame_bytes], the others stream 0's frames."""
    dev = runtime.device(device)
    pcm = corpus()
    modes = MODES if modes is None else modes
    t = pcm.shape[-1]
    out = {}
    for name in modes:
        if name in AT3_MODES:
            x3 = runtime.to_torch(pcm[..., :t - t % 1024], dev)
            out[name] = runtime.to_numpy(
                at3_encoder.encode_frames_bytes(x3, **AT3_MODES[name]))
        elif name == "at1":
            x1 = runtime.to_torch(pcm[0][:, :t - t % 512], dev)
            planes = runtime.state_to_numpy(at1_encoder.encode_frames(x1))
            out[name] = at1_frame.pack(at1_pack.merge_channels(planes))
        elif name == "at3p":
            planes = at3p_encoder.encode_track(pcm[0][:, :t - t % 2048],
                                               device=dev.type)
            out[name] = at3p_frame.pack(planes, pcm.shape[1])
        else:
            raise ValueError(f"unknown mode {name!r}; modes are {MODES}")
    return out


def digest(frames):
    """The JAX tool's hash: SHA-256 of the bytes, first 32 hex digits."""
    return hashlib.sha256(np.asarray(frames).tobytes()).hexdigest()[:32]


def compute_hashes(device=None, modes=None):
    return {k: digest(v) for k, v in compute(device, modes).items()}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m atracdenc_tpu_torch.selfcheck",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--update", action="store_true",
                   help="store this run's hashes under the platform key")
    p.add_argument("--platform-key", default=None,
                   help="key in the hash file (default: the device type)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (default; no fallback) or cpu (plain versions)")
    args = p.parse_args(argv)
    dev = runtime.device(args.device)
    plat = args.platform_key or dev.type
    got = compute_hashes(dev)

    stored = {}
    if os.path.exists(HASH_FILE):
        with open(HASH_FILE) as fp:
            stored = json.load(fp)
    if args.update:
        stored[plat] = got
        with open(HASH_FILE, "w") as fp:
            json.dump(stored, fp, indent=1)
            fp.write("\n")
        print(f"updated {HASH_FILE} [{plat}]: {json.dumps(got, indent=1)}")
        return 0
    want = stored.get(plat)
    if want is None:
        print(f"no stored hashes for platform {plat}; run --update first")
        return 2
    bad = {k: (want.get(k), v) for k, v in got.items() if want.get(k) != v}
    for k, (w, g) in bad.items():
        print(f"MISMATCH {k}: want {w} got {g}")
    if bad:
        return 1
    print(f"selfcheck OK [{plat}]: {len(got)} modes byte-identical: "
          f"{json.dumps(got)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
