"""Batch corpus transcoder: encode many WAV files in one process.

Port of ``atracdenc_tpu/tools/transcode.py``: the same options, messages,
``--resume`` skip and atomic outputs (a ``.tmp`` file, then
``os.replace``).  Tracks encode in exact chunks, and frame serialisation
runs on the device (``models/*/device_pack.py``), so only the frame bytes
leave it; the host writes the container headers.

    python -m atracdenc_tpu_torch.tools.transcode --codec atrac3 --out-dir enc/ *.wav

``--device cpu`` runs the kernels' plain versions; the default is CUDA.
``--trace PATH`` switches the port's tracer on (``trace.py``): one span a
file (``file``, with ``read``, ``encode``, ``pack`` and ``write`` under it,
the encoder's chunk spans under ``encode``), written to PATH as a Chrome
trace at the end; the last line then gives each child's share of the
files' time.
``--hosts N --host-id K --coordinator H:P`` joins a process group of N
processes (``parallel/distributed.py``), and each encodes its round-robin
share of the inputs: tracks are independent, so nothing else crosses
processes.  ``--local-devices N`` is kept so that the JAX package's command
lines run unchanged; there it forces an N-device virtual CPU mesh, and its
nearest meaning here is a rehearsal without the card: the CPU device and
the gloo backend.  It is an error together with ``--device cuda``.
"""
import argparse
import os
import sys
import time

import numpy as np


def _transcode(args, dev, pcm, out):
    """Encode, pack and write one file's PCM [C, T] (the spans ``encode``,
    ``pack`` and ``write``)."""
    from atracdenc_tpu_torch import runtime, trace
    from atracdenc_tpu_torch.containers import aea, oma
    channels = pcm.shape[0]
    if args.codec == "atrac1":
        from atracdenc_tpu_torch.models.atrac1.device_pack import pack_device
        from atracdenc_tpu_torch.models.atrac1.encoder import encode_track
        with trace.span("encode"):
            planes = encode_track(pcm, device=dev)
        with trace.span("pack"):
            merged = {k: runtime.to_torch(np.swapaxes(v, 0, 1).reshape(
                (-1,) + v.shape[2:]), dev) for k, v in planes.items()}
            frames = runtime.to_numpy(pack_device(merged))
        with trace.span("write"):
            aea.write(out + ".tmp", frames, channels, pcm.shape[1])
            os.replace(out + ".tmp", out)
    elif args.codec == "atrac3":
        from atracdenc_tpu_torch.models.atrac3 import tables as T3
        from atracdenc_tpu_torch.models.atrac3.device_pack import pack_device
        from atracdenc_tpu_torch.models.atrac3.encoder import encode_track
        _, fsz, js = T3.container_params_for_bitrate(args.bitrate * 1024)
        with trace.span("encode"):
            planes = encode_track(pcm, frame_bytes=fsz, js=js,
                                  no_gain_control=False, no_tonal=False,
                                  chunk_frames=args.chunk_frames, device=dev)
        with trace.span("pack"):
            frames = runtime.to_numpy(pack_device(
                {k: runtime.to_torch(v, dev) for k, v in planes.items()},
                fsz, js=js))
        with trace.span("write"):
            oma.write(out + ".tmp", frames, oma.CODEC_ATRAC3, fsz,
                      channels=channels, joint_stereo=js)
            os.replace(out + ".tmp", out)
    else:
        from atracdenc_tpu_torch.models.atrac3p import tables as TP
        from atracdenc_tpu_torch.models.atrac3p.device_pack import pack_device
        from atracdenc_tpu_torch.models.atrac3p.encoder import encode_track
        with trace.span("encode"):
            planes = encode_track(pcm, device=dev)
        with trace.span("pack"):
            dev_planes = {k: ({kk: runtime.to_torch(vv, dev)
                                   for kk, vv in v.items()}
                              if isinstance(v, dict)
                              else runtime.to_torch(v, dev))
                          for k, v in planes.items()}
            frames = runtime.to_numpy(pack_device(dev_planes, channels))
        with trace.span("write"):
            oma.write(out + ".tmp", frames, oma.CODEC_ATRAC3PLUS,
                      TP.FRAME_BYTES, channels=channels)
            os.replace(out + ".tmp", out)


def _shares(records):
    """The last line's tail: each of a file's children (``read``,
    ``encode``, ``pack``, ``write``) as a share of the files' host time."""
    files = {r["id"] for r in records if r["name"] == "file"}
    total = sum(r["host"][1] - r["host"][0] for r in records
                if r["id"] in files)
    if not total:
        return ""
    parts = []
    for name in ("read", "encode", "pack", "write"):
        ns = sum(r["host"][1] - r["host"][0] for r in records
                 if r["name"] == name and r["parent"] in files)
        parts.append(f"{name} {100.0 * ns / total:.1f}%")
    return "; " + ", ".join(parts)


def main(argv=None):
    p = argparse.ArgumentParser(prog="atracdenc-tpu-torch-transcode")
    p.add_argument("inputs", nargs="+", help="44.1 kHz/16-bit WAV files")
    p.add_argument("--codec", choices=("atrac1", "atrac3", "atrac3plus"),
                   default="atrac3")
    p.add_argument("--bitrate", type=int, default=0)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--chunk-frames", type=int, default=512)
    p.add_argument("--resume", action="store_true",
                   help="skip inputs whose output already exists (outputs "
                        "are written atomically via a temp file, so an "
                        "interrupted run never leaves a partial container)")
    p.add_argument("--hosts", type=int, default=1,
                   help="number of cooperating processes (tracks are "
                        "independent, so each host encodes its round-robin "
                        "share)")
    p.add_argument("--host-id", type=int, default=0)
    p.add_argument("--coordinator", default="127.0.0.1:12321",
                   help="torch.distributed rendezvous address (host 0)")
    p.add_argument("--local-devices", type=int, default=None,
                   help="rehearse without the card: the CPU device and the "
                        "gloo backend (the JAX package's virtual CPU mesh)")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="cuda (default) or cpu (the kernels' plain versions)")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="trace every file's read, encode, pack and write; "
                        "write the spans to PATH as a Chrome trace")
    args = p.parse_args(argv)
    if args.local_devices and args.device == "cuda":
        p.error("--local-devices rehearses on the CPU; it cannot be combined "
                "with --device cuda")

    from atracdenc_tpu_torch.parallel import distributed as D
    dev = D.initialize(args.coordinator, args.hosts, args.host_id,
                       local_devices=args.local_devices, device=args.device)
    args.inputs = D.corpus_shard(args.inputs, args.host_id, args.hosts)

    from atracdenc_tpu_torch import trace
    from atracdenc_tpu_torch.io import audio
    os.makedirs(args.out_dir, exist_ok=True)
    if args.trace:
        trace.enable(cuda=dev.type == "cuda")

    t0 = time.perf_counter()
    total_samples = 0
    for path in args.inputs:
        name = os.path.splitext(os.path.basename(path))[0]
        ext = ".aea" if args.codec == "atrac1" else ".oma"
        out = os.path.join(args.out_dir, name + ext)
        if args.resume and os.path.exists(out):
            print(f"skip {path}: {out} exists")
            continue
        with trace.span("file"):
            with trace.span("read"):
                pcm, rate = audio.read(path)
            if rate != 44100:
                print(f"skip {path}: unsupported sample rate {rate}",
                      file=sys.stderr)
                continue
            total_samples += pcm.shape[1]
            _transcode(args, dev, pcm, out)
        print(f"{path} -> {out}")

    dt = time.perf_counter() - t0
    if total_samples:
        shares = ""
        if args.trace:
            trace.disable()
            trace.write_chrome(args.trace)
            shares = _shares(trace.snapshot()["records"])
        print(f"{len(args.inputs)} files, {total_samples / 44100:.1f}s of "
              f"audio in {dt:.1f}s ({total_samples / 44100 / dt:.1f}x "
              f"realtime){shares}")
    D.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
