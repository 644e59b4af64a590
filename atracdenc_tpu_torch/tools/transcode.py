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


def _codecs(args):
    """The transcoder's table: codec -> (its ``encode_track``, the options
    it takes, the device packer (planes on the card, channels -> frame
    bytes), the container writer (path, frames, PCM [C, T]), the output's
    extension)."""
    from atracdenc_tpu_torch.containers import aea, oma
    from atracdenc_tpu_torch.models.atrac1 import device_pack as pack1
    from atracdenc_tpu_torch.models.atrac1 import encoder as enc1
    from atracdenc_tpu_torch.models.atrac3 import device_pack as pack3
    from atracdenc_tpu_torch.models.atrac3 import encoder as enc3
    from atracdenc_tpu_torch.models.atrac3 import tables as T3
    from atracdenc_tpu_torch.models.atrac3p import device_pack as pack3p
    from atracdenc_tpu_torch.models.atrac3p import encoder as enc3p
    from atracdenc_tpu_torch.models.atrac3p import tables as TP
    _, fsz, js = T3.container_params_for_bitrate(args.bitrate * 1024)
    return {
        "atrac1": (
            enc1.encode_track, {},
            lambda planes, c: pack1.pack_device(pack1.merge_channels(planes)),
            lambda path, frames, pcm: aea.write(path, frames, pcm.shape[0],
                                                pcm.shape[1]),
            ".aea"),
        "atrac3": (
            enc3.encode_track,
            dict(frame_bytes=fsz, js=js, no_gain_control=False,
                 no_tonal=False, chunk_frames=args.chunk_frames),
            lambda planes, c: pack3.pack_device(planes, fsz, js=js),
            lambda path, frames, pcm: oma.write(
                path, frames, oma.CODEC_ATRAC3, fsz, channels=pcm.shape[0],
                joint_stereo=js),
            ".oma"),
        "atrac3plus": (
            enc3p.encode_track, {}, pack3p.pack_device,
            lambda path, frames, pcm: oma.write(
                path, frames, oma.CODEC_ATRAC3PLUS, TP.FRAME_BYTES,
                channels=pcm.shape[0]),
            ".oma"),
    }


def _transcode(codec, dev, pcm, out):
    """Encode, pack and write one file's PCM [C, T] with the table row
    ``codec`` (the spans ``encode``, ``pack`` and ``write``)."""
    from atracdenc_tpu_torch import runtime, trace
    encode_track, opts, pack, write, _ = codec
    with trace.span("encode"):
        planes = encode_track(pcm, device=dev, **opts)
    with trace.span("pack"):
        frames = runtime.to_numpy(pack(runtime.state_from_numpy(planes, dev),
                                       pcm.shape[0]))
    with trace.span("write"):
        write(out + ".tmp", frames, pcm)
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

    codec = _codecs(args)[args.codec]
    t0 = time.perf_counter()
    total_samples = 0
    for path in args.inputs:
        name = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.out_dir, name + codec[-1])
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
            _transcode(codec, dev, pcm, out)
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
