"""Command-line entry point of the PyTorch port (ATRAC1, ATRAC3 and ATRAC3+
encode and decode).

    python -m atracdenc_tpu_torch.cli -e atrac1 [--bfuidxconst N]
        [--notransient[=mask]] [--exact] -i in.wav -o out.{aea,raw}
    python -m atracdenc_tpu_torch.cli -e atrac3 [--bitrate N]
        [--nogaincontrol] [--notonal] [--bfuidxconst N] [--exact]
        [--yaml-log log.yaml] -i in.wav -o out.{oma,at3,wav,rm}
    python -m atracdenc_tpu_torch.cli -e atrac3plus
        [--advanced ghadbg=MASK,ghawbrefine=MODE] -i in.wav
        -o out.{oma,at3,wav,raw}
    python -m atracdenc_tpu_torch.cli -d -i in.{aea,oma,at3,rm} -o out.wav

Takes the options of ``atracdenc_tpu/cli.py`` (``--bfuidxfast`` is a
deprecated no-op there and here; ``--advanced`` sets ATRAC3+'s GHA options
and is ignored by the other codecs).  ``--device cpu`` runs the kernels'
plain versions (for tests); the default is CUDA.  ATRAC1 decodes with the
exact-semantics decoder on the host, as the JAX CLI does; ATRAC3 and
ATRAC3+ decode with the QA decoders, whose transforms run on ``--device``.
"""
import argparse
import os
import sys

CODECS = ("atrac1", "atrac3", "atrac3_lp4", "atrac3plus")
# codec -> allowed containers (reference main.cpp:168-194)
_CONTAINERS = {"atrac1": {"aea", "raw"},
               "atrac3": {"oma", "riff", "rm", "raw"},
               "atrac3_lp4": {"oma", "riff", "rm", "raw"},
               "atrac3plus": {"oma", "riff", "raw"}}
_EXT_CONTAINER = {".aea": "aea", ".oma": "oma", ".aa3": "oma", ".at3": "riff",
                  ".wav": "riff", ".rm": "rm"}


def build_parser():
    p = argparse.ArgumentParser(
        prog="atracdenc-tpu-torch",
        description="ATRAC1 / ATRAC3 / ATRAC3+ codec on PyTorch / CUDA")
    p.add_argument("-e", "--encode", nargs="?", const="atrac1", metavar="codec",
                   help="encode mode; codec: atrac1 (default), atrac3, "
                        "atrac3_lp4 or atrac3plus")
    p.add_argument("-d", "--decode", action="store_true",
                   help="decode mode (AEA: ATRAC1; OMA / RIFF: ATRAC3 or "
                        "ATRAC3+; RM: ATRAC3)")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("--bitrate", type=int, default=0, help="kbit/s (ATRAC3)")
    p.add_argument("--container", choices=("aea", "oma", "riff", "rm", "raw"))
    p.add_argument("--bfuidxconst", type=int, default=0)
    p.add_argument("--bfuidxfast", action="store_true",
                   help="deprecated no-op (kept for reference CLI parity, "
                        "main.cpp:565-567)")
    p.add_argument("--notransient", nargs="?", const="", metavar="mask")
    p.add_argument("--nostdout", action="store_true")
    p.add_argument("--notonal", action="store_true")
    p.add_argument("--nogaincontrol", action="store_true")
    p.add_argument("--advanced", default="",
                   help="ATRAC3+ encode: ghadbg=MASK (0..15), "
                        "ghawbrefine=MODE (0=subband, 1=raw); other codecs "
                        "ignore it")
    p.add_argument("--exact", action="store_true",
                   help="ATRAC1/ATRAC3 encode: the reference-float-semantics "
                        "host path (byte-identical to the reference binary)")
    p.add_argument("--yaml-log", dest="yaml_log",
                   help="ATRAC3 encode: write the gain-control decisions of "
                        "every frame to this YAML file")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p


def _split_channel_planes(planes, channels):
    """Stream order [F*C, ...] -> [C, F, ...] (drops ``valid``)."""
    return {k: v.reshape((v.shape[0] // channels, channels) + v.shape[1:])
            .swapaxes(0, 1) for k, v in planes.items() if k != "valid"}


def encode_atrac1(args):
    from atracdenc_tpu_torch.containers import aea, raw
    from atracdenc_tpu_torch.io import audio
    from atracdenc_tpu_torch.models.atrac1 import device_pack as at1_pack
    from atracdenc_tpu_torch.models.atrac1 import exact_enc as at1_exact_enc
    from atracdenc_tpu_torch.models.atrac1 import frame as at1_frame
    from atracdenc_tpu_torch.utils import operator_log, progress

    pcm, rate = audio.read(args.infile)
    if rate != 44100:
        sys.exit("Unsupported sample rate. Only 44100Hz is supported now")
    channels, total = pcm.shape
    if args.bfuidxconst and not (1 <= args.bfuidxconst <= 8):
        sys.exit("Wrong bfuidxconst value (1...8)")
    window_mode, window_mask = "auto", 0
    if args.notransient is not None:
        window_mode = "fixed"
        window_mask = int(args.notransient) if args.notransient else 0
    on_progress = None
    if not args.nostdout:
        print(f"Input file: {args.infile}\n Channels: {channels}\n "
              f"SampleRate: {rate}\n Duration (sec): {total // rate}")
        on_progress = progress.print_progress

    opts = dict(bfu_idx_const=args.bfuidxconst, window_mode=window_mode,
                window_mask=window_mask)
    if args.exact:
        planes = at1_exact_enc.encode_track_exact(pcm, **opts)
    else:
        from atracdenc_tpu_torch.models.atrac1.encoder import encode_track
        planes = encode_track(pcm, progress=on_progress, device=args.device,
                              **opts)
        operator_log.warn_clipping(planes, pop=True)
    frames = at1_frame.pack(at1_pack.merge_channels(planes))
    if args.container == "aea":
        aea.write(args.outfile, frames, channels, total)
    else:
        raw.write(args.outfile, frames)


def decode_atrac1(args):
    from atracdenc_tpu_torch.containers import aea
    from atracdenc_tpu_torch.io import audio
    from atracdenc_tpu_torch.models.atrac1 import frame as at1_frame
    from atracdenc_tpu_torch.models.atrac1.decoder import decode_track

    frames, channels, title, length = aea.read(args.infile)
    if not args.nostdout:
        print(f"Input file: {args.infile}\n Name: {title}\n Channels: {channels}")
    n = (frames.shape[0] // channels) * channels
    pcm = decode_track(_split_channel_planes(at1_frame.unpack(frames[:n]),
                                             channels))
    if length:
        pcm = pcm[:, :length]
    audio.write(args.outfile, pcm, 44100)


def decode_atrac3_family(args, container):
    """Decode an OMA / RIFF / RealMedia ATRAC3 or ATRAC3+ file to PCM
    (beyond the reference, whose decode mode is ATRAC1-only)."""
    from atracdenc_tpu_torch.containers import at3, oma, rm
    from atracdenc_tpu_torch.io import audio

    if container == "oma":
        frames, info = oma.read(args.infile)
        codec = ("atrac3" if info["codec"] == oma.CODEC_ATRAC3
                 else "atrac3plus")
    elif container == "riff":
        frames, info = at3.read(args.infile)
        codec = info["codec"]
    else:
        frames, info = rm.read(args.infile)
        codec = "atrac3"
    channels = info["channels"]
    if not args.nostdout:
        print(f"Input file: {args.infile}\n Codec: {codec}\n "
              f"Channels: {channels}\n FrameSz: {info['frame_size']}")
    if codec == "atrac3":
        from atracdenc_tpu_torch.models.atrac3.decoder import decode_track
        pcm = decode_track(frames, channels=channels,
                           js=info.get("joint_stereo", False),
                           device=args.device)
    else:
        from atracdenc_tpu_torch.models.atrac3p.decoder import decode_track
        pcm = decode_track(frames, channels, device=args.device)
    total = info.get("total_samples", 0)
    if total:
        pcm = pcm[:, :total]
    audio.write(args.outfile, pcm, 44100)


def _dispatch(args):
    if args.decode:
        # dispatch by content magic, as atracdenc_tpu/cli.py does
        with open(args.infile, "rb") as fp:
            magic = fp.read(4)
        if magic[:3] in (b"ea3", b"EA3"):
            decode_atrac3_family(args, "oma")
        elif magic == b"RIFF":
            decode_atrac3_family(args, "riff")
        elif magic == b".RMF":
            decode_atrac3_family(args, "rm")
        else:
            decode_atrac1(args)
        return
    codec = args.encode
    if codec not in CODECS:
        sys.exit(f"Unknown codec: {codec}")
    ext = os.path.splitext(args.outfile)[1].lower()
    default = "aea" if codec == "atrac1" else "oma"
    container = args.container or _EXT_CONTAINER.get(ext, default)
    if container not in _CONTAINERS[codec]:
        sys.exit(f"Container '{container}' is not supported for {codec}")
    args.container = container
    if codec == "atrac1":
        encode_atrac1(args)
    elif codec == "atrac3plus":
        from atracdenc_tpu_torch.models.atrac3p.cli_glue import encode_file
        encode_file(args)
    else:
        from atracdenc_tpu_torch.models.atrac3.cli_glue import encode_file
        encode_file(args, lp4=codec == "atrac3_lp4")


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.bfuidxfast:
        print("--bfuidxfast option is deprecated and will be removed.")
    if bool(args.encode) == bool(args.decode):
        sys.exit("Select mode: encode or decode")
    try:
        _dispatch(args)
    except OSError as err:
        # reference: "Aea IO fatal error" / typed IO exceptions
        # (main.cpp:709-713)
        sys.exit(f"IO fatal error: {err}")
    except Exception as err:  # noqa: BLE001 — the reference's main catches
        # every std::exception (main.cpp:717-720): corrupt input fails with
        # a message, not a traceback (SystemExit is no Exception: it passes)
        sys.exit(f"Encode/Decode error: {str(err) or type(err).__name__}")


if __name__ == "__main__":
    main()
