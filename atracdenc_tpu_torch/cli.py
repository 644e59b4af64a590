"""Command-line driver of the PyTorch port (ATRAC3 encode).

    python -m atracdenc_tpu_torch.cli -e atrac3 [--bitrate N]
        [--nogaincontrol] [--notonal] [--bfuidxconst N]
        -i in.wav -o out.{oma,at3,wav,rm}

Takes the ATRAC3 options of ``atracdenc_tpu/cli.py``.  The other codecs,
decoding, ``--exact`` and ``--yaml-log`` are not ported yet and exit 1.
``--device cpu`` runs the kernels' plain versions (for tests); the
default is CUDA.
"""
import argparse
import os
import sys

CODECS = ("atrac1", "atrac3", "atrac3_lp4", "atrac3plus")
_PORTED = ("atrac3", "atrac3_lp4")
_CONTAINERS = {"oma", "riff", "rm", "raw"}
_EXT_CONTAINER = {".aea": "aea", ".oma": "oma", ".aa3": "oma", ".at3": "riff",
                  ".wav": "riff", ".rm": "rm"}


def build_parser():
    p = argparse.ArgumentParser(
        prog="atracdenc-tpu-torch",
        description="ATRAC3 encoder on PyTorch / CUDA")
    p.add_argument("-e", "--encode", nargs="?", const="atrac1", metavar="codec",
                   help="encode mode; codec: atrac3 or atrac3_lp4 "
                        "(atrac1 and atrac3plus are not ported yet)")
    p.add_argument("-d", "--decode", action="store_true",
                   help="decode mode (not ported yet)")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("--bitrate", type=int, default=0, help="kbit/s (ATRAC3)")
    p.add_argument("--container", choices=("aea", "oma", "riff", "rm", "raw"))
    p.add_argument("--bfuidxconst", type=int, default=0)
    p.add_argument("--nostdout", action="store_true")
    p.add_argument("--notonal", action="store_true")
    p.add_argument("--nogaincontrol", action="store_true")
    p.add_argument("--exact", action="store_true", help="not ported yet")
    p.add_argument("--yaml-log", dest="yaml_log", help="not ported yet")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if bool(args.encode) == bool(args.decode):
        sys.exit("Select mode: encode or decode")
    if args.decode:
        sys.exit("Decoding is not ported to atracdenc_tpu_torch yet; "
                 "use atracdenc_tpu.cli")
    if args.encode not in CODECS:
        sys.exit(f"Unknown codec: {args.encode}")
    if args.encode not in _PORTED:
        sys.exit(f"{args.encode} is not ported to atracdenc_tpu_torch yet; "
                 "use atracdenc_tpu.cli")
    if args.exact or args.yaml_log:
        sys.exit("--exact and --yaml-log are not ported to "
                 "atracdenc_tpu_torch yet; use atracdenc_tpu.cli")
    ext = os.path.splitext(args.outfile)[1].lower()
    container = args.container or _EXT_CONTAINER.get(ext, "oma")
    if container not in _CONTAINERS:
        sys.exit(f"Container '{container}' is not supported for {args.encode}")
    args.container = container

    from atracdenc_tpu_torch.models.atrac3.cli_glue import encode_file
    try:
        encode_file(args, lp4=args.encode == "atrac3_lp4")
    except OSError as err:
        sys.exit(f"IO fatal error: {err}")


if __name__ == "__main__":
    main()
