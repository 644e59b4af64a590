"""File-level ATRAC3+ encode for the port's CLI.

Mirrors ``atracdenc_tpu/models/atrac3p/cli_glue.py::encode_file``
(reference PrepareAtrac3PEncoder, src/main.cpp:427-483): fixed 2048-byte
frames at 352.8 kbit/s, OMA / RIFF / RAW containers, ``--advanced
ghadbg=MASK,ghawbrefine=MODE``.  The frames are serialised by the device
packer, as the JAX CLI does.
"""
import sys

from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.containers import at3, oma, raw
from atracdenc_tpu_torch.io import audio
from atracdenc_tpu_torch.utils import progress
from . import tables as T
from .device_pack import pack_device
from .encoder import encode_track


def parse_advanced(advanced):
    """--advanced ghadbg=MASK / ghawbrefine=MODE (reference
    TAt3PEnc::ParseAdvancedOpt + SetGha / SetWidebandRefine,
    at3p.cpp:195-284) -> (use_gha, wb_refine); mask bits: 1=GHA_PASS_INPUT,
    2=GHA_WRITE_TONAL, 4=GHA_WRITE_RESIUDAL, 8=GHA_WIDEBAND.  Prints the
    reference's stderr lines; out-of-range values exit."""
    use_gha = True
    wb_refine = False
    for kv in (advanced or "").split(","):
        if kv.startswith("ghadbg="):
            mask = int(kv.split("=")[1])
            if mask > 15 or mask < 0:
                sys.exit("invalud value of GHA processing mask")
            for bit, name in ((1, "GHA_PASS_INPUT"), (2, "GHA_WRITE_TONAL"),
                              (4, "GHA_WRITE_RESIUDAL"), (8, "GHA_WIDEBAND")):
                if mask & bit:
                    print(name, file=sys.stderr)
            use_gha = mask
        elif kv.startswith("ghawbrefine="):
            mode = int(kv.split("=")[1])
            if mode < 0 or mode > 1:
                sys.exit("invalid ghawbrefine value "
                         "(expected 0=subband or 1=raw)")
            wb_refine = mode == 1
            print("GHA_WIDEBAND_REFINE=" + ("raw" if mode else "subband"),
                  file=sys.stderr)
    return use_gha, wb_refine


def encode_file(args):
    pcm, rate = audio.read(args.infile)
    if rate != 44100:
        sys.exit("Unsupported sample rate. Only 44100Hz is supported now")
    channels = pcm.shape[0]

    on_progress = None
    if not args.nostdout:
        print(f"Input file: {args.infile}\n Channels: {channels}\n "
              f"SampleRate: {rate}\n Codec: ATRAC3Plus")
        on_progress = progress.print_progress
    use_gha, wb_refine = parse_advanced(args.advanced)
    planes = encode_track(pcm, use_gha=use_gha, wb_refine=wb_refine,
                          progress=on_progress, device=args.device)
    dev = runtime.device(args.device)
    frames = runtime.to_numpy(pack_device(
        runtime.state_from_numpy(planes, dev), channels))

    container = args.container                 # resolved by cli.main
    if container == "oma":
        oma.write(args.outfile, frames, oma.CODEC_ATRAC3PLUS, T.FRAME_BYTES,
                  channels=channels)
    elif container == "riff":
        at3.write_at3p(args.outfile, frames, T.FRAME_BYTES, channels=channels)
    elif container == "raw":
        raw.write(args.outfile, frames)
    else:
        sys.exit(f"Unsupported container for ATRAC3+: {container}")
