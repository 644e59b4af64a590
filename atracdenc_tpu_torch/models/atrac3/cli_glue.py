"""File-level ATRAC3 encode for the port's CLI.

Mirrors ``atracdenc_tpu/models/atrac3/cli_glue.py::encode_file``
(reference src/main.cpp:367-424, 656-687): bitrate in kbit/s scales by
1024, the container follows the output extension, and the host packer and
the OMA / RIFF / RM / RAW writers are the JAX package's numpy modules.
"""
import sys

from atracdenc_tpu_torch.shared import (at3, audio, frame, oma, operator_log,
                                        progress, raw, rm)
from atracdenc_tpu_torch.shared import tables as T


def encode_file(args, lp4=False):
    from .encoder import encode_track

    pcm, rate = audio.read(args.infile)
    if rate != 44100:
        sys.exit("Unsupported sample rate. Only 44100Hz is supported now")
    channels = pcm.shape[0]

    bitrate_kbit = 64 if lp4 else args.bitrate
    bitrate, frame_size, js = T.container_params_for_bitrate(bitrate_kbit * 1024)

    if args.bfuidxconst and not (1 <= args.bfuidxconst <= 32):
        sys.exit("Wrong bfuidxconst value (1...32)")

    on_progress = None
    if not args.nostdout:
        print(f"Input file: {args.infile}\n Channels: {channels}\n "
              f"SampleRate: {rate}\n Bitrate: {bitrate}")
        on_progress = progress.print_progress

    planes = encode_track(pcm, frame_bytes=frame_size, js=js,
                          no_gain_control=args.nogaincontrol,
                          no_tonal=args.notonal,
                          bfu_idx_const=args.bfuidxconst,
                          progress=on_progress, device=args.device)
    operator_log.warn_clipping(planes)
    frames = frame.pack(planes, frame_size, js=js)

    container = args.container                 # resolved by cli.main
    if container == "oma":
        oma.write(args.outfile, frames, oma.CODEC_ATRAC3, frame_size,
                  channels=channels, joint_stereo=js)
    elif container == "riff":
        at3.write_at3(args.outfile, frames, frame_size, joint_stereo=js)
    elif container == "rm":
        rm.write(args.outfile, frames, frame_size, channels=channels,
                 joint_stereo=js)
    elif container == "raw":
        raw.write(args.outfile, frames)
    else:
        sys.exit(f"Unsupported container for ATRAC3: {container}")
