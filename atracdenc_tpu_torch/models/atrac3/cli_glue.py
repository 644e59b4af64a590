"""File-level ATRAC3 encode for the port's CLI.

Mirrors ``atracdenc_tpu/models/atrac3/cli_glue.py::encode_file``
(reference src/main.cpp:367-424, 656-687): bitrate in kbit/s scales by
1024, the container follows the output extension, and the host packer and
the OMA / RIFF / RM / RAW writers are copies of the JAX package's numpy
modules.  ``--exact`` runs the host exact-semantics encoder; ``--yaml-log``
writes the gain-control decisions of every frame.
"""
import sys

import numpy as np
import torch

from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.containers import at3, oma, raw, rm
from atracdenc_tpu_torch.io import audio
from atracdenc_tpu_torch.models.atrac3 import frame
from atracdenc_tpu_torch.models.atrac3 import tables as T
from atracdenc_tpu_torch.utils import operator_log, progress


def write_yaml_log(path, pcm, planes, js, device):
    """Recompute the gain intermediates of the track's whole frames in one
    debug pass on ``device`` and write them as the reference's YAML stream.

    A trailing partial frame has no document: the JAX CLI's ``band_frames``
    cannot reshape such a track at all and exits with an error."""
    from . import gain, yaml_log
    from .encoder import band_frames

    pcm = np.atleast_2d(pcm.astype(np.float32))
    whole = pcm.shape[-1] // T.NUM_SAMPLES * T.NUM_SAMPLES
    x = runtime.to_torch(pcm[:, :whole], runtime.device(device))
    bands = band_frames(x)
    if js and bands.shape[0] == 2:
        bands = torch.stack([(bands[0] + bands[1]) * 0.5,
                             (bands[0] - bands[1]) * 0.5])
    *_, dbg = gain.gain_control(bands, debug=True)
    with open(path, "w") as fp:
        yaml_log.write(fp, planes, {k: runtime.to_numpy(v)
                                    for k, v in dbg.items()})


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

    if args.exact:
        # reference-float-semantics host path: byte-identical to the
        # reference binary in every mode (tests/test_at3_exact.py)
        from .exact_enc import encode_track_exact
        planes = encode_track_exact(pcm, frame_bytes=frame_size, js=js,
                                    no_gain=args.nogaincontrol,
                                    no_tonal=args.notonal,
                                    bfu_idx_const=args.bfuidxconst)
    else:
        planes = encode_track(pcm, frame_bytes=frame_size, js=js,
                              no_gain_control=args.nogaincontrol,
                              no_tonal=args.notonal,
                              bfu_idx_const=args.bfuidxconst,
                              progress=on_progress, device=args.device)
    operator_log.warn_clipping(planes)
    frames = frame.pack(planes, frame_size, js=js)

    if args.yaml_log and not args.nogaincontrol:
        write_yaml_log(args.yaml_log, pcm, planes, js, args.device)

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
