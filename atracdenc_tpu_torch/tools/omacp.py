"""Copy an OMA file frame by frame (reference: lib/liboma/tools/omacp.c).

Exercises both the OMA reader and writer paths: parses the EA3 header of the
input, prints codec/bitrate/channel-format like the reference tool, and
re-serializes every frame through the writer.  The output is byte-identical
to the input for files our writer produced.
"""
import sys

from atracdenc_tpu_torch.containers import oma


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    if len(args) != 2:
        print("usage: \n\t omacp [in] [out]")
        return 1
    inp, outp = args
    frames, info = oma.read(inp)
    codec = info["codec"]
    codecname = "ATRAC3" if codec == oma.CODEC_ATRAC3 else "ATRAC3PLUS"
    # bitrate formula per liboma oma_get_bitrate: framesize*sr/(frame samples)
    samples = 1024 if codec == oma.CODEC_ATRAC3 else 2048
    bitrate = info["frame_size"] * info["sample_rate"] * 8 // samples
    # channel format ids per liboma (OMA_MONO=0/OMA_STEREO=1/OMA_STEREO_JS=2)
    if info["channels"] == 1:
        chfmt = 0
    elif info["joint_stereo"]:
        chfmt = 2
    else:
        chfmt = 1
    print(f"codec: {codecname}, bitrate: {bitrate}, "
          f"channel format: {chfmt}")
    oma.write(outp, frames, codec, info["frame_size"],
              channels=info["channels"],
              joint_stereo=info["joint_stereo"],
              sample_rate=info["sample_rate"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
