"""Print OMA container info (reference: lib/liboma/tools/omainfo.c)."""
import sys

from atracdenc_tpu_torch.containers import oma


def main(argv=None):
    args = argv if argv is not None else sys.argv[1:]
    if not args:
        print("usage: python -m atracdenc_tpu_torch.tools.omainfo <file.oma>...")
        return 1
    for path in args:
        frames, info = oma.read(path)
        codec = "ATRAC3" if info["codec"] == oma.CODEC_ATRAC3 else "ATRAC3PLUS"
        print(f"{path}: codec: {codec}, framesize: {info['frame_size']}, "
              f"samplerate: {info['sample_rate']}, "
              f"jointstereo: {int(info['joint_stereo'])}, "
              f"frames: {frames.shape[0]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
