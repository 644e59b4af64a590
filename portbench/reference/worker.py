"""One reference encode in a process of its own, for ``encode_many``:

    python3 -m portbench.reference.worker TASK OUT

loads ``(fn, cfg, pcm)`` from the pickle file TASK and writes
``fn(cfg, pcm)`` to the pickle file OUT."""
import os
import pickle
import sys


def main(task, out):
    with open(task, "rb") as f:
        fn, cfg, pcm = pickle.load(f)
    result = fn(cfg, pcm)
    with open(out + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".part", out)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
