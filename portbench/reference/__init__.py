"""The benchmark's plain reference: what decides ``correct``.

``upstream/`` is a NumPy model of the upstream encoder, dcherednik/atracdenc,
that replays its float32 decision chain operation for operation (QMF tree,
kissfft MDCT, gain control, tonal components, scaler, bit allocation, the
bitstream writers).  It is taken from the JAX package's QA path
(``models/atrac{1,3}/exact_enc.py`` and what they use), whose tests hold it
byte for byte against frames of the compiled upstream binary; nothing of it
comes from the program, and it imports neither the program nor ``jax``.

``atrac3.py`` and ``atrac1.py`` code a track's PCM with it into the rows
the program's call path delivers (ATRAC3 stereo frames, ATRAC1 sound units),
and turn rows back into dequantised spectra; ``compare.py`` turns two sets
of rows into the numbers that are held to limits.  The model is scalar
Python, about 0.2 s an ATRAC3 frame and 0.04 s an ATRAC1 frame on one
core, so a run checks a sample of tracks, one process each
(``encode_many``, ``worker.py``).
"""
import os
import pickle
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def workers(n_tasks):
    """Processes for ``n_tasks`` reference encodes: one a core the run may
    use, less one for the run itself, and no more than there are tasks."""
    cores = len(os.sched_getaffinity(0))
    return max(1, min(n_tasks, cores - 1))


def encode_many(fn, cfg, pcms):
    """``[fn(cfg, pcm) for pcm in pcms]``, each in a fresh interpreter of
    its own (``python3 -m portbench.reference.worker``: the run's process
    holds the CUDA context, so nothing is forked from it), ``workers`` at
    a time, tasks and answers passed as pickle files.  Only those
    processes are started (no pool manager, no resource tracker), and each
    is ended and waited for before this returns, on every path out."""
    if len(pcms) == 1:
        return [fn(cfg, pcms[0])]
    with tempfile.TemporaryDirectory(prefix="portbench-ref-") as tmp:
        jobs = []
        for i, pcm in enumerate(pcms):
            task = os.path.join(tmp, f"{i}.task")
            with open(task, "wb") as f:
                pickle.dump((fn, cfg, pcm), f)
            jobs.append((task, os.path.join(tmp, f"{i}.out")))
        todo, running = list(jobs), []
        try:
            while todo or running:
                while todo and len(running) < workers(len(jobs)):
                    task, out = todo.pop(0)
                    running.append(subprocess.Popen(
                        [sys.executable, "-m", "portbench.reference.worker",
                         task, out], cwd=ROOT, stdin=subprocess.DEVNULL,
                        stdout=subprocess.DEVNULL))
                code = running[0].wait()
                running.pop(0)
                if code != 0:
                    raise RuntimeError(
                        f"a reference encode exited with code {code}")
        finally:
            for p in running:
                p.kill()
            for p in running:
                p.wait()
        results = []
        for _, out in jobs:
            with open(out, "rb") as f:
                results.append(pickle.load(f))
        return results
