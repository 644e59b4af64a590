"""Multi-process batch transcoding on ``torch.distributed``.

Port of ``atracdenc_tpu/parallel/distributed.py``.  One process is one
rank, and each rank owns one device:

  * across hosts: independent TRACKS.  ``corpus_shard`` splits a corpus
    round-robin by rank; no collective runs beyond the group's set-up.
  * inside a process group: the (dp, sp) mesh of ``parallel/mesh.py``,
    streams over dp, a track's frames over sp.  ``encode_batch_global``
    encodes one global batch over every rank of every host.

The backend is gloo, on CUDA ranks too.  NCCL refuses two ranks on one
GPU, and one card may hold every rank; gloo's ``send`` / ``recv`` and
``all_gather`` take only CPU tensors.  What crosses ranks is small (the sp
chain's carries are a few KB a stream) or ends on the host anyway (the
encoded frames), so both are staged through host memory as numpy.

Each rank's device is explicit: ``cuda:{rank % torch.cuda.device_count()}``,
or the CPU when the caller asks for it.  Where a host's ranks outnumber
its cards they share a card, and each says so on stderr; a rank never
moves to the CPU on its own.

``launch`` starts the ranks of one host as fresh interpreters (never
``fork``: the parent may have initialised CUDA), which is how
``mesh.dryrun``, the tests and ``chip_smoke.py`` rehearse a group on one
machine.
"""
import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from atracdenc_tpu_torch import runtime

__all__ = ["initialize", "finalize", "rank_device", "corpus_shard",
           "global_mesh", "local_batch_slice", "encode_batch_global",
           "free_port", "launch"]

TIMEOUT = datetime.timedelta(seconds=300)
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def rank_device(device="cuda", rank=0, on_host=1):
    """This rank's device: the CPU when ``device`` is "cpu", else
    ``cuda:{rank % device_count}`` (raises without CUDA).  ``on_host``, the
    number of ranks on this host, only decides whether to say that ranks
    share a card."""
    if runtime.device(device).type == "cpu":
        return torch.device("cpu")
    n = torch.cuda.device_count()
    dev = torch.device("cuda", rank % n)
    if on_host > n:
        print(f"rank {rank}: {on_host} ranks on this host share {n} "
              f"card(s); this rank runs on {dev}", file=sys.stderr, flush=True)
    return dev


def initialize(coordinator=None, num_processes=None, process_id=None,
               local_devices=None, device=None, timeout=TIMEOUT):
    """Join the process group (gloo over ``tcp://{coordinator}``) when
    there is more than one process, and return this rank's device.

    Each of the host's ranks keeps at most its share of the host's cores
    as intra-op threads.  ``local_devices`` is the JAX package's virtual
    CPU mesh; its nearest meaning here is a rehearsal without the card: the
    CPU device.  It is an error together with ``device="cuda"``.
    ``device`` None means CUDA, or the CPU with ``local_devices``."""
    if local_devices:
        if device == "cuda":
            raise ValueError("local_devices rehearses without the card: it "
                             "runs on the CPU, not on device='cuda'")
        device = "cpu"
    n = num_processes or 1
    rank = process_id or 0
    on_host = 1
    if n > 1:
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=n, rank=rank, timeout=timeout)
        hosts = [None] * n
        dist.all_gather_object(hosts, socket.gethostname())
        on_host = hosts.count(socket.gethostname())
    # the host's ranks share its cores: more intra-op threads than cores
    # make each rank's OpenMP pool spin against the others'
    torch.set_num_threads(max(1, min(torch.get_num_threads(),
                                     (os.cpu_count() or 1) // on_host)))
    return rank_device(device or "cuda", rank, on_host)


def finalize():
    """Leave the process group, after every rank has reached this point."""
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def corpus_shard(paths, process_id, num_processes):
    """Deterministic round-robin split of a track corpus across hosts
    (tracks are independent)."""
    return list(paths)[process_id::num_processes]


def global_mesh(dp=None, device=None):
    """(dp, sp) mesh over every rank of the process group; by default all
    dp (pure stream parallelism)."""
    from atracdenc_tpu_torch.parallel.mesh import Mesh
    n = dist.get_world_size() if dist.is_initialized() else 1
    dp = dp or n
    return Mesh(dp, n // dp, device)


def local_batch_slice(global_streams, mesh):
    """(start, count) of the stream axis that this rank's dp row holds."""
    dp = mesh.shape["dp"]
    if global_streams % dp:
        raise ValueError(
            f"global_streams={global_streams} must divide the dp axis "
            f"({dp}); pad the batch — a floor split would silently drop "
            f"the last {global_streams % dp} stream(s)")
    per = global_streams // dp
    return mesh.row * per, per


def encode_batch_global(local_pcm, mesh, frame_bytes=384, js=False):
    """Encode a GLOBAL ATRAC3 batch (default mode, device packer) over every
    rank of the group.

    local_pcm: this rank's dp row, [S_local, C, T] (``local_batch_slice``;
    the sp ranks of a row pass the same streams).  Returns the row's frame
    bytes [S_local, F, frame_bytes], each stream once: the row's sp ranks
    hold its frames in column order, not sp copies of its streams."""
    from atracdenc_tpu_torch.parallel import mesh as M
    return M.encode_rows_at3_bytes(local_pcm, mesh, js, frame_bytes)


def free_port():
    """A TCP port on localhost that is free now (bound once, released)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv_of, num_processes, timeout=300, env=None):
    """Run ``num_processes`` fresh interpreters, rank r with the command
    ``argv_of(r, coordinator)`` (coordinator: a free localhost port), from
    the repository root with the port importable; wait for all of them.

    Returns each rank's stdout.  Raises RuntimeError when a rank exits
    non-zero (the others are killed) or when ``timeout`` seconds pass."""
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    procs, outs = [], []
    try:
        for r in range(num_processes):
            out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
            outs.append((out, err))
            procs.append(subprocess.Popen(argv_of(r, coordinator), cwd=_ROOT,
                                          env=env, stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                r = failed[0]
                raise RuntimeError(f"rank {r} exited with {codes[r]}:\n"
                                   f"{_tail(outs[r][1])}")
            if all(c == 0 for c in codes):
                return [_tail(out, None) for out, _ in outs]
            if time.monotonic() > deadline:
                raise RuntimeError(f"{codes.count(None)} of {num_processes} "
                                   f"ranks still running after {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in outs:
            out.close()
            err.close()


def _tail(fp, n=4000):
    fp.seek(0)
    text = fp.read().decode(errors="replace")
    return text if n is None else text[-n:]

