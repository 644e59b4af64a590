"""The (dp, sp) mesh of ranks and sharded batch encode / decode.

Port of ``atracdenc_tpu/parallel/mesh.py``:

  * dp ("stream") axis — independent tracks: a rank encodes the streams of
    its dp row;
  * sp ("sample") axis — a track's frames: a rank encodes the frames of its
    sp column.

In the JAX package XLA's partitioner splits the time axis.  Here the split
is explicit, and for two codecs the time axis is a recurrence, not a halo:
ATRAC3 carries the gain context, the MDCT overlap half, NextOverlapScale,
the loudness IIR and the PCM tail from frame to frame, ATRAC1 its PCM tail
and loudness IIR.  So within a dp row, sp rank j waits for the carry of
rank j - 1, encodes its frames with the next column's first frame as
lookahead (read from the input), and sends its carry on: the exact chunk
chain of ``encode_track``, whose output equals the whole track's.  The
columns of a row therefore run one after another; the chain spreads memory,
not time.  ATRAC3+ carries only PCM history, so its sp ranks run at once,
each reading its halo from the input.  A column that spans the whole track
(sp = 1) is one chunk with no carry and no lookahead: the whole-track
encode.  Columns join on each plane's frame axis, as each codec's encoder
declares it (``PER_FRAME``, ``models/track.py``).

Contract of every ``*_sharded`` function: each rank of the mesh passes the
same global host batch, encodes its block on its device, and returns the
global result gathered to every rank as numpy.  The 1x1 mesh needs no
process group: it is the single-rank run.  Carries and blocks cross ranks
through host memory (see ``parallel/distributed.py`` for why gloo).

    python -m atracdenc_tpu_torch.parallel.mesh [--devices N] [--device cpu]

runs ``dryrun(N)``: N fresh rank processes on one machine.
"""
import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from atracdenc_tpu_torch import kernels, runtime
from atracdenc_tpu_torch.models import track
from atracdenc_tpu_torch.models.atrac1 import decoder as at1_decoder
from atracdenc_tpu_torch.models.atrac1 import encoder as at1_encoder
from atracdenc_tpu_torch.models.atrac3 import device_pack as at3_pack
from atracdenc_tpu_torch.models.atrac3 import encoder as at3_encoder
from atracdenc_tpu_torch.models.atrac3p import encoder as at3p_encoder
from atracdenc_tpu_torch.parallel import distributed as D

AT1_FRAME, AT3_FRAME = 512, 1024
_AT1_DIAG = ("clip_count", "clip_max")


class Mesh:
    """A (dp, sp) grid over the ranks of the process group: rank r sits at
    dp row r // sp and sp column r % sp, on ``device`` (default
    ``cuda:{rank % cards}``).  The 1x1 mesh is this process alone."""

    def __init__(self, dp, sp, device=None):
        self.dp, self.sp = dp, sp
        world = dist.get_world_size() if dist.is_initialized() else 1
        if dp * sp > 1 and dp * sp != world:
            raise ValueError(f"a {dp} x {sp} mesh needs a process group of "
                             f"{dp * sp} ranks, not {world}")
        self.rank = dist.get_rank() if dp * sp > 1 else 0
        self.device = (torch.device(device) if device is not None
                       else D.rank_device("cuda", self.rank))

    @property
    def shape(self):
        return {"dp": self.dp, "sp": self.sp}

    @property
    def row(self):
        return self.rank // self.sp

    @property
    def col(self):
        return self.rank % self.sp

    def recv_carry(self):
        """The carry of the previous sp column (numpy tree; None in column
        0)."""
        if self.col == 0:
            return None
        box = [None]
        dist.recv_object_list(box, src=self.rank - 1)
        return box[0]

    def send_carry(self, state):
        """Pass this column's carry (tensors) to the next sp column."""
        if self.col < self.sp - 1:
            dist.send_object_list([runtime.state_to_numpy(state)],
                                  dst=self.rank + 1)

    def gather(self, block):
        """Every rank's block, as grid[row][col], on every rank."""
        if self.dp * self.sp == 1:
            return [[block]]
        blocks = [None] * (self.dp * self.sp)
        dist.all_gather_object(blocks, block)
        return [blocks[i * self.sp:(i + 1) * self.sp] for i in range(self.dp)]


def make_mesh(n_devices=None, dp=None, device=None):
    """(dp, sp) mesh over the process group's ``n_devices`` ranks (all of
    them by default); dp defaults to the largest divisor <= sqrt(n)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if dp is None:
        dp = max(c for c in range(1, int(np.sqrt(n)) + 1) if n % c == 0)
    return Mesh(dp, n // dp, device)


def _assemble(grid, per_frame):
    """grid[row][col] of {plane: array [S, ...]} -> the global {plane:
    array}: columns joined on each plane's frame axis (``per_frame``: the
    planes without a channel axis), rows on the stream axis."""
    rows = [track.join(r, per_frame, lead=1) for r in grid]
    return {k: np.concatenate([r[k] for r in rows], axis=0) for k in rows[0]}


def _row(pcm, mesh):
    """This rank's dp row of the global batch [S, C, T]."""
    pcm = np.asarray(pcm, np.float32)
    start, count = D.local_batch_slice(pcm.shape[0], mesh)
    return pcm[start:start + count]


def _row_block(rows, mesh, frame_len, block, carry):
    """Run ``block(rows, f0, f1, state)`` on this rank's sp column of the
    row's frames [f0, f1); with ``carry``, after the previous column's carry
    arrives, and send its own on.  Returns the block's outputs as numpy."""
    t = rows.shape[-1]
    if t % (frame_len * mesh.sp):
        raise ValueError(f"T={t} must be a multiple of sp * {frame_len} "
                         f"({mesh.sp * frame_len})")
    per = t // frame_len // mesh.sp
    state = mesh.recv_carry() if carry else None
    if state is not None:
        state = runtime.state_from_numpy(state, mesh.device)
    out, state = block(rows, mesh.col * per, (mesh.col + 1) * per, state)
    if carry:
        mesh.send_carry(state)
    return {k: runtime.to_numpy(v) for k, v in out.items()}


def _sharded(pcm, mesh, frame_len, block, per_frame, carry=True):
    rows = _row(pcm, mesh)
    return _assemble(mesh.gather(_row_block(rows, mesh, frame_len, block,
                                            carry)), per_frame)


def _columns(rows, f0, f1, n, dev):
    """Frames [f0, f1) of the rows and the next frame (None at the end), as
    tensors on ``dev``."""
    nxt = rows[..., f1 * n:(f1 + 1) * n]
    return (runtime.to_torch(rows[..., f0 * n:f1 * n], dev),
            runtime.to_torch(nxt, dev) if nxt.size else None)


# --- ATRAC1 -----------------------------------------------------------------

def _at1_block(dev):
    """ATRAC1 planes without the clip_* operator diagnostics, as in the JAX
    package: they are raw float maxima, not wire planes."""
    def block(rows, f0, f1, state):
        x, nxt = _columns(rows, f0, f1, AT1_FRAME, dev)
        planes, state = at1_encoder.encode_frames_chunk(x, state, nxt)
        return {k: v for k, v in planes.items() if k not in _AT1_DIAG}, state
    return block


def encode_batch_sharded(pcm, mesh):
    """ATRAC1 planes of a global batch pcm [S, C, T] (S % dp == 0, T a
    multiple of sp * 512) over the mesh -> numpy planes [S, C, F, ...]."""
    return _sharded(pcm, mesh, AT1_FRAME, _at1_block(mesh.device),
                    at1_encoder.PER_FRAME)


def decode_batch_at1(planes):
    """[S, ...] ATRAC1 planes (tensors) -> [S, C, T] PCM."""
    return at1_decoder.decode_frames(planes["short_mask"], planes["wordlen"],
                                     planes["sfi"], planes["mant"])


def decode_batch_at1_sharded(planes, mesh):
    """ATRAC1 decode of global numpy planes, streams over dp (the sp ranks
    of a row decode the same streams; the IMDCT overlap and the QMF
    synthesis run unsplit per stream) -> numpy PCM [S, C, T].

    The decoded PCM is raw matmul output, which a smaller local batch can
    change in its last ulps; the wire planes of the encode are decisions
    and stay equal.  So decode equality is asserted to 1e-6, as in the JAX
    package."""
    start, count = D.local_batch_slice(planes["wordlen"].shape[0], mesh)
    local = {k: runtime.to_torch(planes[k][start:start + count], mesh.device)
             for k in ("short_mask", "wordlen", "sfi", "mant")}
    pcm = runtime.to_numpy(decode_batch_at1(local))
    return np.concatenate([row[0] for row in mesh.gather(pcm)], axis=0)


# --- ATRAC3 -----------------------------------------------------------------

def encode_batch_at3(pcm, js=False, frame_bytes=384):
    """[S, C, T] PCM tensor -> ATRAC3 default-mode frame planes."""
    return at3_encoder.encode_frames(pcm, frame_bytes=frame_bytes, js=js,
                                     no_gain_control=False, no_tonal=False)


# the device packer's output: one plane, "bytes" [S, F, frame_bytes]
_AT3_BYTES = ("bytes",)


def _at3_block(dev, js, frame_bytes, pack):
    def block(rows, f0, f1, state):
        x, nxt = _columns(rows, f0, f1, AT3_FRAME, dev)
        planes, state = at3_encoder.encode_frames_chunk(
            x, state, nxt, frame_bytes=frame_bytes, js=js,
            no_gain_control=False, no_tonal=False)
        if pack:
            planes = {"bytes": at3_pack.pack_device_batch(planes, frame_bytes,
                                                          js)}
        return planes, state
    return block


def encode_batch_at3_sharded(pcm, mesh, js=False, frame_bytes=384):
    """ATRAC3 default-mode planes of a global batch over the mesh (S %
    dp == 0, T a multiple of sp * 1024) -> numpy planes [S, C, F, ...]
    ([S, F] for loudness and ms_shift)."""
    return _sharded(pcm, mesh, AT3_FRAME,
                    _at3_block(mesh.device, js, frame_bytes, False),
                    at3_encoder.PER_FRAME)


def encode_batch_at3_bytes_sharded(pcm, mesh, js=False, frame_bytes=384):
    """Sharded ATRAC3 encode INCLUDING the device packer: packing is frame
    local, so each rank packs its own block.  pcm [S, C, T] -> [S, F,
    frame_bytes] uint8 (numpy, on every rank)."""
    return _sharded(pcm, mesh, AT3_FRAME,
                    _at3_block(mesh.device, js, frame_bytes, True),
                    _AT3_BYTES)["bytes"]


def encode_rows_at3_bytes(rows, mesh, js=False, frame_bytes=384):
    """This rank's dp row rows [S_row, C, T] -> the row's frame bytes [S_row,
    F, frame_bytes]: its sp ranks encode the row's columns in a chain, and
    each gets the row back once (``distributed.encode_batch_global``)."""
    block = _row_block(np.asarray(rows, np.float32), mesh, AT3_FRAME,
                       _at3_block(mesh.device, js, frame_bytes, True), True)
    return _assemble([mesh.gather(block)[mesh.row]], _AT3_BYTES)["bytes"]


# --- ATRAC3+ ----------------------------------------------------------------

def encode_core_at3p_sharded(pcm, mesh, gha_mask=7, wb_refine=None):
    """The ATRAC3+ core (``models/atrac3p/encoder.py::core_frames``) of a
    global batch over the mesh (T a multiple of sp * 2048) -> numpy
    {"sfi", "mant", "spec_tab", "spec_bits", "tones.<plane>"}.  No carry:
    each column reads its PCM history and lookahead from the input."""
    def block(rows, f0, f1, state):
        return at3p_encoder.core_dict(at3p_encoder.core_frames(
            rows, f0, f1, gha_mask, wb_refine, mesh.device)), None
    return _sharded(pcm, mesh, 2048, block, at3p_encoder.PER_FRAME,
                    carry=False)


# --- dry run ----------------------------------------------------------------

def dryrun(n_devices, device="cuda", timeout=600):
    """Launch ``n_devices`` fresh rank processes on ``device`` (one machine),
    run the sharded encode steps on tiny shapes in them, and assert that the
    sharded results equal the single-rank results byte for byte; prints
    rank 0's lines.  Raises when any rank fails."""
    if device != "cpu":
        kernels.build()              # once here, not by every rank's nvcc
    outs = D.launch(lambda r, coord: [
        sys.executable, "-m", "atracdenc_tpu_torch.parallel.mesh", "--rank",
        str(r), "--devices", str(n_devices), "--coordinator", coord,
        "--device", device], n_devices, timeout=timeout)
    print(outs[0], end="", flush=True)


def _dryrun_rank(n_devices, device):
    mesh = make_mesh(n_devices, device=device)
    mesh1 = Mesh(1, 1, mesh.device)
    dp, sp = mesh.dp, mesh.sp
    s = max(2 * dp, dp)
    rng = np.random.default_rng(0)
    say = print if mesh.rank == 0 else (lambda *a, **k: None)

    t = 512 * 2 * sp
    pcm = (0.25 * rng.standard_normal((s, 2, t))).astype(np.float32)
    planes = encode_batch_sharded(pcm, mesh)
    ref = encode_batch_sharded(pcm, mesh1)
    assert planes["wordlen"].shape == (s, 2, t // 512, 52)
    for k in ref:
        assert np.array_equal(ref[k], planes[k]), \
            f"AT1 sharded != unsharded: {k}"

    t3 = 1024 * 2 * sp
    pcm3 = (0.25 * rng.standard_normal((s, 2, t3))).astype(np.float32)
    frames3 = encode_batch_at3_bytes_sharded(pcm3, mesh)
    ref3 = encode_batch_at3_bytes_sharded(pcm3, mesh1)
    assert frames3.shape == (s, t3 // 1024, 384)
    assert np.array_equal(ref3, frames3), \
        "AT3 sharded bytes != unsharded bytes"
    say("dryrun: AT1 planes + AT3 bytes byte-equal on the mesh", flush=True)

    # joint stereo: M/S matrixing, the loudness-ratio byte-budget shift and
    # the reversed channel-1 deposit all ride the same shardings
    js = encode_batch_at3_bytes_sharded(pcm3, mesh, js=True, frame_bytes=192)
    js1 = encode_batch_at3_bytes_sharded(pcm3, mesh1, js=True,
                                         frame_bytes=192)
    assert np.array_equal(js1, js), "AT3 JS sharded bytes != unsharded bytes"
    say("dryrun: AT3 JS bytes byte-equal on the mesh", flush=True)

    # AT1 decode round trip (streams over dp; tolerance per
    # decode_batch_at1_sharded)
    dec = decode_batch_at1_sharded(planes, mesh)
    dec1 = decode_batch_at1_sharded(planes, mesh1)
    derr = float(np.max(np.abs(dec1 - dec)))
    assert derr <= 1e-6, f"AT1 sharded decode off by {derr}"
    say("dryrun: AT1 decode round-trip equal on the mesh "
        f"(max dev {derr:.2e})", flush=True)

    at3p_encoder.dryrun_sharded(mesh, mesh1)
    say("dryrun: AT3P core equal on the mesh", flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(prog="atracdenc_tpu_torch.parallel.mesh")
    p.add_argument("--devices", type=int, default=4,
                   help="ranks of the mesh (processes on this machine)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--coordinator", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is None:
        dryrun(args.devices, args.device)
        return 0
    dev = D.initialize(args.coordinator, args.devices, args.rank,
                       device=args.device)
    _dryrun_rank(args.devices, dev)
    D.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
