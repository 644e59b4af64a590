"""Closed-loop batch encoding: a service that encodes a library on one card.

Traffic parameters (``portbench/traffic/<mix>.json``): ``streams`` tracks
encoded together, ``chunk_frames`` codec frames of each per call,
``track_seconds`` [lo, hi] from which one generation's track length is
drawn (rounded to whole chunks), ``check_tracks`` tracks whose bytes the
reference checks.  The configuration's ``check_frames`` says how many
frames of each, from the track's start: as many as the upstream model
codes in a fraction of the window.

One generation of ``streams`` tracks of one length, made by
``portbench/music.py``, sits chunk by chunk in pinned host memory as 16-bit
PCM.  A call copies its chunk (with the next chunk's first frame, the
lookahead) to the card, converts it to float, and runs the codec's
``encode_chunk`` (the encoder with its carry, then the device packer): one
call in flight on the device, its state carried to the next chunk,
``state=None`` at a track's start and no lookahead at its end.  Each
call's bytes are copied to pinned host memory on a side stream, at most
two calls' bytes in flight, and count when they have landed there.  The
generation loops for as long as the window lasts.

``encode_rate.<codec>`` (the cell's end-to-end metric of that name) is the
stereo audio seconds of all landed calls over the time from the window's
start to the last landing.  ``peak_mem_gib`` is
``torch.cuda.max_memory_allocated`` over the window.  Of every generation
the window finished, the bytes of the first ``check_frames`` frames of
``check_tracks`` tracks drawn from the seed are kept, and after the window
held against the upstream encoder's frames for the same PCM.
"""
import time

import numpy as np
import torch

from portbench import music
from portbench.reference import encode_many
from portbench.reference.compare import Tally

RATE = music.RATE
LOOKAHEAD = 2      # frames of PCM past the last checked frame the reference gets


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.codec = ctx.codec
        self.spf = ctx.codec_module.SAMPLES_PER_FRAME
        self.dev = ctx.device
        self.cuda = self.dev.type == "cuda"
        t = ctx.traffic
        self.streams = t["streams"]
        self.chunk_frames = t["chunk_frames"]
        self.check_tracks = t["check_tracks"]
        self.check_frames = ctx.config["check_frames"]
        self.rows_per_frame = 2 // ctx.codec_module.CHANNELS_PER_ROW
        rng = np.random.default_rng(ctx.seed)
        secs = rng.uniform(*t["track_seconds"])
        self.chunk_samples = self.chunk_frames * self.spf
        self.chunks = max(2, int(round(secs * RATE / self.chunk_samples)))
        self.sample = torch.as_tensor(np.sort(rng.choice(
            self.streams, self.check_tracks, replace=False)))
        # chunks that hold the checked frames
        self.kept_chunks = min(self.chunks,
                               -(-self.check_frames // self.chunk_frames))
        self.k, self.state, self.gen = 0, None, 0
        self.kept = {}                  # (generation, chunk) -> rows

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def setup(self):
        s, cs, spf = self.streams, self.chunk_samples, self.spf
        total = self.chunks * cs
        pcm = music.tracks(s, total, self.ctx.seed, self.dev)
        self.host = torch.zeros((self.chunks, s, 2, cs + spf),
                                dtype=torch.int16, pin_memory=self.cuda)
        for k in range(self.chunks):
            piece = pcm[..., k * cs:(k + 1) * cs + spf]
            self.host[k, ..., :piece.shape[-1]].copy_(piece)
        del pcm
        self.x = torch.empty((s, 2, cs + spf), dtype=torch.int16,
                             device=self.dev)
        rows = self.chunk_frames * 2 // self.ctx.codec_module.CHANNELS_PER_ROW
        self.bufs = [torch.empty((s, rows, self.codec.row_bytes),
                                 dtype=torch.uint8, pin_memory=self.cuda)
                     for _ in range(2)]
        self.side = torch.cuda.Stream(self.dev) if self.cuda else None
        # warm-up: a track's first, a middle and its last chunk (every
        # branch of the call path), with the copies of the window
        state = None
        for k in (0, 1, self.chunks - 1):
            out, state = self._call(k, state)
            self.bufs[0].copy_(out)
        self._sync()

    def _call(self, k, state):
        self.x.copy_(self.host[k], non_blocking=True)
        pcm = self.x.to(torch.float32) / 32768.0
        cur = pcm[..., :self.chunk_samples].contiguous()
        nxt = (pcm[..., self.chunk_samples:].contiguous()
               if k < self.chunks - 1 else None)
        return self.codec.encode_chunk(cur, state, nxt)

    def _land(self, p):
        ev, slot, k, gen = p
        if ev is not None:
            ev.synchronize()
        self.t_last = time.perf_counter()
        self.landed += 1
        if k < self.kept_chunks:
            self.kept[gen, k] = self.bufs[slot][self.sample].clone()

    def window(self, seconds):
        """Drive calls for ``seconds``; returns the calls landed."""
        self._sync()
        self.landed = 0
        pending = [None, None]
        order = []
        t0 = time.perf_counter()
        self.t_last = t0
        i = 0
        while time.perf_counter() - t0 < seconds:
            out, state = self._call(self.k, self.state)
            slot = i % 2
            if pending[slot] is not None:
                self._land(pending[slot])
                order.remove(slot)
            if self.cuda:
                self.side.wait_stream(torch.cuda.current_stream(self.dev))
                with torch.cuda.stream(self.side):
                    self.bufs[slot].copy_(out, non_blocking=True)
                out.record_stream(self.side)
                ev = torch.cuda.Event()
                ev.record(self.side)
            else:
                self.bufs[slot].copy_(out)
                ev = None
            pending[slot] = (ev, slot, self.k, self.gen)
            order.append(slot)
            self.k += 1
            if self.k == self.chunks:
                self.k, self.state, self.gen = 0, None, self.gen + 1
            else:
                self.state = state
            i += 1
        for slot in list(order):
            self._land(pending[slot])
        self.elapsed = self.t_last - t0
        return self.landed

    def audio_seconds(self, calls):
        return calls * self.streams * self.chunk_samples / RATE

    def measure(self, seconds):
        """The untraced run's window -> end-to-end metrics."""
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)
        calls = self.window(seconds)
        rate = next(m["name"] for m in self.ctx.cell.end_to_end
                    if m["name"].split(".")[0] == "encode_rate")
        out = {rate: self.audio_seconds(calls) / self.elapsed}
        if self.cuda:
            self.peak = torch.cuda.max_memory_allocated(self.dev)
            out["peak_mem_gib"] = self.peak / 2 ** 30
        return out, calls

    def _track_pcm(self, s, frames):
        """f32 numpy [2, frames * spf] of track ``s`` from its start (or
        the whole track, if shorter), from the pinned chunks."""
        cs = self.chunk_samples
        n = min(frames * self.spf, self.chunks * cs)
        pieces = [self.host[k, s, :, :cs] for k in range(-(-n // cs))]
        x = torch.cat(pieces, dim=-1)[:, :n]
        return x.to(torch.float32).numpy() / np.float32(32768.0)

    def check(self, reference):
        """Hold the kept bytes of every finished generation against the
        upstream encoder's frames for the same PCM -> Tally."""
        self.state = self.x = None           # the program's state, freed
        tally = Tally()
        rb, rpf = self.codec.row_bytes, self.rows_per_frame
        gens = sorted({g for g, _ in self.kept
                       if all((g, k) in self.kept
                              for k in range(self.kept_chunks))})
        if not gens or gens[0] != 0:
            tally.lost(self.check_tracks * self.check_frames * rpf)
            return tally
        total = self.chunks * self.chunk_frames
        n_cmp = min(self.check_frames, total - LOOKAHEAD)
        pcms = [self._track_pcm(int(s), n_cmp + LOOKAHEAD)
                for s in self.sample]
        refs = encode_many(reference.encode_rows, reference.cfg, pcms)
        for g in gens:
            prog = torch.cat([self.kept[g, k] for k in
                              range(self.kept_chunks)], dim=1)
            for j, ref in enumerate(refs):
                tally.add(prog[j, :n_cmp * rpf].reshape(-1, rb),
                          torch.from_numpy(ref[:n_cmp * rpf]))
        return tally

    def close(self):
        pass
