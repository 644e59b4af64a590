"""The port's batched ATRAC3+ chunk call (``encode_chunk_device`` /
``encode_chunk_bytes``: streams in a batch, the carry on the device) on
the CPU: byte-equal to the whole-track call, and held against the
benchmark's plain model of the upstream encoder under the
``atrac3plus.batch`` cell's limits, with planted faults read over them, at
a small size and at the cell's own chunk and check lengths."""
import json
import os

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import runtime
from atracdenc_tpu_torch.models.atrac3p import encoder
from portbench import manifest, music
from portbench.reference import atrac3plus
from portbench.reference.compare import Tally

S = 3
CELL = "atrac3plus.batch"


def tonal_batch(frames, seed=5):
    """[S, 2, frames * 2048]: per stream a few steady tones, a chord that
    starts late, and noise; loud enough for the tonal model."""
    rng = np.random.default_rng(seed)
    n = np.arange(2048 * frames)
    x = np.zeros((S, 2, n.size))
    for s in range(S):
        for c in range(2):
            for _ in range(rng.integers(2, 5)):
                f, a = rng.uniform(80, 9000), rng.uniform(0.05, 0.3)
                x[s, c] += a * np.sin(2 * np.pi * f * n / 44100
                                      + rng.uniform(0, 6.28))
            on = rng.integers(0, n.size)
            x[s, c, on:] += 0.2 * np.sin(2 * np.pi * rng.uniform(200, 2000)
                                         * n[on:] / 44100)
            x[s, c] += 0.01 * rng.standard_normal(n.size)
    return torch.from_numpy(np.clip(x, -1, 1).astype(np.float32))


def chunked(x, bounds, gha_mask=7, call=encoder.encode_chunk_bytes):
    """Frames of x [S, C, T] coded in chunks [a, b) of ``bounds``, the
    carry passed on -> uint8 [S, F, 2048]."""
    ns = 2048
    f_total = x.shape[-1] // ns
    state, out = None, []
    for a, b in bounds:
        nxt = x[..., b * ns:(b + 1) * ns] if b < f_total else None
        rows, state = call(x[..., a * ns:b * ns], state, nxt,
                           gha_mask=gha_mask)
        out.append(rows)
    return torch.cat(out, dim=1)


@pytest.mark.parametrize("gha_mask", [7, None], ids=["gha7", "off"])
@pytest.mark.parametrize("bounds", [((0, 2), (2, 4), (4, 6), (6, 9)),
                                    ((0, 4), (4, 7), (7, 9)),
                                    ((0, 3), (3, 5), (5, 9))],
                         ids=["2-2-2-3", "4-3-2", "3-2-4"])
def test_chunks_equal_the_whole_track_call(bounds, gha_mask):
    x = tonal_batch(9)
    whole = encoder.encode_frames_bytes(x, 2, gha_mask=gha_mask)
    got = chunked(x, bounds, gha_mask)
    assert got.dtype == torch.uint8 and got.shape == (S, 9, 2048)
    assert torch.equal(got, whole)


def test_chunk_call_reads_nothing_back(monkeypatch):
    """No conversion through ``runtime`` (where the program blocks the host
    on the card) inside the call, and the carry stays a tensor of pcm's
    device: nothing of a call goes to the host."""
    calls = []
    for name in ("to_numpy", "to_torch", "from_host", "host_bool"):
        fn = getattr(runtime, name)
        monkeypatch.setattr(runtime, name,
                            lambda *a, _f=fn, _n=name, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    x = tonal_batch(6)
    rows, state = encoder.encode_chunk_bytes(x[..., :4 * 2048], None,
                                             x[..., 4 * 2048:5 * 2048])
    rows2, _ = encoder.encode_chunk_bytes(x[..., 4 * 2048:], state, None)
    assert calls == []
    assert isinstance(state["pcm_hist"], torch.Tensor)
    assert state["pcm_hist"].shape == (S, 2, 368 + 4 * 2048)
    planes, _ = encoder.encode_chunk_device(x[..., :4 * 2048], None, None)
    assert planes["num_qu"].shape == (S * 4,)
    assert planes["mant"].shape == (2, S * 4, 32, 128)
    assert planes["tones"]["valid"].any()


# against the plain model, under the cell's limit ---------------------------

def _numbers(rows, x, cfg):
    """The comparison's numbers of the program's rows [S, F, 2048] against
    the model's frames of each stream."""
    ref = atrac3plus.Reference(cfg)
    tally = Tally()
    for s in range(rows.shape[0]):
        want = atrac3plus.encode_rows(cfg, x[s].numpy())
        tally.add(rows[s], torch.from_numpy(want))
    return tally.numbers(ref.spectra)


def _correct(numbers):
    with open(os.path.join(manifest.HERE, "limits", CELL + ".json")) as fp:
        limits = json.load(fp)
    return all(numbers[k] <= v for k, v in limits.items())


def carry_unchanged(pcm, state, nxt, **kw):
    """The carry comes back as it went in."""
    rows, _ = encoder.encode_chunk_bytes(pcm, state, nxt, **kw)
    return rows, state


def tones_dropped(pcm, state, nxt, **kw):
    """The tonal block of each chunk's first frame is left out."""
    planes, state = encoder.encode_chunk_device(pcm, state, nxt, **kw)
    s, f = pcm.shape[0], pcm.shape[-1] // 2048
    first = torch.arange(planes["num_qu"].shape[0]) % f == 0
    planes["tones"]["valid"] = planes["tones"]["valid"] & ~first[None, :,
                                                                 None, None]
    rows = encoder.pack_device(planes, 2)
    return rows.reshape(s, f, 2048), state


@pytest.fixture(scope="module")
def batch():
    return tonal_batch(10, seed=8)


BOUNDS = ((0, 2), (2, 4), (4, 6), (6, 8), (8, 10))


def test_sound_chunks_read_under_the_limit(batch):
    cfg = manifest.cell(CELL).config
    numbers = _numbers(chunked(batch, BOUNDS), batch, cfg)
    assert _correct(numbers), numbers


@pytest.mark.parametrize("fault", [carry_unchanged, tones_dropped],
                         ids=["carry_unchanged", "tones_dropped"])
def test_planted_fault_reads_over_the_limit(batch, fault):
    cfg = manifest.cell(CELL).config
    rows = chunked(batch, BOUNDS, call=fault)
    numbers = _numbers(rows, batch, cfg)
    assert not _correct(numbers), numbers


def test_carry_fault_at_the_cells_shape():
    """The cell checks the first 520 frames of tracks coded in chunks of
    512, so a carry fault reaches only frames 512-519: 8 rows in 520.  One
    track of the cell's own music at that shape: the carry returned
    unchanged reads over the cell's limits and the sound carry under them
    (frames 512-519 of a chunk of 8 equal those of a chunk of 512)."""
    cell = manifest.cell(CELL)
    cfg, chunk = cell.config, cell.traffic["chunk_frames"]
    n = cfg["check_frames"]
    assert chunk < n < 2 * chunk
    x = music.tracks(1, (n + 2) * 2048, 2 ** 31 + 77,
                     torch.device("cpu")).to(torch.float32) / 32768.0
    want = atrac3plus.encode_rows(cfg, x[0].numpy())[:n]
    ref = atrac3plus.Reference(cfg)
    ns = 2048
    first, state = encoder.encode_chunk_bytes(
        x[..., :chunk * ns], None, x[..., chunk * ns:(chunk + 1) * ns])
    rest = (x[..., chunk * ns:n * ns], x[..., n * ns:(n + 1) * ns])
    # under the fault the first chunk's bytes are the same, and it hands on
    # the carry it was given: None
    second = {"sound": encoder.encode_chunk_bytes(rest[0], state, rest[1]),
              "carry_unchanged": carry_unchanged(rest[0], None, rest[1])}
    read = {}
    for name, (rows, _) in second.items():
        tally = Tally()
        tally.add(torch.cat([first, rows], dim=1)[0], torch.from_numpy(want))
        read[name] = tally.numbers(ref.spectra)
    assert _correct(read["sound"]), read
    assert not _correct(read["carry_unchanged"]), read
