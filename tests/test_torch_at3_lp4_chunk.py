"""ATRAC3 LP4 (66.15 kbit/s, joint stereo, 192 B frames) through the
``atrac3-lp4.batch`` cell's own call path (ATRAC3's, which
``portbench/codecs/atrac3fast.py`` names: ``encode_frames_chunk`` with its
carry, then ``pack_device_batch``) on the CPU, at a small size: 3 streams
of the benchmark's music, 24 frames in chunks of 8 (two carries; of 4 for
the carry's fault).  The chunks equal one call; the frames read under the
cell's limits against the benchmark's model of the upstream encoder, and
four planted faults of the joint-stereo route read over them; the route's
spans and counters are there when tracing is on, and the cell's readers
turn them into its per-layer metrics."""
import json
import os

import pytest
import torch

from atracdenc_tpu_torch import trace
from atracdenc_tpu_torch.models.atrac3 import device_pack, encoder
from portbench import manifest, music, program_trace
from portbench.reference import atrac3, encode_many
from portbench.reference.compare import Tally

CELL = "atrac3-lp4.batch"
S, F, K, SPF = 3, 24, 8, 1024
SEED = 2 ** 31 + 4242


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def cell():
    return manifest.cell(CELL)


@pytest.fixture(scope="module")
def pcm():
    """f32 [S, 2, (F + 2) * 1024]: the cell's music, two frames past F."""
    x = music.tracks(S, (F + 2) * SPF, SEED, torch.device("cpu"))
    return x.to(torch.float32) / 32768.0


@pytest.fixture(scope="module")
def want(cell, pcm):
    """The upstream model's frames of each stream (one process each)."""
    rows = encode_many(atrac3.encode_rows, cell.config,
                       [pcm[s].numpy() for s in range(S)])
    return [torch.from_numpy(r[:F]) for r in rows]


def chunked(codec, x, k=K, drop_carry=False):
    """Frames 0..F-1 of ``x`` in chunks of ``k`` through the cell's
    ``encode_chunk``, each with its next frame as look-ahead ->
    uint8 [S, F, 192]; ``drop_carry``: every chunk starts from no state."""
    state, out = None, []
    for a in range(0, F, k):
        rows, state = codec.encode_chunk(
            x[..., a * SPF:(a + k) * SPF], None if drop_carry else state,
            x[..., (a + k) * SPF:(a + k + 1) * SPF])
        out.append(rows)
    return torch.cat(out, dim=1)


def _spectra(cell):
    """The reference's dequantiser, with the upstream parser's assertion
    on a malformed frame read as a frame that does not parse."""
    ref = atrac3.Reference(cell.config)

    def spectra(rows):
        try:
            return ref.spectra(rows)
        except AssertionError as e:
            raise ValueError(f"frame does not parse: {e!r}") from e
    return spectra


def _numbers(cell, rows, want):
    tally = Tally()
    for s in range(S):
        tally.add(rows[s], want[s])
    return tally.numbers(_spectra(cell))


def _correct(numbers):
    with open(os.path.join(manifest.HERE, "limits", CELL + ".json")) as fp:
        limits = json.load(fp)
    return all(numbers[k] <= v for k, v in limits.items())


@pytest.mark.parametrize("k", [4, 8, 12])
def test_chunks_equal_one_call(cell, pcm, k):
    codec = cell.codec_module().Codec(cell.config)
    whole, _ = codec.encode_chunk(pcm[..., :F * SPF], None,
                                  pcm[..., F * SPF:(F + 1) * SPF])
    got = chunked(codec, pcm, k)
    assert got.dtype == torch.uint8 and got.shape == (S, F, 192)
    assert torch.equal(got, whole)


def test_sound_chunks_read_under_the_limits(cell, pcm, want):
    codec = cell.codec_module().Codec(cell.config)
    numbers = _numbers(cell, chunked(codec, pcm), want)
    assert _correct(numbers), numbers


def _no_matrix(monkeypatch):
    monkeypatch.setattr(encoder, "ms_matrix", lambda bands, head: (bands,
                                                                   head))


def _no_shift(monkeypatch):
    monkeypatch.setattr(encoder, "calc_ms_shift",
                        lambda loud, header_bits, fb:
                        torch.zeros_like(header_bits[:, 0]))


def _not_reversed(monkeypatch):
    orig = device_pack.js_assemble
    monkeypatch.setattr(device_pack, "js_assemble",
                        lambda b0, b1, shift: orig(b0, b1.flip(1), shift))


FAULTS = {"matrix_skipped": _no_matrix, "ms_shift_zero": _no_shift,
          "channel1_not_reversed": _not_reversed, "carry_dropped": None}
# A dropped carry moves the two or three frames after it (the QMF history,
# the MDCT overlap, the gain context), so it is planted at chunks of 4:
# five carries in the 24 frames.
CARRY_K = 4


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_fault_reads_over_the_limits(cell, pcm, want, fault,
                                             monkeypatch):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    codec = cell.codec_module().Codec(cell.config)
    drop = fault == "carry_dropped"
    rows = chunked(codec, pcm, CARRY_K if drop else K, drop_carry=drop)
    numbers = _numbers(cell, rows, want)
    assert not _correct(numbers), (fault, numbers)


# the joint-stereo route's spans and counters --------------------------------

def _middle_call(cell, pcm):
    """A middle chunk's planes and bytes (a carry and a look-ahead)."""
    opts = cell.codec_module().Codec(cell.config).opts
    x = pcm[..., K * SPF:2 * K * SPF]
    _, state = encoder.encode_frames_chunk(pcm[..., :K * SPF], None,
                                           x[..., :SPF], **opts)

    def run():
        planes, _ = encoder.encode_frames_chunk(
            x, state, pcm[..., 2 * K * SPF:(2 * K + 1) * SPF], **opts)
        return planes, device_pack.pack_device_batch(planes, 192, True)
    return run


def test_js_spans_and_counters_in_a_traced_call(cell, pcm):
    run = _middle_call(cell, pcm)
    _, off = run()
    assert trace.snapshot()["records"] == []
    assert trace.device_counter("at3.js_shift_bytes", "cpu") is None
    trace.reset()
    trace.enable()
    planes, on = run()
    trace.disable()
    assert torch.equal(off, on)
    snap = trace.snapshot()
    recs = snap["records"]
    roots = {r["name"]: r for r in recs if r["parent"] is None}
    assert set(roots) == {"at3.encode_chunk", "at3.pack"}
    kids = {name: {r["name"] for r in recs if r["parent"] == root["id"]}
            for name, root in roots.items()}
    assert {"band_frames", "ms_matrix", "ms_shift", "gain_control",
            "allocate"} <= kids["at3.encode_chunk"]
    assert kids["at3.pack"] == {"channel_fields", "deposit_fields",
                                "js_assemble"}
    counters = snap["counters"]
    assert counters["at3.js_frames"]["total"] == S * K
    assert counters["at3.js_frames"]["by_span"] == {"ms_shift": S * K}
    shifted = int(planes["ms_shift"].abs().sum())
    assert shifted > 0
    assert counters["at3.js_shift_bytes"]["total"] == shifted


def test_lp2_route_has_no_js_span_or_counter(pcm):
    trace.enable()
    planes, _ = encoder.encode_frames_chunk(pcm[..., :4 * SPF], None, None,
                                            no_gain_control=False,
                                            no_tonal=False)
    trace.disable()
    snap = trace.snapshot()
    names = {r["name"] for r in snap["records"]}
    assert not names & {"ms_matrix", "ms_shift", "js_assemble"}
    assert "at3.js_frames" not in snap["counters"]
    assert "at3.js_shift_bytes" not in snap["counters"]
    assert not planes["ms_shift"].any()


# the cell's readers ---------------------------------------------------------

JS_READERS = ["span_ms.at3js_stereo", "span_ms.at3js_encode"]


class _Stub:
    def __init__(self, records):
        self.records, self.on = records, False

    def enable(self):
        self.on = True

    def snapshot(self):
        return {"records": self.records}


def _records(js=True):
    """Two unprofiled calls and one profiled (10x slower), in ms: encode
    500 (matrix 2, shift 1), pack 100 (merge 0.5)."""
    ms = 1_000_000
    recs = []

    def rec(name, parent, root, dur, profiled=False):
        rid = len(recs) + 1
        recs.append({"name": name, "id": rid, "parent": parent,
                     "root": root or rid, "root_name": name if root is None
                     else recs[root - 1]["name"], "profiled": profiled,
                     "host": [0, int(dur * ms)], "device": [0, int(dur * ms)],
                     "counts": {}})
        return rid
    for profiled in (False, False, True):
        slow = 10 if profiled else 1
        enc = rec("at3.encode_chunk", None, None, 500 * slow, profiled)
        if js:
            rec("ms_matrix", enc, enc, 2 * slow, profiled)
            rec("ms_shift", enc, enc, 1 * slow, profiled)
        pack = rec("at3.pack", None, None, 100 * slow, profiled)
        if js:
            rec("js_assemble", pack, pack, 0.5 * slow, profiled)
    return recs


def test_readers_of_the_js_route(monkeypatch):
    stub = _Stub(_records())
    monkeypatch.setattr(program_trace, "trace", stub)
    got = {m: manifest.reader(m).read(None) for m in JS_READERS}
    assert stub.on
    assert got == pytest.approx({"span_ms.at3js_stereo": 3.5,
                                 "span_ms.at3js_encode": 500.0})


@pytest.mark.parametrize("stub", [None, _Stub([]), _Stub(_records(False))],
                         ids=["no_tracer", "no_call", "no_js_spans"])
def test_js_stereo_reader_finds_nothing_without_the_spans(monkeypatch, stub):
    """A program without the tracer, a run with no call, or a program
    whose ATRAC3 call has no joint-stereo spans (as before they were
    added): the reader returns None and does not raise."""
    monkeypatch.setattr(program_trace, "trace", stub)
    assert manifest.reader("span_ms.at3js_stereo").read(None) is None
