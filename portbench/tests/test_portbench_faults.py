"""The rest of a run, past the look for a card, at a size a CPU holds: a
sound run comes out correct, and the timed path broken underneath comes
out not correct, once for each fault the cell can have (one card: there
is no exchange between chips to leave out)."""
import contextlib

import pytest

from portbench.tests.conftest import run_small

SEED = 2 ** 31 + 99
BATCH = ["atrac3-lp2.batch", "atrac1-sp.batch"]


def _on_codec(fn):
    def alter(ctx):
        ctx.codec.encode_chunk = fn(ctx.codec.encode_chunk)
        return contextlib.nullcontext()
    return alter


def state_unchanged(orig):
    """The carry comes back as it went in."""
    def f(pcm, state=None, *args, **kwargs):
        out, _ = orig(pcm, state, *args, **kwargs)
        return out, state
    return f


def half_left_out(orig):
    """The second half of the batch gets the first half's bytes."""
    def f(pcm, state, nxt):
        rows, st = orig(pcm, state, nxt)
        rows = rows.clone()
        h = rows.shape[0] // 2
        rows[h:] = rows[:rows.shape[0] - h]
        return rows, st
    return f


def altered_rows(orig):
    """One byte of one frame of each stream flipped where it is made."""
    def f(pcm, state, nxt):
        rows, st = orig(pcm, state, nxt)
        rows = rows.clone()
        rows[:, 1, 20] ^= 0xFF
        return rows, st
    return f


@pytest.mark.parametrize("name", BATCH)
def test_sound_run_is_correct(name, tmp_path):
    r = run_small(name, SEED, tmp_path)
    assert r["correct"], r["numbers"]
    assert r["failed"] == 0


FAULTS = [(n, "state_unchanged", _on_codec(state_unchanged)) for n in BATCH]
FAULTS += [(n, "half_left_out", _on_codec(half_left_out)) for n in BATCH]
FAULTS += [(n, "altered", _on_codec(altered_rows)) for n in BATCH]


@pytest.mark.parametrize("name,fault,alter", FAULTS,
                         ids=[f"{n}-{f}" for n, f, _ in FAULTS])
def test_fault_is_not_correct(name, fault, alter, tmp_path):
    r = run_small(name, SEED, tmp_path, alter=alter)
    assert not r["correct"], (fault, r["numbers"])
