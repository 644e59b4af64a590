"""The music generator: a seed repeats exactly, seeds differ, and the
tracks have the properties the benchmark counts on."""
import torch

from portbench import music

N = music.RATE * 6


def test_same_seed_same_samples():
    a = music.tracks(2, N, 2 ** 31 + 17, "cpu")
    b = music.tracks(2, N, 2 ** 31 + 17, "cpu")
    assert a.dtype == torch.int16 and a.shape == (2, 2, N)
    assert torch.equal(a, b)


def test_seeds_differ():
    a = music.tracks(2, N, 5, "cpu")
    b = music.tracks(2, N, 6, "cpu")
    assert not torch.equal(a, b)
    assert not torch.equal(a[0], a[1])          # tracks of one seed differ


def test_properties():
    x = music.tracks(4, N, 123, "cpu").float() / 32768.0
    peak = x.abs().amax(dim=(1, 2))
    assert (peak > 0.01).all() and (peak < 1.0).all()
    # digital silence: some whole 512-sample frames are zero, not most
    frames = x[..., :N // 512 * 512].reshape(4, 2, -1, 512)
    silent = (frames == 0).all(dim=-1).all(dim=1).float().mean()
    assert 0.0 < silent < 0.1
    # the channels are correlated but not equal
    c = torch.corrcoef(torch.stack([x[0, 0], x[0, 1]]))[0, 1]
    assert 0.2 < c < 1.0
