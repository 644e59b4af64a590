"""Seeded, music-like stereo PCM at 44.1 kHz, made on the device.

The benchmark's stand-in for real recordings (the repository holds no
audio corpus).  Every property is there to make a stage of the encoders
do real work; the numbers were chosen for that, not measured from music,
and stay provisional until recordings are in the repository.  What the
upstream encoder makes of them (per channel-frame: ATRAC3 gain points and
tonal components, ATRAC1 short windows) is in PERF.md, section 4:

* notes of 3 to 40 harmonic partials (amplitudes 1/k**a) with a slow
  vibrato (4-6 Hz, 0.1-0.5 %): spectral peaks that ATRAC3's tonal
  extractor finds and codes as tonal components;
* note onsets every 0.2-1.0 s with a 2 ms attack and an exponential
  decay: transients that place ATRAC3's gain-control points and switch
  ATRAC1's bands to short windows;
* a band-limited noise bed (a random band of 1-16 kHz, 25-45 dB under
  the notes): a dense spectrum for the scaler and the bit allocation;
* phrase levels from -30 to -3 dBFS, changed every 4-10 s: quiet and loud
  frames, so that the loudness IIR and the ATH gate decide differently;
* a left/right correlation from 0.3 to 1 per track: both channels carry
  their own bits (joint stereo is off in the configurations here);
* three gaps of digital silence of 0.5-2 s per track (at most 1 % of it
  each, so 1-4 % of a track of 150-300 s):
  all-zero frames, which the encoders meet between tracks.

``tracks(n, samples, seed, device)`` gives int16 [n, 2, samples], as
16-bit files hold it.  The same seed gives the same samples on the same
kind of device; every parameter is drawn with one ``torch.Generator`` on
that device, in a few large calls.
"""
import math

import torch

RATE = 44100
BLOCK = 10 * RATE          # samples made per step (bounds device memory)
MAX_PARTIALS = 40


def _uniform(g, shape, lo, hi, dev):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)


def _draw(g, n, samples, dev):
    """Per-track and per-note parameters of ``n`` tracks."""
    secs = samples / RATE
    max_notes = int(math.ceil(secs / 0.2)) + 2
    p = {}
    gaps = _uniform(g, (n, max_notes), 0.2, 1.0, dev)
    p["onset"] = torch.cumsum(gaps, dim=1) - gaps[:, :1]       # s, from 0
    p["f0"] = torch.exp(_uniform(g, (n, max_notes), math.log(80.0),
                                 math.log(1000.0), dev))
    p["decay"] = _uniform(g, (n, max_notes), 0.08, 0.8, dev)   # s
    p["partials"] = torch.randint(3, MAX_PARTIALS + 1, (n, 1), generator=g,
                                  device=dev)
    p["tilt"] = _uniform(g, (n, 1), 0.7, 1.6, dev)
    p["vib_rate"] = _uniform(g, (n, 1), 4.0, 6.0, dev)
    p["vib_depth"] = _uniform(g, (n, 1), 0.001, 0.005, dev)
    p["noise_db"] = _uniform(g, (n, 1), -45.0, -25.0, dev)
    lo = torch.exp(_uniform(g, (n, 1), math.log(1000.0), math.log(8000.0),
                            dev))
    p["band"] = (lo, torch.minimum(lo * _uniform(g, (n, 1), 1.5, 4.0, dev),
                                   torch.full_like(lo, 16000.0)))
    phrases = int(math.ceil(secs / 4.0)) + 1
    plen = _uniform(g, (n, phrases), 4.0, 10.0, dev)
    p["phrase_start"] = torch.cumsum(plen, dim=1) - plen[:, :1]
    p["phrase_db"] = _uniform(g, (n, phrases), -30.0, -3.0, dev)
    p["rho"] = _uniform(g, (n, 1), 0.3, 1.0, dev)
    p["gap_len"] = torch.clamp(_uniform(g, (n, 3), 0.5, 2.0, dev),
                               max=0.01 * secs)
    p["gap_start"] = _uniform(g, (n, 3), 0.0, 1.0, dev) * (secs - p["gap_len"])
    p["noise_seed"] = int(torch.randint(0, 2 ** 62, (1,), generator=g,
                                        device=dev))
    return p


def _band_noise(g, n, length, band, dev):
    """[n, 2, length] Gaussian noise kept to each track's band (FFT mask)."""
    x = torch.randn((n, 2, length), generator=g, device=dev)
    spec = torch.fft.rfft(x, dim=-1)
    freqs = torch.fft.rfftfreq(length, 1.0 / RATE).to(dev)
    keep = (freqs[None, :] >= band[0]) & (freqs[None, :] < band[1])
    width = (band[1] - band[0]) / (RATE / 2)
    spec = spec * keep[:, None, :] / torch.sqrt(width)[:, None, :]
    return torch.fft.irfft(spec, n=length, dim=-1)


def _block(p, g, a, b, dev):
    """Samples [a, b) of every track: float32 [n, 2, b - a]."""
    n = p["f0"].shape[0]
    t = (torch.arange(a, b, device=dev, dtype=torch.float64) / RATE)
    t = t[None, :].expand(n, -1).contiguous()
    note = torch.searchsorted(p["onset"], t, right=True) - 1    # [n, L]
    since = (t - torch.gather(p["onset"].double(), 1, note)).float()
    f0 = torch.gather(p["f0"], 1, note)
    decay = torch.gather(p["decay"], 1, note)
    env = torch.clamp(since / 0.002, max=1.0) * torch.exp(-since / decay)
    tf = t.float()
    vib = p["vib_depth"] / (2 * math.pi * p["vib_rate"]) * torch.sin(
        2 * math.pi * p["vib_rate"] * tf)
    phase = 2 * math.pi * f0 * (since + vib)                    # fundamental
    weights = torch.arange(1, MAX_PARTIALS + 1, device=dev)[None, :] \
        .float() ** (-p["tilt"])                                # [n, K]
    weights = torch.where(torch.arange(1, MAX_PARTIALS + 1, device=dev)[None]
                          <= p["partials"], weights, 0.0)
    weights = weights / weights.sum(dim=1, keepdim=True)
    tone_l = torch.zeros_like(tf)
    tone_r = torch.zeros_like(tf)
    for k in range(1, MAX_PARTIALS + 1):
        w = weights[:, k - 1:k]
        alias = (k * f0 < RATE / 2).float()                     # no aliasing
        tone_l += w * alias * torch.sin(k * phase)
        tone_r += w * alias * torch.sin(k * phase + 0.7 * k)
    noise = _band_noise(g, n, b - a, p["band"], dev)
    nl = 10.0 ** (p["noise_db"] / 20.0)
    left = env * tone_l + nl * noise[:, 0]
    other = env * tone_r + nl * noise[:, 1]
    right = p["rho"] * left + torch.sqrt(1 - p["rho"] ** 2) * other
    phrase = torch.searchsorted(p["phrase_start"], tf.contiguous(),
                                right=True) - 1
    level = 10.0 ** (torch.gather(p["phrase_db"], 1, phrase) / 20.0)
    silent = torch.zeros_like(tf, dtype=torch.bool)
    for j in range(p["gap_start"].shape[1]):
        s0 = p["gap_start"][:, j:j + 1]
        silent |= (tf >= s0) & (tf < s0 + p["gap_len"][:, j:j + 1])
    gain = torch.where(silent, 0.0, level)
    return torch.stack([left, right], dim=1) * gain[:, None, :]


def tracks(n, samples, seed, device):
    """int16 [n, 2, samples] of ``n`` seeded music-like stereo tracks."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    p = _draw(g, n, samples, dev)
    gn = torch.Generator(device=dev)
    gn.manual_seed(p["noise_seed"])
    out = torch.empty((n, 2, samples), dtype=torch.int16, device=dev)
    for a in range(0, samples, BLOCK):
        b = min(a + BLOCK, samples)
        x = _block(p, gn, a, b, dev)
        out[..., a:b] = torch.clamp(torch.round(x * 32768.0), -32768,
                                    32767).to(torch.int16)
    return out
