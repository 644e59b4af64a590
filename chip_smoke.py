"""Card check of the PyTorch / CUDA port (atracdenc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. device   — CUDA present; torch / CUDA versions, card name and power limit
  2. build    — nvcc builds csrc/*.cu (kernels A, B, C, E) from this checkout
  3. kernels  — each kernel against its plain PyTorch version on the inputs
                its path gives it: A, B, C at the ATRAC3 main path's 64
                streams x 2 ch x 256 frames (A vlc equal and err within 4
                ulp; B e2 / accept bit-equal; C wl / num_bfu / mode equal
                for auto and --bfuidxconst); E at the ATRAC1 bench leg's
                8 streams x 2 ch x 512 frames (bfu_idx / wl equal for auto
                and --bfuidxconst 4)
  4. golden   — tests/golden encodes on CUDA against the reference frames:
                ATRAC3 identity floors 0.99, 0.98, 0.85; ATRAC1 0.93 and
                0.97; the ATRAC1 decoder within 2e-4 of the reference
                decoder's PCM
  5. rate     — bytes with kernel C == bytes with the tensor-op rate path
  6. ATRAC3 real size — the bench corpus (seed 42, 997 Hz + noise, 64 x 256
                stereo frames) through ``encode_frames_bytes`` (encode +
                device packer), with A, B, C's counters zeroed just before;
                then encode + host ``frame.pack``: equal bytes, both rates
  7. ATRAC1 real size — bench.py's AT1 leg (the corpus cut to 8 streams x
                512 frames): encode + device packer in sound units/s, E's
                counter zeroed just before; bytes equal the host packer's
  8. CLI      — a 30 s stereo WAV through the port's cli.main: ATRAC3 to
                .oma; ATRAC1 to .aea and -d back to WAV (RMS within 1 dB)
The last two lines of stdout are the card's nvidia-smi name / power limit
(preceded by the kernels JSON line) and {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAMS, CHANNELS, NFRAMES = 64, 2, 256
AT1_STREAMS, AT1_FRAMES = 8, 512          # bench.py:220, pcm[:8, :, :512 * 512]


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps, warmup=1):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_corpus(streams, nframes):
    """bench.py's AT3 corpus: 997 Hz tone (ch1 at 0.8) + 0.05 noise, seed 42."""
    import numpy as np
    t = 1024 * nframes
    rng = np.random.default_rng(42)
    n = np.arange(t, dtype=np.float64)
    base = 0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
    return np.clip(base[None, None, :] * np.asarray([1.0, 0.8])[None, :, None]
                   + 0.05 * rng.standard_normal((streams, CHANNELS, t)),
                   -1, 1).astype(np.float32)


def capture(sites, fn):
    """Run fn() with each (module, name, key) call site wrapped to record
    its arguments; returns {key: [(args, kwargs), ...]}."""
    calls = {key: [] for _, _, key in sites}
    originals = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for (mod, name, key), (_, _, orig) in zip(sites, originals):
        def wrapped(*a, _orig=orig, _key=key, **kw):
            calls[_key].append((a, kw))
            return _orig(*a, **kw)
        setattr(mod, name, wrapped)
    try:
        fn()
    finally:
        for mod, name, orig in originals:
            setattr(mod, name, orig)
    assert all(calls.values()), {k: len(v) for k, v in calls.items()}
    return calls


AT1_PLANES = ("short_mask", "bfu_idx", "wordlen", "sfi", "mant")


def at1_units(planes):
    """ATRAC1 planes [S, C, F, ...] -> [S*F*C, ...] in stream order, as
    bench.py merges them per stream before packing."""
    return {k: planes[k].transpose(1, 2).reshape((-1,) + planes[k].shape[3:])
            for k in AT1_PLANES}


def main():
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false — needs a GPU")
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from atracdenc_tpu_torch import cli, kernels, runtime
    from atracdenc_tpu_torch.shared import aea, at1_frame, audio, frame, oma, wav
    from atracdenc_tpu_torch.models.atrac1 import decoder as at1_decoder
    from atracdenc_tpu_torch.models.atrac1 import device_pack as at1_pack
    from atracdenc_tpu_torch.models.atrac1 import encoder as at1_encoder
    from atracdenc_tpu_torch.models.atrac3 import bitalloc, device_pack, encoder
    from atracdenc_tpu_torch.ops import (at1_alloc, greedy, quant, quant_cost,
                                         rate_control)
    mods = (quant_cost, greedy, rate_control, at1_alloc)

    def counts():
        return tuple(m.launches for m in mods)

    # --- 1. device
    dev = runtime.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[1 device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} | {smi}")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32

    # --- 2. build
    path, build_s = kernels.build(verbose=True)
    kernels.library()
    log(f"[2 build] {os.path.relpath(path, ROOT)} built in {build_s:.1f} s")

    # --- 3. kernels at their paths' shapes: capture the inputs each kernel
    # gets during one encode of the bench corpus
    pcm = bench_corpus(STREAMS, NFRAMES)
    x = torch.from_numpy(pcm).to(dev)
    x1 = torch.from_numpy(pcm[:AT1_STREAMS, :, :512 * AT1_FRAMES]).to(dev)
    calls = capture([(bitalloc, "quant_cost_plain", "A"), (quant, "greedy_scan", "B"),
                     (bitalloc, "rate_control_block", "C")],
                    lambda: encoder.encode_frames(x, no_gain_control=False,
                                                  no_tonal=False))
    calls.update(capture([(at1_encoder, "at1_allocate_block", "E")],
                         lambda: at1_encoder.encode_frames(x1)))
    torch.cuda.synchronize()

    rows = []

    (a_args, _), = calls["A"]
    err_k, vlc_k = quant_cost.quant_cost_plain(*a_args)
    err_p, vlc_p = quant_cost.quant_cost_torch(*a_args)
    assert torch.equal(vlc_k, vlc_p), "kernel A: vlc differs"
    ulp = (err_k.view(torch.int32).long() - err_p.view(torch.int32).long()).abs()
    assert int(ulp.max()) <= 4, f"kernel A: err off by {int(ulp.max())} ulp"
    a_err = float((err_k - err_p).abs().max())
    a_ms = cuda_ms(lambda: quant_cost.quant_cost_plain(*a_args), 20, 3)
    a_pms = cuda_ms(lambda: quant_cost.quant_cost_torch(*a_args), 5, 1)
    log(f"[3 kernels] A quant_cost_plain {tuple(a_args[0].shape)}: vlc equal, "
        f"err <= {int(ulp.max())} ulp; kernel {a_ms:.3f} ms, plain {a_pms:.3f} ms")
    rows.append(("quant_cost_plain", "atracdenc_tpu_torch/csrc/quant_cost.cu",
                 "atracdenc_tpu/ops/pallas_quant.py:339", a_err, a_ms, a_pms))

    b_calls = [a for a, _ in calls["B"]]
    b_err = 0.0
    for a in b_calls:
        e2k, acck = greedy.greedy_scan(*a)
        e2p, accp = greedy.greedy_torch(*a)
        # e2 is NaN on the rows of wordlen 0 (mul 0, final_mantissas): NaN
        # on both sides counts as equal
        both_nan = torch.isnan(e2k) & torch.isnan(e2p)
        assert bool(((e2k == e2p) | both_nan).all()) and torch.equal(acck, accp), \
            f"kernel B differs at {tuple(a[0].shape)}"
        b_err = max(b_err, float(torch.where(both_nan, 0.0, e2k - e2p).abs().max()))
    b_ms = cuda_ms(lambda: [greedy.greedy_scan(*a) for a in b_calls], 10, 2)
    b_pms = cuda_ms(lambda: [greedy.greedy_torch(*a) for a in b_calls], 2, 1)
    log(f"[3 kernels] B greedy_scan {len(b_calls)} calls "
        f"{[tuple(a[0].shape) for a in b_calls]}: bit-equal; all calls "
        f"kernel {b_ms:.3f} ms, plain {b_pms:.3f} ms")
    rows.append(("greedy_scan", "atracdenc_tpu_torch/csrc/greedy.cu",
                 "atracdenc_tpu/ops/pallas_greedy.py:47", b_err, b_ms, b_pms))

    (c_args, c_kw), = calls["C"]
    c_err = 0.0
    for auto in (True, False):
        kw = dict(c_kw, auto=auto)
        outk = rate_control.rate_control_block(*c_args, **kw)
        outp = rate_control.rate_control_torch(*c_args, **kw)
        for name, k_, p_ in zip(("num_bfu", "mode", "wl"), outk, outp):
            assert torch.equal(k_.to(p_.dtype), p_), \
                f"kernel C (auto={auto}): {name} differs"
            c_err = max(c_err, float((k_.int() - p_.int()).abs().max()))
    c_ms = cuda_ms(lambda: rate_control.rate_control_block(*c_args, **c_kw), 5, 1)
    c_pms = cuda_ms(lambda: rate_control.rate_control_torch(*c_args, **c_kw), 2, 1)
    log(f"[3 kernels] C rate_control_block {tuple(c_args[0].shape)}: num_bfu/"
        f"mode/wl equal (auto and fixed); kernel {c_ms:.3f} ms, "
        f"plain {c_pms:.3f} ms")
    rows.append(("rate_control_block", "atracdenc_tpu_torch/csrc/rate_control.cu",
                 "atracdenc_tpu/ops/pallas_rate.py:242", c_err, c_ms, c_pms))

    (e_args, e_kw), = calls["E"]
    e_err = 0.0
    for const in (e_kw["bfu_idx_const"], 4):
        idx_k, wl_k = at1_alloc.at1_allocate_block(*e_args, bfu_idx_const=const)
        idx_p, wl_p = at1_alloc.at1_allocate_torch(*e_args, bfu_idx_const=const)
        assert torch.equal(idx_k, idx_p) and torch.equal(wl_k, wl_p), \
            f"kernel E (bfu_idx_const={const}) differs"
        e_err = max(e_err, float((wl_k - wl_p).abs().max()),
                    float((idx_k - idx_p).abs().max()))
    e_ms = cuda_ms(lambda: at1_alloc.at1_allocate_block(*e_args, **e_kw), 20, 3)
    e_pms = cuda_ms(lambda: at1_alloc.at1_allocate_torch(*e_args, **e_kw), 3, 1)
    log(f"[3 kernels] E at1_allocate_block {tuple(e_args[0].shape)}: bfu_idx/wl "
        f"equal (auto and --bfuidxconst 4); kernel {e_ms:.3f} ms, "
        f"plain {e_pms:.3f} ms")
    rows.append(("at1_allocate_block", "atracdenc_tpu_torch/csrc/at1_alloc.cu",
                 "atracdenc_tpu/ops/pallas_alloc.py:362", e_err, e_ms, e_pms))
    del calls, b_calls, a_args, c_args, e_args
    torch.cuda.empty_cache()

    # --- 4. golden (reference-oracle frames)
    gdir = os.path.join(ROOT, "tests", "golden")
    g3 = np.load(os.path.join(gdir, "at3_golden.npz"))
    gd = np.load(os.path.join(gdir, "at3_default_golden.npz"))
    counts0 = counts()
    for label, pcm_g, ref, floor, nogain in (
            ("at3_golden (no gain, no tonal)", g3["pcm_in"], g3["ref_frames"],
             0.99, True),
            ("at3_default_golden pcm_in", gd["pcm_in"], gd["ref_frames"],
             0.98, False),
            ("at3_default_golden pcm_stress", gd["pcm_stress"], gd["ref_stress"],
             0.85, False)):
        planes = encoder.encode_track(pcm_g, no_gain_control=nogain,
                                      no_tonal=nogain, device="cuda")
        ident = float((frame.pack(planes, 384) == ref).mean())
        log(f"[4 golden] {label}: byte identity vs reference {ident:.4f} "
            f"(floor {floor})")
        assert ident >= floor, label
    # ATRAC1: identity over every frame of the reference AEA (its first
    # frame is the writer's zero dummy), as the port's CPU tests count it
    for name, ref_file, floor in (("at1_golden", "at1_ref.aea", 0.93),
                                  ("at1_stress_pcm", "at1_stress_ref.aea", 0.97)):
        pcm_g = np.load(os.path.join(gdir, f"{name}.npz"))["pcm_in"]
        planes = at1_encoder.encode_track(pcm_g, device="cuda")
        units = at1_frame.pack({k: np.swapaxes(planes[k], 0, 1).reshape(
            (-1,) + planes[k].shape[2:]) for k in AT1_PLANES})
        ref, _, _, _ = aea.read(os.path.join(gdir, ref_file))
        ident = float((units == ref).mean())
        log(f"[4 golden] {name} (ATRAC1): byte identity vs reference "
            f"{ident:.5f} (floor {floor})")
        assert ident >= floor, name
    counts1 = counts()
    assert all(b > a for a, b in zip(counts0, counts1)), (counts0, counts1)
    frames_ref, ch, _, _ = aea.read(os.path.join(gdir, "at1_ref.aea"))
    up = at1_frame.unpack(frames_ref)
    split = {k: torch.from_numpy(v.reshape((-1, ch) + v.shape[1:]).swapaxes(0, 1)
                                 .copy()).to(dev)
             for k, v in up.items() if k != "valid"}
    pcm_dec = at1_decoder.decode_frames(split["short_mask"], split["wordlen"],
                                        split["sfi"], split["mant"])
    ref_dec = np.load(os.path.join(gdir, "at1_golden.npz"))["ref_decoded"]
    n_dec = min(ref_dec.shape[1], pcm_dec.shape[1])
    dec_err = float(np.abs(runtime.to_numpy(pcm_dec)[:, :n_dec]
                           - ref_dec[:, :n_dec]).max())
    log(f"[4 golden] at1_ref.aea decoded on CUDA: max |err| vs the reference "
        f"decoder {dec_err:.3g} (bound 2e-4)")
    assert dec_err < 2e-4, dec_err

    # --- 5. both rate-control paths give the same bytes
    sub = x[:8]
    pk = encoder.encode_frames(sub, no_gain_control=False, no_tonal=False)
    pp = encoder.encode_frames(sub, no_gain_control=False, no_tonal=False,
                               use_rate_kernel=False)
    for key in ("num_bfu", "coding_mode", "wordlen", "mant"):
        assert torch.equal(pk[key], pp[key]), f"rate paths differ: {key}"
    for s in range(sub.shape[0]):
        bk = frame.pack({k: runtime.to_numpy(v[s]) for k, v in pk.items()}, 384)
        bp = frame.pack({k: runtime.to_numpy(v[s]) for k, v in pp.items()}, 384)
        assert np.array_equal(bk, bp), f"rate paths: bytes differ, stream {s}"
    log(f"[5 rate] kernel C and the tensor-op rate path: equal planes and "
        f"bytes on {sub.shape[0]} x {NFRAMES} stereo frames")

    # --- 6. ATRAC3 real size, main path (encode + device packer); A, B, C's
    # counters zeroed just before and read just after
    opts = dict(no_gain_control=False, no_tonal=False)
    encoder.encode_frames_bytes(x, **opts)                  # warm
    torch.cuda.synchronize()
    quant_cost.launches = greedy.launches = rate_control.launches = 0
    t0 = time.perf_counter()
    dev_bytes = encoder.encode_frames_bytes(x, **opts)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    launches = {"quant_cost_plain": quant_cost.launches,
                "greedy_scan": greedy.launches,
                "rate_control_block": rate_control.launches}
    assert all(v > 0 for v in launches.values()), launches
    fr_dev = runtime.to_numpy(dev_bytes)
    t_all_dev = time.perf_counter() - t0
    # encode + host packer, and the device packer alone on the same planes
    t0 = time.perf_counter()
    planes = encoder.encode_frames(x, **opts)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    host = {k: runtime.to_numpy(v) for k, v in planes.items()}
    frames_out = [frame.pack({k: v[s] for k, v in host.items()}, 384)
                  for s in range(STREAMS)]
    t_all = time.perf_counter() - t0
    t0 = time.perf_counter()
    packed = device_pack.pack_device_batch(planes, 384)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    fr = np.stack(frames_out)
    assert fr.shape == (STREAMS, NFRAMES, 384), fr.shape
    assert np.array_equal(fr_dev, fr), \
        f"device packer: {int((fr_dev != fr).sum())} bytes differ from frame.pack"
    assert np.array_equal(runtime.to_numpy(packed), fr)
    assert np.isfinite(host["loudness"]).all()
    assert (host["num_bfu"] >= 1).all() and (host["num_bfu"] <= 32).all()
    n_st = STREAMS * NFRAMES
    log(f"[6 real size] {STREAMS} x {NFRAMES} stereo frames: encode + device "
        f"pack {t_dev:.3f} s = {n_st / t_dev:.1f} stereo frames/s "
        f"({n_st / t_all_dev:.1f} with the bytes on the host); device pack "
        f"alone {t_pack * 1e3:.1f} ms; encode {t_enc:.3f} s = "
        f"{n_st / t_enc:.1f}; encode + frame.pack {t_all:.3f} s = "
        f"{n_st / t_all:.1f} stereo frames/s; bytes equal | {smi} | "
        f"launches {launches}")

    # --- 7. ATRAC1 real size: bench.py's AT1 leg; E's counter zeroed just
    # before and read just after
    at1_pack.pack_device(at1_units(at1_encoder.encode_frames(x1)))   # warm
    torch.cuda.synchronize()
    at1_alloc.launches = 0
    t0 = time.perf_counter()
    planes1 = at1_encoder.encode_frames(x1)
    units_dev = at1_pack.pack_device(at1_units(planes1))
    torch.cuda.synchronize()
    t1 = time.perf_counter() - t0
    launches["at1_allocate_block"] = at1_alloc.launches
    assert at1_alloc.launches > 0, at1_alloc.launches
    n_units = AT1_STREAMS * CHANNELS * AT1_FRAMES
    units_host = at1_frame.pack({k: runtime.to_numpy(v)
                                 for k, v in at1_units(planes1).items()})
    assert units_dev.shape == (n_units, 212)
    assert np.array_equal(runtime.to_numpy(units_dev), units_host), \
        "ATRAC1 device packer differs from frame.pack"
    log(f"[7 atrac1 real size] {AT1_STREAMS} x {CHANNELS} x {AT1_FRAMES} "
        f"sound units: encode + device pack {t1:.4f} s = {n_units / t1:.1f} "
        f"units/s; bytes equal the host packer's | {smi} | launches "
        f"{at1_alloc.launches}")

    # --- 8. CLI on a 30 s WAV (chunked paths: > 1024 AT3 / 2048 AT1 frames)
    work = os.path.join(kernels.BUILD_DIR, "smoke")
    os.makedirs(work, exist_ok=True)
    wav_in = os.path.join(work, "in30s.wav")
    oma_out = os.path.join(work, "out30s.oma")
    n = 44100 * 30
    rng = np.random.default_rng(7)
    tt = np.arange(n) / 44100.0
    sig = 0.4 * np.sin(2 * np.pi * 440 * tt) * np.exp(-((tt % 2.0) * 2.0))
    pcm30 = np.clip(np.stack([sig, 0.7 * sig])
                    + 0.02 * rng.standard_normal((2, n)), -1, 1)
    wav.write(wav_in, pcm30.astype(np.float32), 44100)
    c0 = counts()
    cli.main(["-e", "atrac3", "-i", wav_in, "-o", oma_out, "--nostdout"])
    c1 = counts()
    frames_cli, info = oma.read(oma_out)
    want = -(-n // 1024)
    assert frames_cli.shape == (want, 384), (frames_cli.shape, want)
    assert info["codec"] == oma.CODEC_ATRAC3
    assert all(b > a for a, b in zip(c0[:3], c1[:3])), (c0, c1)
    log(f"[8 cli] 30 s WAV -> {os.path.relpath(oma_out, ROOT)}: "
        f"{frames_cli.shape[0]} frames of 384 bytes, launches {c0} -> {c1}")
    aea_out = os.path.join(work, "out30s.aea")
    wav_back = os.path.join(work, "back30s.wav")
    cli.main(["-e", "atrac1", "-i", wav_in, "-o", aea_out, "--nostdout"])
    c2 = counts()
    assert c2[3] > c1[3], (c1, c2)
    cli.main(["-d", "-i", aea_out, "-o", wav_back, "--nostdout"])
    units_cli, ch, _, length = aea.read(aea_out)
    back, rate = audio.read(wav_back)
    assert units_cli.shape == (2 * -(-n // 512), 212) and ch == 2
    assert rate == 44100 and back.shape == (2, length), (back.shape, length)
    seg = slice(1024, length - 1024)
    gain_db = 20 * np.log10(np.sqrt(np.mean(back[:, seg] ** 2))
                            / np.sqrt(np.mean(pcm30[:, seg] ** 2)))
    assert abs(gain_db) < 1.0, gain_db
    log(f"[8 cli] 30 s WAV -> {os.path.relpath(aea_out, ROOT)}: "
        f"{units_cli.shape[0]} sound units, -d back to WAV: RMS "
        f"{gain_db:+.3f} dB against the input, E launches {c1[3]} -> {c2[3]}")

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": err, "ms": ms,
         "plain_ms": pms} for name, src, rep, err, ms, pms in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
