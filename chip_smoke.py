"""Card check of the PyTorch / CUDA port (atracdenc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. device   — CUDA present; torch / CUDA versions, card name and power limit
  2. build    — nvcc builds csrc/*.cu (kernels A, B, C) from this checkout
  3. kernels  — each kernel against its plain PyTorch version on the inputs
                the main path gives it at 64 streams x 2 ch x 256 frames:
                A vlc equal and err within 4 ulp; B e2 / accept bit-equal;
                C wl / num_bfu / mode equal for auto and --bfuidxconst
  4. golden   — tests/golden encodes on CUDA against the reference frames
                (identity floors 0.99, 0.98, 0.85)
  5. rate     — bytes with kernel C == bytes with the tensor-op rate path
  6. real size — the bench corpus (seed 42, 997 Hz + noise, 64 x 256 stereo
                frames) through encode + frame.pack; stereo frames/s.  Launch
                counters are zeroed just before and must all rise.
  7. CLI      — a 30 s stereo WAV through the port's cli.main to .oma
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


def main():
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false — needs a GPU")
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from atracdenc_tpu_torch import cli, kernels, runtime
    from atracdenc_tpu_torch.shared import frame, oma, wav
    from atracdenc_tpu_torch.models.atrac3 import bitalloc, encoder
    from atracdenc_tpu_torch.ops import greedy, quant, quant_cost, rate_control

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

    # --- 3. kernels at the main-path shapes: capture the inputs each kernel
    # gets during one encode of the bench corpus
    pcm = bench_corpus(STREAMS, NFRAMES)
    x = torch.from_numpy(pcm).to(dev)
    calls = {"A": [], "B": [], "C": []}
    sites = [(bitalloc, "quant_cost_plain", "A"), (quant, "greedy_scan", "B"),
             (bitalloc, "rate_control_block", "C")]
    originals = {}
    for mod, name, key in sites:
        orig = getattr(mod, name)
        originals[(mod, name)] = orig

        def wrapped(*a, _orig=orig, _key=key, **kw):
            calls[_key].append((a, kw))
            return _orig(*a, **kw)
        setattr(mod, name, wrapped)
    encoder.encode_frames(x, no_gain_control=False, no_tonal=False)
    torch.cuda.synchronize()
    for (mod, name), orig in originals.items():
        setattr(mod, name, orig)
    assert all(calls.values()), {k: len(v) for k, v in calls.items()}

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
    del calls, b_calls, a_args, c_args
    torch.cuda.empty_cache()

    # --- 4. golden (reference-oracle frames)
    gdir = os.path.join(ROOT, "tests", "golden")
    g3 = np.load(os.path.join(gdir, "at3_golden.npz"))
    gd = np.load(os.path.join(gdir, "at3_default_golden.npz"))
    counts0 = (quant_cost.launches, greedy.launches, rate_control.launches)
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
    counts1 = (quant_cost.launches, greedy.launches, rate_control.launches)
    assert all(b > a for a, b in zip(counts0, counts1)), (counts0, counts1)

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

    # --- 6. real size, main path; counters zeroed just before
    encoder.encode_frames(x, no_gain_control=False, no_tonal=False)  # warm
    torch.cuda.synchronize()
    quant_cost.launches = greedy.launches = rate_control.launches = 0
    t0 = time.perf_counter()
    planes = encoder.encode_frames(x, no_gain_control=False, no_tonal=False)
    torch.cuda.synchronize()
    t_enc = time.perf_counter() - t0
    host = {k: runtime.to_numpy(v) for k, v in planes.items()}
    frames_out = [frame.pack({k: v[s] for k, v in host.items()}, 384)
                  for s in range(STREAMS)]
    t_all = time.perf_counter() - t0
    launches = {"quant_cost_plain": quant_cost.launches,
                "greedy_scan": greedy.launches,
                "rate_control_block": rate_control.launches}
    assert all(v > 0 for v in launches.values()), launches
    fr = np.stack(frames_out)
    assert fr.shape == (STREAMS, NFRAMES, 384), fr.shape
    assert np.isfinite(host["loudness"]).all()
    assert (host["num_bfu"] >= 1).all() and (host["num_bfu"] <= 32).all()
    n_st = STREAMS * NFRAMES
    log(f"[6 real size] {STREAMS} x {NFRAMES} stereo frames: encode "
        f"{t_enc:.3f} s = {n_st / t_enc:.1f} stereo frames/s; encode + "
        f"frame.pack {t_all:.3f} s = {n_st / t_all:.1f} stereo frames/s "
        f"| {smi} | launches {launches}")

    # --- 7. CLI on a 30 s WAV (chunked path: > 1024 frames)
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
    c0 = (quant_cost.launches, greedy.launches, rate_control.launches)
    cli.main(["-e", "atrac3", "-i", wav_in, "-o", oma_out, "--nostdout"])
    c1 = (quant_cost.launches, greedy.launches, rate_control.launches)
    frames_cli, info = oma.read(oma_out)
    want = -(-n // 1024)
    assert frames_cli.shape == (want, 384), (frames_cli.shape, want)
    assert info["codec"] == oma.CODEC_ATRAC3
    assert all(b > a for a, b in zip(c0, c1)), (c0, c1)
    log(f"[7 cli] 30 s WAV -> {os.path.relpath(oma_out, ROOT)}: "
        f"{frames_cli.shape[0]} frames of 384 bytes, launches {c0} -> {c1}")

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
