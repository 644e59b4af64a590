"""Card check of the PyTorch / CUDA port (atracdenc_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each asserts; any failure exits non-zero):
  1. device   — CUDA present; torch / CUDA versions, card name and power limit
  2. build    — nvcc builds csrc/*.cu (kernels A to J) from this
                checkout, one nvcc per source, all at once; prints ptxas's
                registers, shared memory, stack and spills of every kernel
                (A to J)
  3. kernels  — each kernel against its plain PyTorch version on the inputs
                its path gives it: A, B, C at the ATRAC3 main path's 64
                streams x 2 ch x 256 frames (A vlc equal and err within 4
                ulp; B e2 / accept bit-equal; C wl / num_bfu / mode equal
                for auto and --bfuidxconst); D at the same corpus encoded
                with the fused memo (vlc equal, err within 4 ulp; timed
                beside the A + B memo on the same input); F on C's inputs
                (wl equal to its plain version and to C with auto=False);
                E at the ATRAC1 bench leg's 8 streams x 2 ch x 512 frames
                (bfu_idx / wl equal for auto and --bfuidxconst 4; timed
                beside the launch floor, a one-element add_); prints a
                SHA-256 of A's and of D's err and vlc and of E's bfu_idx
                and wl, so that two builds run on one card can be held bit
                against bit; G (the bit deposit, ``deposit_fields``) on the
                fields of both packers tiled to the cells' shapes (ATRAC1's
                65,536 units of 212 B, ATRAC3's two channel deposits of
                32,768 frames), bytes equal to its plain version, timed
                beside its bound (the field planes' bytes) and the plain
                version, with a SHA-256 of its bytes; H (ATRAC3+ GHA's
                greedy rounds, ``gha.greedy``) on both passes' inputs of
                one ``atrac3plus.batch`` call (64 tracks x 512 frames,
                529,408 lanes), integer planes equal its plain version's
                on >= 99.5% of lanes, timed beside its bound (the
                lane-rounds it computed x 524,288 FLOP at 67 TFLOP/s) and
                the plain ``_greedy``, with the lane-rounds' share of the
                plain version's and a SHA-256 of its planes; I (ATRAC3+'s
                spectrum fields, ``device_pack.spectrum_fields``) on both
                channels' inputs of the same call (32,768 frames a
                channel), values, widths, offsets and bits equal its plain
                version, timed beside its bound (the bytes it reads and
                writes) and the plain version, with a SHA-256 of its planes;
                J (ATRAC3's gain upsampler and AnalyzeGain,
                ``gain.gain_analysis``) on one ``atrac3-lp2.batch`` call's
                windows (64 music tracks x 512 frames, 262,144 windows),
                gain, lo, hi and hfr within ``testing.GAIN_TOL`` of the
                plain route, timed beside its bound (512 x 2,560
                multiply-adds a window at 67 TFLOP/s) and the plain route,
                with the plain route's three GEMMs alone, as the program
                lays out their windows and on contiguous windows, and a
                SHA-256 of its planes
  4. golden   — tests/golden encodes on CUDA against the reference frames:
                ATRAC3 identity floors 0.99, 0.98, 0.85, with the A + B
                memo and again with the fused memo (kernel D); ATRAC1 0.93
                and 0.97; the ATRAC1 decoder within 2e-4 of the reference
                decoder's PCM; the ATRAC3 QA decoder on ref_c.{oma,at3,rm}
                and ref_js.oma within 1e-5 of itself on the CPU; the
                quality-parity gate of tests/test_at3_decoder.py on CUDA
                (PSNR of the port's frames > the reference frames' - 0.05 dB);
                ATRAC3+ at3p_golden (pcm_mixed, pcm_loud, GHA off) identity
                floor 0.99 against the reference writer's frames
  5. rate     — bytes with kernel C == bytes with the tensor-op rate path
  6. ATRAC3 real size — the bench corpus (seed 42, 997 Hz + noise, 64 x 256
                stereo frames) through ``encode_frames_bytes`` (encode +
                device packer), with A, B, C's counters zeroed just before;
                then encode + host ``frame.pack``: equal bytes, both rates,
                and a SHA-256 of the frame bytes
  7. ATRAC1 real size — bench.py's AT1 leg (the corpus cut to 8 streams x
                512 frames): encode + device packer in sound units/s, E's
                counter zeroed just before; bytes equal the host packer's,
                and their SHA-256
  8. CLI      — a 30 s stereo WAV through the port's cli.main: ATRAC3 to
                .oma and -d back to WAV (RMS within 1 dB); ATRAC3 with
                --yaml-log (one document per whole frame); omainfo on the
                .oma; ATRAC1 to .aea and -d back to WAV (RMS within 1 dB);
                ATRAC3+ to .oma and -d back to WAV (RMS within 1 dB), and
                with --advanced ghadbg=15,ghawbrefine=1 to a valid .oma
  9. fused memo real size — phase 6's corpus through ``encode_frames_bytes``
                with ``fused_memo=True``, every counter zeroed just before:
                D, B (final mantissas) and C launch, A does not; stereo
                frames/s, a SHA-256 of the frame bytes, and the bytes'
                identity with phase 6's (>= 0.999, the bench's gate on the
                fused route; ``ops/quant.py::lane_sum`` gives both memos
                one e1 sum order, and the H100 has measured 1.0)
 10. ATRAC3 decode real size — phase 6's device-packed bytes of 8 streams
                (8 x 256 stereo frames of 384 B): host parse (unpack +
                dequantize) and device decode (``decode_frames`` on
                [16, 256, 1024]) timed apart, in stereo frames/s; output
                finite, within +-1, 256 * 1024 - 1162 samples long; one
                stream within 1e-5 of its CPU decode; a SHA-256 of the
                int16-rounded PCM; one more decode under torch.profiler:
                device busy ms, of which host <-> device copies
 11. ATRAC3+ real size — bench.py's AT3P leg (bench.py:94-110,230): the
                corpus cut to 8 streams x 128 stereo frames of 2048 B, full
                GHA (mask 7), through ``encode_frames_bytes`` (encode +
                device packer), warm, then timed three times; every kernel
                counter zeroed just before and read just after (ATRAC3+ runs
                none of A to F, G once a call, H 16 times, I twice); the
                bytes equal encode_track + host ``frame.pack`` stream by
                stream (cut to 4 streams when the host part would pass
                60 s), and their SHA-256; stream 0
                decoded on CUDA within 1e-5 of its CPU decode, finite,
                within +-1; one more encode under torch.profiler: device
                busy ms, the top device kernels and the launch count
 12. mesh     — the parent launches 4 rank processes on the card (dp 2 x
                sp 2, gloo; ``atracdenc_tpu_torch/parallel/``): phase 6's
                corpus through ``encode_batch_at3_bytes_sharded`` (SHA-256
                and byte identity against phase 6's bytes, >= 0.999, and
                the frames that differ), phase 7's leg through
                ``encode_batch_sharded`` (the values that differ from phase
                7's planes, at most 1e-3 of each), ``decode_batch_at1_sharded``
                over dp = 4 within 1e-6 of one process, the ATRAC3+ core
                at phase 11's shape (GHA 7) against one process; the
                counters of A, B, C and E read in every rank must be > 0;
                the sharded call's wall time beside phase 6's
 13. transcode — three 30 s stereo WAVs (phase 8's and two more) through
                ``python -m atracdenc_tpu_torch.tools.transcode`` for each
                codec, in one process and as --hosts 2 (two processes, a
                free coordinator port): each file written once, the same
                bytes, phase 8's WAV equal to ``cli.main``'s file (ATRAC3 at
                the CLI's 1024-frame chunks), --resume skipping all three;
                the "x realtime" lines
 14. bench    — ``atracdenc_tpu_torch.bench.main(["--repeats", "3"])`` in
                this process, every counter zeroed just before: its JSON
                line on a log line; platform cuda, every rate and its
                spread > 0, value the larger AT3 route; its three leg
                SHA-256s equal phases 6, 7 and 11; A, B, C and E launched
 15. modes    — every ATRAC3 mode of the JAX package on the card
                (``modes_phase``): (a) ``atracdenc_tpu_torch.selfcheck``'s five
                modes against the hash file's ``cuda`` key, and each mode's
                bytes against the CPU path's at identity >= 0.99, with the
                frames that differ; (b) LP4 joint stereo (192 B) and the
                plain mode (384 B, no gain control, no tonal) on phase 6's
                corpus through
                ``encode_frames_bytes``, the counters zeroed just before (A,
                B, C launch), bytes equal encode + host ``frame.pack``, their
                SHA-256 and stereo frames/s; (c) A, B and C against their
                plain versions at the joint-stereo encode's inputs (phase
                3's rules); (d) at3_js_golden (stereo > 0.99, mono > 0.85,
                the mono side channel 1 QMF band of num_bfu 1, the device
                packer equal to ``frame.pack``), at3_tonal_golden (> 0.99),
                at3_tonal_dense_golden (> 0.97); (e) ``cli.main`` on a 5 s
                stereo WAV through -e atrac3_lp4 and -e atrac3 --bitrate N
                for every CONTAINER_PARAMS row: frame size and joint-stereo
                flag read back with ``oma.read``, -d back within 1 dB RMS
 16. scaling  — ``atracdenc_tpu_torch.scaling_bench`` at 1, 2 and 4 rank
                processes on the card (all dp; each rank warm, then 3 timed
                calls): its table and JSON rows on log lines, the rows of
                each configuration >= 0.999 identical to 1 rank's bytes
 17. triage   — the byte-identity triage on the card (``triage_phase``):
                (a) ``atracdenc_tpu_torch.golden_check`` and ``triage_at3``
                on the seven golden cases, the counters of A, B and C zeroed
                just before (each launches): each case's identity and
                first-plane histogram beside the ``cpu`` key of
                ``identity_triage.json``, the report equal to its ``cuda``
                key; (b) ``triage_gain`` on default_stress and js_mono: no
                ``LOGIC`` entry, both reports equal to the ``cuda`` key;
                (c) ``triage_at3.divergent_stages`` on every frame whose
                CUDA bytes differ from the CPU path's (the selfcheck's
                three ATRAC3 modes, tonal_dense, the first 4 of phase 6's
                64 streams, cut to 2 when the CPU part would pass 60 s):
                one line per frame with its first plane, first stage, ulp
                gap and class, every class ``knife_edge``; and whether
                libavcodec and the reference sources are on the machine;
                (d) ``triage_at1.triage`` on at1_golden and at1_stress_pcm
                (whole tracks, E's counter zeroed first, E launches): one
                line per sound unit whose CUDA bytes differ from the CPU
                path's, with its channel, frame, first plane, first stage,
                ulp gap and class, every class ``knife_edge``, the report
                equal to the ``triage_at1`` entry of the ``cuda`` key
 18. sweeps   — the batch-shape sweeps and the perf campaign at short grids
                (``sweeps_phase``): ``sweep_at3_batch --pallas`` at 32x256,
                64x256, 128x256, 64x512 (A, B, C launched);
                ``sweep_at1_batch`` at 8x512, 32x512, 128x512 on both rate
                routes (E launched on the kernel route, not on the tensor-op
                route); ``perf_campaign --seconds 12 --streams 16,64``.
                Every point's bytes checked before they were timed, rows
                with peak device memory and SHA-256 on log lines; ATRAC1's
                two routes give equal bytes at every point; 64x256 gives
                phase 6's bytes and ATRAC1 8x512 phase 7's
``modes_phase``, ``scaling_phase``, ``triage_phase`` and ``sweeps_phase``
take their inputs as arguments, so a CPU rehearsal can call them at small
shapes.
The last two lines of stdout are the card's nvidia-smi name / power limit
(preceded by the kernels JSON line) and {"ok": true, "device": {...}}.

The kernels line has one row per kernel.  ``launches`` is the count of the
path that runs it, read just after that path's run: phase 6 for A, B, C and
J (one a call), phase 7 for E, phase 9 for D.  F has no caller in the
encoder (nor in the JAX package), so its path is the one call of phase 3 on
C's captured inputs, counted alone.  ``bound_ms`` is the larger of the bytes the
function moves (each input read once, each output written once) over 3.35
TB/s and its operations (estimated per element, see ``OPS``) over 67
TFLOP/s, the H100 SXM's HBM and non-tensor f32 peaks.  Of A's and D's
input only the values that this run's mask keeps count, for bytes and for
operations (a quarter of each frame: no output depends on the rest), with
the mask once and the outputs.  ``library_ms`` is null: no single PyTorch
call computes any of the six functions.
"""
import contextlib
import hashlib
import io
import itertools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CHANNELS = 2
HBM_BPS, F32_OPS = 3.35e12, 67e12         # H100 SXM: HBM bytes/s, f32 ops/s
# Operations each function needs, estimated per unit of its work:
#   A  per value the mask keeps: 8 wordlens x (multiply, round, square, add,
#      VLC index, lookup, add, mask) + the e1 square and add
#   D  A's, plus per kept EA element and wordlen (BFUs 19..31 x 7):
#      quantise, delta, key, eligibility, rank (log2 L compares) and the
#      7-op recurrence step
#   B  per candidate step: subtract, add, two differences, two abs, compare
#   C/F per allocation evaluation: 32 BFUs x ~30 (allocation, discount,
#      boost, cost sums); 12 evaluations per bisection round
#   E  per allocation evaluation: 52 BFUs x ~10; 12 evaluations per
#      bisection round (fewer after an exact hit), 1 + (7 - bfu_idx) rounds
#      a channel-frame in auto mode
OPS = {"A_value": 66, "D_ea_elem": 20 + 7, "B_step": 7, "C_eval": 32 * 30,
       "E_eval": 52 * 10}


def log(*a):
    print(*a, flush=True)


def nbytes(*tensors):
    """Bytes of the tensors among the arguments (each counted once; a
    tensor broadcast along an axis, stride 0, counts its data once)."""
    import torch
    return sum(t[tuple(0 if st == 0 else slice(None) for st in t.stride())]
               .numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def digest(*arrays):
    """SHA-256 over the bytes of tensors or numpy arrays, in order."""
    h = hashlib.sha256()
    for a in arrays:
        h.update((a if hasattr(a, "tobytes") else a.cpu().numpy()).tobytes())
    return h.hexdigest()


def kept_values(x, mask, first_bfu=0):
    """Values of x [..., 32, 128] that mask [32, 128] keeps, from BFU
    first_bfu on: the only ones an output of kernels A and D depends on."""
    return x.numel() // 4096 * int(mask[first_bfu:].sum())


def psnr(x, y):
    """PSNR of y against x in dB, as tests/test_at3_decoder.py takes it."""
    import numpy as np
    e = x - y
    return 10 * np.log10((x ** 2).mean() / max((e ** 2).mean(), 1e-20))


def ulps(a, b):
    """Distance in units in the last place of two f32 tensors."""
    import torch
    return (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the least time for the bytes at the HBM rate
    or for the operations at the f32 rate, whichever is longer."""
    b_ms, o_ms = n_bytes / HBM_BPS * 1e3, n_ops / F32_OPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


# kernel -> its launch counter in the port's tracer, A to F (G's,
# ``launch.deposit``, is read where its count is known: phases 6, 7, 11)
COUNTERS = {"A": "launch.quant_cost", "B": "launch.greedy",
            "C": "launch.rate_control", "D": "launch.quant_full",
            "E": "launch.at1_alloc", "F": "launch.bisect"}


def counts():
    from atracdenc_tpu_torch import trace
    return {k: trace.counter(c) for k, c in COUNTERS.items()}


def zero_counts():
    from atracdenc_tpu_torch import trace
    trace.reset()


MESH_RANKS = 4                             # phase 12: dp 2 x sp 2 on one card
H_FLOP = 128 * 1024 * 2 * 2                # kernel H: FLOP a lane-round


def at3p_cell_calls(x):
    """The inputs of kernels H (``gha.greedy``, both passes) and I
    (``device_pack.spectrum_fields``, one a channel) captured from one
    ``encode_chunk_bytes`` call at the ``atrac3plus.batch`` cell's shape
    (64 tracks x 512 frames of ``x`` repeated): {"H": [...], "I": [...]}."""
    from atracdenc_tpu_torch.models.atrac3p import device_pack as at3p_pack
    from atracdenc_tpu_torch.models.atrac3p import encoder as at3p_encoder
    from atracdenc_tpu_torch.models.atrac3p import gha
    from atracdenc_tpu_torch.trace_encode import capture
    kc = 512
    xc = x.repeat(1, 1, -(-kc * 2048 // x.shape[-1]))[..., :kc * 2048]
    xc = xc.contiguous()
    return capture([(gha, "greedy", "H"), (at3p_pack, "spectrum_fields", "I")],
                   lambda: at3p_encoder.encode_chunk_bytes(
                       xc, None, xc[..., :2048].contiguous()))


def gha_kernel_check(passes, row):
    """Phase 3's kernel H: ``gha.greedy``'s two passes of one
    ``atrac3plus.batch`` call (``at3p_cell_calls``), each against the plain
    ``_greedy`` (inactive lanes masked) and timed; ``row`` as phase 3's.
    -> the log line."""
    import torch
    from atracdenc_tpu_torch import trace
    from atracdenc_tpu_torch.models.atrac3p import gha
    from atracdenc_tpu_torch.trace_encode import cuda_ms
    assert len(passes) == 2, len(passes)
    equal, lanes_all, rounds, outs = [], 0, 0, []
    for a, kw in passes:
        trace.reset()
        trace.enable()
        got = gha.greedy(*a, **kw)
        snap = trace.snapshot()
        trace.disable()
        rounds += snap["counters"]["gha.lane_rounds"]["total"]
        x_, fit_len, max_keep, ath = a
        on = kw.get("active")
        fit = torch.arange(128, device=x_.device) < fit_len[:, None]
        plain = gha._greedy(x_, fit, max_keep, ath)
        diff = torch.zeros(x_.shape[0], dtype=torch.bool, device=x_.device)
        for g, p in zip(got, plain):
            if on is not None:
                p = torch.where(on[:, None], p, torch.zeros_like(p))
            diff |= (g != p).any(-1)
        del plain
        equal.append(1.0 - float(diff.float().mean()))
        lanes_all += x_.shape[0]
        outs.extend(got)
    torch.cuda.empty_cache()
    assert min(equal) >= 0.995, f"kernel H: lanes equal {equal}"
    h_ms = cuda_ms(lambda: [gha.greedy(*a, **kw) for a, kw in passes], 5, 1)
    h_pms = cuda_ms(lambda: [gha._greedy(
        a[0], torch.arange(128, device=a[0].device) < a[1][:, None], *a[2:])
        for a, _ in passes], 1, 1)
    torch.cuda.empty_cache()
    h_bound = row("gha_greedy", "gha_greedy.cu", None, 0.0, h_ms, h_pms,
                  nbytes(passes[0][0][0], *outs[:4]), rounds * H_FLOP)
    offered = lanes_all * 8
    return (f"[3 kernels] H gha_greedy, both passes of one atrac3plus.batch "
            f"call ({passes[0][0][0].shape[0]} lanes; refit on "
            f"{int(passes[1][1]['active'].sum())}): planes equal the plain "
            f"version's on {', '.join(f'{e:.6f}' for e in equal)} of lanes; "
            f"kernel {h_ms:.3f} ms, plain {h_pms:.3f} ms, {h_bound} for "
            f"{rounds} lane-rounds = {rounds / offered:.4f} of the plain "
            f"version's {offered}; sha256 {digest(*outs)}")


def spectrum_kernel_check(calls, row):
    """Phase 3's kernel I: ``spectrum_fields`` on both channels' inputs of
    one ``atrac3plus.batch`` call (``at3p_cell_calls``), values, widths,
    offsets and bits equal to ``spectrum_fields_torch``, timed beside its
    bound (the lines it reads, its other inputs and its outputs, once) and
    the plain version; ``row`` as phase 3's.  -> the log line."""
    import torch
    from atracdenc_tpu_torch.models.atrac3p import device_pack as at3p_pack
    from atracdenc_tpu_torch.trace_encode import cuda_ms
    args = [a for a, _ in calls]
    assert len(args) == 2, len(args)                 # one a channel
    outs = [at3p_pack.spectrum_fields(*a) for a in args]
    for a, out in zip(args, outs):
        for name, g, p in zip(("values", "widths", "offsets", "bits"), out,
                              at3p_pack.spectrum_fields_torch(*a)):
            assert torch.equal(g, p), f"kernel I: {name} differs"
    torch.cuda.empty_cache()

    def both(fn):                   # keeps no output: the allocator reuses it
        for a in args:
            fn(*a)
    i_ms = cuda_ms(lambda: both(at3p_pack.spectrum_fields), 20, 3)
    i_pms = cuda_ms(lambda: both(at3p_pack.spectrum_fields_torch), 2, 1)
    torch.cuda.empty_cache()
    n_bytes = sum(4 * 2048 * a[0].shape[0] + nbytes(*a[1:]) for a in args) \
        + sum(nbytes(*o) for o in outs)
    i_bound = row("at3p_spectrum_fields", "at3p_spectrum.cu", None, 0.0, i_ms,
                  i_pms, n_bytes, 0)
    return (f"[3 kernels] I spectrum_fields, both channels of one "
            f"atrac3plus.batch call ({args[0][0].shape[0]} frames a channel): "
            f"values, widths, offsets and bits equal its plain version; kernel "
            f"{i_ms:.4f} ms, plain {i_pms:.3f} ms, {i_bound} a call; sha256 "
            f"{digest(*(t for o in outs for t in o))}")


def gain_kernel_check(args, row):
    """Phase 3's kernel J: ``gain.gain_analysis`` on one ATRAC3 call's
    windows (``testing.gain_cell_call``) against ``gain_analysis_torch``, timed
    beside its bound (operations: 512 x 2,560 multiply-adds a window) and
    the plain route, and the plain route's three GEMMs alone, as the
    program lays out their windows and on contiguous windows; ``row`` as
    phase 3's.  -> the log line."""
    import torch
    from atracdenc_tpu_torch.models.atrac3 import gain
    from atracdenc_tpu_torch.testing import GAIN_TOL, gain_gaps
    from atracdenc_tpu_torch.trace_encode import cuda_ms
    got = gain.gain_analysis(*args)
    gaps = gain_gaps(got, gain.gain_analysis_torch(*args), *args)
    torch.cuda.empty_cache()
    for name, (scaled, _) in gaps.items():
        assert scaled <= GAIN_TOL[name], f"kernel J: {name} gap {gaps[name]}"
    j_ms = cuda_ms(lambda: gain.gain_analysis(*args), 10, 2)
    p_ms = cuda_ms(lambda: gain.gain_analysis_torch(*args), 3, 1)
    torch.cuda.empty_cache()
    c = gain._matrices(args[0].device)
    up = gain.assemble_up_in(*args)
    flat = up.reshape(-1, 512).contiguous()

    def gemms(x):                   # keeps no output: the allocator reuses it
        for m in ("region", "E", "Ef"):
            torch.matmul(x, c[m])
    g_ms = cuda_ms(lambda: gemms(up), 3, 1)
    gc_ms = cuda_ms(lambda: gemms(flat), 3, 1)
    n_win = flat.shape[0]
    del up, flat
    torch.cuda.empty_cache()
    g_flop = 2 * n_win * 512 * (2048 + 2 * 514)
    j_bound = row("at3_gain_analysis", "at3_gain.cu", None,
                  max(v[0] for v in gaps.values()), j_ms, p_ms,
                  nbytes(*args) + nbytes(*got), 2 * n_win * 512 * 2560)
    return (f"[3 kernels] J gain_analysis, one atrac3-lp2.batch call "
            f"({n_win} windows of music): largest gaps from the plain route "
            f"(over the window's RMS; relative) "
            f"{', '.join(f'{k} {a:.3e} {r:.3e}' for k, (a, r) in gaps.items())}"
            f"; kernel {j_ms:.3f} ms, plain {p_ms:.3f} ms, {j_bound} a call; "
            f"the plain route's three GEMMs alone {g_ms:.3f} ms as the "
            f"program lays out the windows ({g_flop / g_ms / 1e9:.2f} "
            f"TFLOP/s), {gc_ms:.3f} ms on contiguous windows "
            f"({g_flop / gc_ms / 1e9:.2f} TFLOP/s); sha256 {digest(*got)}")


def mesh_rank(rank, coordinator, out_dir, spec):
    """One rank of phase 12, started by ``mesh_phase`` as a fresh
    interpreter: the sharded calls at the bench shapes of ``spec``, each
    with the launch counters zeroed just before and read just after (the
    call's own gather included); rank 0 saves the gathered results and
    every rank's counts and times."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from atracdenc_tpu_torch.bench import corpus
    from atracdenc_tpu_torch.parallel import distributed as D
    from atracdenc_tpu_torch.parallel import mesh as M
    spec = json.loads(spec)
    t_start = time.perf_counter()
    dev = D.initialize(coordinator, MESH_RANKS, rank, device=spec["device"])
    mesh = M.make_mesh(MESH_RANKS, device=dev)
    assert mesh.shape == {"dp": 2, "sp": 2}, mesh.shape
    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    pcm = corpus(spec["streams"], spec["frames"])
    pcm1 = pcm[:spec["at1_streams"], :, :512 * spec["at1_frames"]]
    pcm3p = pcm[:spec["at3p_streams"], :, :2048 * spec["at3p_frames"]]
    M.encode_batch_at3_bytes_sharded(pcm, mesh)               # warm
    at3, t_at3 = timed(lambda: M.encode_batch_at3_bytes_sharded(pcm, mesh))
    launched = {k: v for k, v in counts().items() if k in "ABC"}
    M.encode_batch_sharded(pcm1, mesh)                        # warm
    at1, t_at1 = timed(lambda: M.encode_batch_sharded(pcm1, mesh))
    launched["E"] = counts()["E"]
    dec = M.decode_batch_at1_sharded(at1, M.make_mesh(MESH_RANKS, dp=4,
                                                      device=dev))
    core, t_at3p = timed(lambda: M.encode_core_at3p_sharded(pcm3p, mesh,
                                                            gha_mask=7))
    every = [None] * MESH_RANKS
    dist.all_gather_object(every, {"counts": launched, "t_at3": t_at3,
                                   "t_at1": t_at1, "t_at3p": t_at3p})
    if rank == 0:
        np.savez(os.path.join(out_dir, "out.npz"), at3=at3, at1_decode=dec,
                 **{f"at1.{k}": v for k, v in at1.items()},
                 **{f"at3p.{k}": v for k, v in core.items()})
        with open(os.path.join(out_dir, "out.json"), "w") as fp:
            json.dump({"counts": [e["counts"] for e in every],
                       **{k: max(e[k] for e in every)
                          for k in ("t_at3", "t_at1", "t_at3p")},
                       "t_ranks": time.perf_counter() - t_start}, fp)
    D.finalize()
    return 0


def _differing(a, b, axes=3):
    """Count of differing values, and the leading-axes indices where they
    are (at most 20)."""
    import numpy as np
    where = sorted({tuple(ix[:axes]) for ix in np.argwhere(a != b).tolist()})
    return int((a != b).sum()), where[:20]


def mesh_phase(dev, smi, work, pcm, at3_ref, t_at3_ref, at1_ref):
    """Phase 12: the parent launches 4 rank processes on ``dev`` (dp 2, sp 2,
    gloo) and holds their gathered results against the one-process runs:
    ATRAC3 bytes against phase 6's (``at3_ref``, on the corpus ``pcm``),
    ATRAC1 planes against phase 7's (``at1_ref``), the dp = 4 decode and
    the ATRAC3+ core against this process's own 1 x 1 mesh."""
    import numpy as np
    from atracdenc_tpu_torch.bench import AT3P_FRAMES, AT3P_STREAMS
    from atracdenc_tpu_torch.parallel import distributed as D
    from atracdenc_tpu_torch.parallel import mesh as M
    t_phase = time.perf_counter()
    streams, frames = at3_ref.shape[:2]
    at1_streams, _, at1_frames = at1_ref["bfu_idx"].shape
    spec = {"device": dev.type, "streams": streams, "frames": frames,
            "at1_streams": at1_streams, "at1_frames": at1_frames,
            "at3p_streams": min(AT3P_STREAMS, streams),
            "at3p_frames": min(AT3P_FRAMES, frames // 2)}
    mesh_dir = os.path.join(work, "mesh")
    os.makedirs(mesh_dir, exist_ok=True)
    D.launch(lambda r, coord: [sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                               "--mesh-rank", str(r), coord, mesh_dir,
                               json.dumps(spec)], MESH_RANKS, timeout=400)
    got = dict(np.load(os.path.join(mesh_dir, "out.npz")))
    with open(os.path.join(mesh_dir, "out.json")) as fp:
        info = json.load(fp)
    for r, c in enumerate(info["counts"]):
        assert all(c[k] > 0 for k in "ABCE") or dev.type == "cpu", (r, c)
    fr = got["at3"]
    assert fr.shape == at3_ref.shape, fr.shape
    n_st = streams * frames
    ident = float(np.mean(fr == at3_ref))
    log(f"[12 mesh] ATRAC3 {streams} x {frames} stereo frames through "
        f"encode_batch_at3_bytes_sharded on 2 x 2 ranks of one card: "
        f"{info['t_at3']:.3f} s = {n_st / info['t_at3']:.1f} stereo frames/s "
        f"(phase 6, one process: {t_at3_ref:.3f} s = {n_st / t_at3_ref:.1f}); "
        f"sha256 {digest(fr)} (phase 6 {digest(at3_ref)}), byte identity "
        f"{ident!r}, (stream, frame) that differ "
        f"{_differing(fr, at3_ref, 2)} | {smi}")
    assert ident >= 0.999, ident
    diffs = {k: _differing(got[f"at1.{k}"], v) for k, v in at1_ref.items()}
    log(f"[12 mesh] ATRAC1 {at1_streams} x {CHANNELS} x {at1_frames} through "
        f"encode_batch_sharded on 2 x 2: {info['t_at1']:.4f} s; against phase "
        f"7's planes, values that differ and their (stream, channel, frame): "
        f"{diffs}")
    for k, (n_diff, _) in diffs.items():
        assert n_diff <= 1e-3 * at1_ref[k].size, (k, n_diff)
    dec = got["at1_decode"]
    dec1 = M.decode_batch_at1_sharded({k: got[f"at1.{k}"] for k in at1_ref},
                                      M.Mesh(1, 1, dev))
    derr = float(np.abs(dec - dec1).max())
    log(f"[12 mesh] ATRAC1 decode over dp = 4: max |sharded - one process| "
        f"{derr!r} (bound 1e-6)")
    assert dec.shape == dec1.shape and derr <= 1e-6, derr
    s3p, f3p = spec["at3p_streams"], spec["at3p_frames"]
    core1 = M.encode_core_at3p_sharded(pcm[:s3p, :, :2048 * f3p],
                                       M.Mesh(1, 1, dev), gha_mask=7)
    pdiff = {k: _differing(got[f"at3p.{k}"], v) for k, v in core1.items()}
    log(f"[12 mesh] ATRAC3+ core {s3p} x {f3p} stereo frames, GHA 7, on 2 x 2: "
        f"{info['t_at3p']:.4f} s; against one process, planes with values "
        f"that differ: { {k: v for k, v in pdiff.items() if v[0]} or 'none'} "
        f"of {len(core1)} planes")
    for k, (n_diff, _) in pdiff.items():
        assert n_diff <= 1e-3 * core1[k].size, (k, n_diff)
    log(f"[12 mesh] launches read in the ranks (A, B, C: the ATRAC3 call; E: "
        f"the ATRAC1 call) {info['counts']}; rank 0 ran {info['t_ranks']:.1f} s; "
        f"phase 12 took {time.perf_counter() - t_phase:.1f} s | {smi}")


def transcode_phase(smi, work, wavs, cli_out, device=None, seconds=30):
    """Phase 13: ``wavs`` plus WAVs made here to three ``seconds``-long
    stereo files through ``python -m atracdenc_tpu_torch.tools.transcode``
    for each codec, in one process and as --hosts 2: each file written once,
    the same bytes, the first file equal to ``cli_out[codec]`` (cli.main's
    output of it), and --resume skipping all three.  ATRAC3 runs at the
    CLI's chunking (1024 frames), so the two paths differ only in the
    packer (device here, host there)."""
    import numpy as np
    from atracdenc_tpu_torch.io import wav
    from atracdenc_tpu_torch.parallel import distributed as D
    t_phase = time.perf_counter()
    tc = os.path.join(work, "transcode")
    os.makedirs(tc, exist_ok=True)
    n = 44100 * seconds
    tt = np.arange(n) / 44100.0
    wavs = list(wavs)
    for f0, seed in ((997.0, 21), (1503.0, 22))[:3 - len(wavs)]:
        rng = np.random.default_rng(seed)
        sig = 0.35 * np.sin(2 * np.pi * f0 * tt)
        wavs.append(os.path.join(tc, f"in{seconds}s_{seed}.wav"))
        wav.write(wavs[-1], np.clip(np.stack([sig, 0.8 * sig]) + 0.03
                                    * rng.standard_normal((2, n)), -1, 1)
                  .astype(np.float32), 44100)
    env = dict(os.environ, PYTHONPATH=ROOT)
    for codec in ("atrac1", "atrac3", "atrac3plus"):
        cmd = [sys.executable, "-m", "atracdenc_tpu_torch.tools.transcode",
               *wavs, "--codec", codec, "--chunk-frames", "1024"]
        if device:
            cmd += ["--device", device]
        one, two = (os.path.join(tc, f"{codec}_{k}") for k in ("one", "two"))
        t0 = time.perf_counter()
        res = subprocess.run(cmd + ["--out-dir", one], cwd=ROOT, timeout=300,
                             capture_output=True, text=True, env=env)
        t_one = time.perf_counter() - t0
        assert res.returncode == 0, res.stderr[-3000:]
        lines = res.stdout.splitlines()
        assert [ln.split(" -> ")[0] for ln in lines if " -> " in ln] == wavs
        t0 = time.perf_counter()
        outs = D.launch(lambda r, coord: cmd + [
            "--out-dir", two, "--hosts", "2", "--host-id", str(r),
            "--coordinator", coord], 2, timeout=300)
        t_two = time.perf_counter() - t0
        for r, out in enumerate(outs):
            assert [ln.split(" -> ")[0] for ln in out.splitlines()
                    if " -> " in ln] == wavs[r::2], (r, out)
        names = sorted(os.listdir(one))
        assert names == sorted(os.listdir(two)) and len(names) == 3, names
        for name in names:
            with open(os.path.join(one, name), "rb") as a, \
                    open(os.path.join(two, name), "rb") as b:
                assert a.read() == b.read(), (codec, name)
        first = os.path.splitext(os.path.basename(wavs[0]))[0]
        with open(os.path.join(one, first + (".aea" if codec == "atrac1"
                                             else ".oma")), "rb") as a, \
                open(cli_out[codec], "rb") as b:
            assert a.read() == b.read(), f"{codec}: transcode != cli.main"
        res = subprocess.run(cmd + ["--out-dir", one, "--resume"], cwd=ROOT,
                             timeout=300, capture_output=True, text=True,
                             env=env)
        assert res.returncode == 0 and res.stdout.count("skip ") == 3, \
            res.stdout + res.stderr[-2000:]
        log(f"[13 transcode] {codec}: 3 x {seconds} s WAVs, one process "
            f"{t_one:.1f} s wall ({lines[-1]}); --hosts 2 {t_two:.1f} s wall "
            f"({'; '.join(o.splitlines()[-1] for o in outs)}); the same bytes, "
            f"each file written once, {first} equal to cli.main's; --resume "
            f"skipped all 3 | {smi}")
    log(f"[13 transcode] phase 13 took {time.perf_counter() - t_phase:.1f} s")


def _check_abc(calls):
    """Kernels A, B and C on the inputs ``calls`` (trace_encode.capture's
    record) against their plain versions, by phase 3's rules; -> a line."""
    import torch
    from atracdenc_tpu_torch.ops import greedy, quant_cost, rate_control
    (a_args, _), = calls["A"]
    err_k, vlc_k = quant_cost.quant_cost_plain(*a_args)
    err_p, vlc_p = quant_cost.quant_cost_torch(*a_args)
    assert torch.equal(vlc_k, vlc_p), "kernel A: vlc differs"
    ulp = int(ulps(err_k, err_p).max())
    assert ulp <= 4, f"kernel A: err off by {ulp} ulp"
    for a, _ in calls["B"]:
        e2k, acck = greedy.greedy_scan(*a)
        e2p, accp = greedy.greedy_torch(*a)
        both_nan = torch.isnan(e2k) & torch.isnan(e2p)
        assert bool(((e2k == e2p) | both_nan).all()) and torch.equal(acck, accp), \
            f"kernel B differs at {tuple(a[0].shape)}"
    (c_args, c_kw), = calls["C"]
    rounds = 0
    for auto in (True, False):
        kw = dict(c_kw, auto=auto)
        outk = rate_control.rate_control_block(*c_args, **kw)
        outp = rate_control.rate_control_torch(*c_args, **kw)
        for name, k_, p_ in zip(("num_bfu", "mode", "wl"), outk, outp):
            assert torch.equal(k_.to(p_.dtype), p_), \
                f"kernel C (auto={auto}): {name} differs"
        if auto:
            rounds = int((c_args[5].long() - outk[0].long() + 1).sum())
    c_ms = "not timed on the CPU"
    if c_args[0].is_cuda:
        from atracdenc_tpu_torch.trace_encode import cuda_ms
        c_ms = cuda_ms(lambda: rate_control.rate_control_block(*c_args, **c_kw),
                       5, 1)
        c_ms = f"kernel {c_ms:.3f} ms"
    return (f"A {tuple(a_args[0].shape)} vlc equal, err <= {ulp} ulp; B "
            f"{len(calls['B'])} calls bit-equal (NaN on both sides equal); C "
            f"{tuple(c_args[0].shape)} num_bfu / mode / wl equal, auto and "
            f"fixed ({rounds} bisection rounds in auto; {c_ms})")


def modes_phase(dev, smi, work, pcm, wav_seconds=5):
    """Phase 15: every ATRAC3 mode of the JAX package on ``dev``.

    (a) the selfcheck's five modes against the hash file's key for the
    device type, and each mode's bytes against the CPU path's at identity
    >= 0.99 (the whole corpus: a few seconds of host time); (b) LP4 joint
    stereo (192 B) and the plain mode (384 B, no gain control, no tonal) on
    the batch
    ``pcm`` [S, 2, T] through ``encode_frames_bytes``, counters zeroed
    first, bytes equal encode + host ``frame.pack``; (c) A, B and C against
    their plain versions at the inputs of (b)'s joint-stereo encode; (d) the
    goldens at3_js_golden (stereo > 0.99, mono > 0.85, the mono side channel
    one QMF band of num_bfu 1, the device packer equal to frame.pack),
    at3_tonal_golden (> 0.99) and at3_tonal_dense_golden (> 0.97); (e)
    ``cli.main`` on a ``wav_seconds`` stereo WAV through ``-e atrac3_lp4``
    and ``-e atrac3 --bitrate N`` for one N of every ``CONTAINER_PARAMS``
    row: each file's frame size and joint-stereo flag, and ``-d`` back to
    WAV within 1 dB RMS."""
    import numpy as np
    import torch
    from atracdenc_tpu_torch import cli, runtime, selfcheck
    from atracdenc_tpu_torch.containers import oma
    from atracdenc_tpu_torch.io import audio, wav
    from atracdenc_tpu_torch.models.atrac3 import (bitalloc, device_pack,
                                                   encoder, frame)
    from atracdenc_tpu_torch.models.atrac3 import tables as T3
    from atracdenc_tpu_torch.trace_encode import capture
    t_phase = time.perf_counter()
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    # (a) the selfcheck on this device
    t0 = time.perf_counter()
    got = selfcheck.compute(dev.type)
    hashes = {k: selfcheck.digest(v) for k, v in got.items()}
    t_sc = time.perf_counter() - t0
    with open(selfcheck.HASH_FILE) as fp:
        want = json.load(fp).get(dev.type)
    log(f"[15 modes] selfcheck on {dev.type} in {t_sc:.1f} s: {hashes}; "
        f"stored key {dev.type!r}: {'equal' if hashes == want else want}")
    assert hashes == want, (hashes, want)
    t0 = time.perf_counter()
    cpu = selfcheck.compute("cpu")
    cpu_hashes = {k: selfcheck.digest(v) for k, v in cpu.items()}
    with open(selfcheck.HASH_FILE) as fp:
        cpu_key = json.load(fp)["cpu"]
    log(f"[15 modes] the CPU path on this host in {time.perf_counter() - t0:.1f}"
        f" s: modes equal to the stored 'cpu' key "
        f"{[k for k in cpu_hashes if cpu_hashes[k] == cpu_key[k]]}")
    for k in selfcheck.MODES:
        assert got[k].shape == cpu[k].shape, (k, got[k].shape, cpu[k].shape)
        ident = float(np.mean(got[k] == cpu[k]))
        log(f"[15 modes] selfcheck {k} {tuple(got[k].shape)}: {dev.type} "
            f"against the CPU path: byte identity {ident!r} (floor 0.99), "
            f"(bytes that differ, frames) "
            f"{_differing(got[k], cpu[k], got[k].ndim - 1)}")
        assert ident >= 0.99, (k, ident)

    # (b) LP4 joint stereo and the plain mode at the batch's full width;
    # (c) A, B, C on the joint-stereo encode's inputs
    x = torch.from_numpy(pcm).to(dev)
    streams, nframes = pcm.shape[0], pcm.shape[2] // 1024
    n_st = streams * nframes
    sites = [(bitalloc, "quant_cost_plain", "A"),
             (bitalloc, "greedy_scan", "B"),
             (bitalloc, "rate_control_block", "C")]
    for label, opts in (
            ("LP4 joint stereo", dict(frame_bytes=192, js=True,
                                      no_gain_control=False, no_tonal=False)),
            ("plain", dict(frame_bytes=384, js=False, no_gain_control=True,
                           no_tonal=True))):
        fb, js = opts["frame_bytes"], opts["js"]
        calls = capture(sites, lambda: encoder.encode_frames_bytes(x, **opts))
        sync()
        zero_counts()
        t0 = time.perf_counter()
        out = encoder.encode_frames_bytes(x, **opts)
        sync()
        dt = time.perf_counter() - t0
        c = counts()
        assert (all(c[k] > 0 for k in "ABC") and c["D"] == 0) or not cuda, c
        fr = runtime.to_numpy(out)
        t0 = time.perf_counter()
        host = {k: runtime.to_numpy(v)
                for k, v in encoder.encode_frames(x, **opts).items()}
        want_fr = np.stack([frame.pack({k: v[s] for k, v in host.items()},
                                       fb, js=js) for s in range(streams)])
        t_host = time.perf_counter() - t0
        assert fr.shape == (streams, nframes, fb), fr.shape
        assert np.array_equal(fr, want_fr), \
            f"{label}: {int((fr != want_fr).sum())} bytes differ from frame.pack"
        log(f"[15 modes] {label} ({fb} B) {streams} x {nframes} stereo frames: "
            f"encode + device pack {dt:.3f} s = {n_st / dt:.1f} stereo "
            f"frames/s; bytes equal encode + frame.pack ({t_host:.1f} s), "
            f"sha256 {digest(fr)} | {smi} | launches {c}")
        if js:
            log(f"[15 modes] kernels at the LP4 joint-stereo inputs: "
                f"{_check_abc(calls)}")
        del calls, out
    del x
    if cuda:
        torch.cuda.empty_cache()

    # (d) the goldens that only the CPU tests had encoded
    gdir = os.path.join(ROOT, "tests", "golden")
    gjs = np.load(os.path.join(gdir, "at3_js_golden.npz"))
    js_opts = dict(frame_bytes=192, js=True, no_gain_control=False,
                   no_tonal=False)
    for label, pcm_g, ref, floor in (
            ("stereo", gjs["pcm_in"], gjs["ref_frames"], 0.99),
            ("mono", gjs["pcm_mono"], gjs["ref_mono"], 0.85)):
        planes = encoder.encode_track(pcm_g, device=dev.type, **js_opts)
        ours = frame.pack(planes, 192, js=True)
        on_dev = runtime.to_numpy(device_pack.pack_device(
            {k: runtime.to_torch(v, dev) for k, v in planes.items()}, 192,
            js=True))
        assert np.array_equal(on_dev, ours), f"JS {label}: device packer"
        ident = float((ours == ref).mean())
        side = ""
        if pcm_g.shape[0] == 1:
            for chans in frame.unpack(ours, 1, js=True):
                s1 = chans[1]
                assert len(s1["gain"]) == 1 and s1["num_bfu"] == 1 \
                    and s1["wordlen"][0] == 0, s1
            side = "; every side channel parses as 1 QMF band, num_bfu 1"
        log(f"[15 modes] at3_js_golden {label}: byte identity vs reference "
            f"{ident!r} (floor > {floor}); device packer equal to frame.pack"
            f"{side}")
        assert ident > floor, (label, ident)
    for name, floor in (("at3_tonal_golden", 0.99),
                        ("at3_tonal_dense_golden", 0.97)):
        g = np.load(os.path.join(gdir, f"{name}.npz"))
        planes = encoder.encode_track(g["pcm_in"], frame_bytes=384,
                                      no_tonal=False, device=dev.type)
        ident = float((frame.pack(planes, 384) == g["ref_frames"]).mean())
        log(f"[15 modes] {name}: byte identity vs reference {ident!r} "
            f"(floor > {floor}); longest tonal block "
            f"{int(planes['tonal_len'].max())}")
        assert ident > floor, (name, ident)
    assert (planes["tonal_len"] > 5).any()

    # (e) every ATRAC3 bitrate through the CLI and back
    n = 44100 * wav_seconds
    rng = np.random.default_rng(15)
    tt = np.arange(n) / 44100.0
    sig = 0.4 * np.sin(2 * np.pi * 440 * tt) * np.exp(-((tt % 1.0) * 2.0))
    pcm5 = np.clip(np.stack([sig, 0.7 * sig])
                   + 0.02 * rng.standard_normal((2, n)), -1, 1)
    wav_in = os.path.join(work, f"in{wav_seconds}s.wav")
    wav.write(wav_in, pcm5.astype(np.float32), 44100)
    flag = [] if cuda else ["--device", "cpu"]
    runs = [("atrac3_lp4", [], T3.CONTAINER_PARAMS[0])] + [
        ("atrac3", ["--bitrate", str(br // 1024)], (br, fb, js))
        for br, fb, js in T3.CONTAINER_PARAMS]
    n_fr = -(-n // 1024)
    seg = slice(1024, n_fr * 1024 - 1162 - 1024)
    c0 = counts()
    for codec, extra, (br, fb, js) in runs:
        if extra:
            assert T3.container_params_for_bitrate(
                int(extra[1]) * 1024) == (br, fb, js), extra
        tag = f"{codec}{'_' + extra[1] if extra else ''}"
        out, back = (os.path.join(work, f"p15_{tag}.{e}") for e in ("oma", "wav"))
        t0 = time.perf_counter()
        cli.main(["-e", codec, *extra, "-i", wav_in, "-o", out, "--nostdout",
                  *flag])
        t_enc = time.perf_counter() - t0
        frames_, info = oma.read(out)
        assert info["codec"] == oma.CODEC_ATRAC3
        assert frames_.shape == (n_fr, fb) and info["frame_size"] == fb \
            and info["joint_stereo"] == js, (tag, frames_.shape, info)
        cli.main(["-d", "-i", out, "-o", back, "--nostdout", *flag])
        pcm_b, rate = audio.read(back)
        assert rate == 44100 and pcm_b.shape == (2, n_fr * 1024 - 1162), \
            pcm_b.shape
        gain_db = 20 * np.log10(np.sqrt(np.mean(pcm_b[:, seg] ** 2))
                                / np.sqrt(np.mean(pcm5[:, seg] ** 2)))
        log(f"[15 modes] cli {' '.join(['-e', codec, *extra])}: {n_fr} frames of "
            f"{info['frame_size']} B, joint stereo {info['joint_stereo']} "
            f"(row {br} bit/s) in {t_enc:.2f} s; -d back: RMS {gain_db:+.3f} "
            f"dB against the input")
        assert abs(gain_db) < 1.0, (tag, gain_db)
    c1 = counts()
    assert all(c1[k] > c0[k] for k in "ABC") or not cuda, (c0, c1)
    log(f"[15 modes] {len(runs)} CLI encodes, launches {c0} -> {c1}; phase 15 "
        f"took {time.perf_counter() - t_phase:.1f} s | {smi}")


def scaling_phase(smi, device=None):
    """Phase 16: ``atracdenc_tpu_torch.scaling_bench`` at 1, 2 and 4 rank
    processes (it asserts its byte checks); its table on log lines."""
    from atracdenc_tpu_torch import scaling_bench
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rows = scaling_bench.run(device)
    for line in out.getvalue().splitlines():
        if line.strip():
            log(f"[16 scaling] {line}")
    assert [r["ranks"] for r in rows] == list(scaling_bench.RANKS), rows
    log(f"[16 scaling] {json.dumps({'rows': rows})}")
    log(f"[16 scaling] byte checks passed; phase 16 took "
        f"{time.perf_counter() - t0:.1f} s | {smi}")


def _probe_reference_tools():
    """Whether libavcodec (``pkg-config --exists libavcodec``) and the
    reference sources that ``tools/oracle/build.sh`` builds from (its ``R``
    default) are on this machine: the inputs of ``tools/psnr_equality.py``
    and ``tools/gen_gain_scenarios.py``."""
    import re
    try:
        av = subprocess.run(["pkg-config", "--exists", "libavcodec"],
                            timeout=30).returncode == 0
        av = "present" if av else "absent"
    except FileNotFoundError:
        av = "absent (no pkg-config)"
    with open(os.path.join(ROOT, "tools", "oracle", "build.sh")) as fp:
        src = re.search(r"R=\$\{R:-([^}]+)\}", fp.read()).group(1)
    ref = "present" if os.path.isdir(src) else "absent"
    return f"libavcodec {av}; reference sources ({src}) {ref}"


def triage_phase(dev, smi, pcm, streams=4):
    """Phase 17: the byte-identity triage on ``dev``.

    (a) ``golden_check`` and ``triage_at3`` on the seven golden cases, the
    counters of A, B and C zeroed first: each case's identity and
    first-plane histogram beside the ``cpu`` key of ``identity_triage.json``,
    the report equal to the key of the device type; (b) ``triage_gain`` on
    default_stress and js_mono: no ``LOGIC`` entry, reports equal to the
    key; (c) ``triage_at3.divergent_stages`` on every frame whose bytes on
    ``dev`` differ from the CPU path's: the selfcheck's three ATRAC3 modes
    on its corpus (a mode has divergent frames exactly when its ``cuda``
    and ``cpu`` hashes differ), tonal_dense, and the first ``streams`` of
    the batch ``pcm`` [S, 2, T] in the default mode (the device encodes all
    S streams, as phase 6; cut to 2 streams when the CPU part of the first
    2 takes over 30 s).  One line per frame; every frame a ``knife_edge``.
    (d) ``triage_at1.triage`` on the two ATRAC1 goldens: one line per unit
    whose bytes on ``dev`` differ from the CPU path's, every one a
    ``knife_edge``, the report equal to the key's ``triage_at1`` entry."""
    from collections import Counter
    from atracdenc_tpu_torch import (golden_check, selfcheck, triage_at1,
                                     triage_at3, triage_gain)
    t_phase = time.perf_counter()
    with open(triage_at3.KEY_FILE) as fp:
        key = json.load(fp)
    want = key.get(dev.type, {})

    # (a) the golden identities and first planes
    zero_counts()
    with contextlib.redirect_stdout(io.StringIO()) as gc_out:
        golden_check.main(["--device", dev.type])
    report = json.loads(json.dumps(triage_at3.triage(dev.type,
                                                     log=lambda *a: None)))
    c17 = counts()
    for line in gc_out.getvalue().splitlines():
        log(f"[17 triage] golden_check: {line}")
    for name, r in report.items():
        cp = key["cpu"]["triage_at3"][name]
        log(f"[17 triage] {name}: {dev.type} identity {r['identity']!r}, "
            f"{r['divergent']}/{r['frames']} frames divergent, first planes "
            f"{r['first_plane']}; cpu {cp['identity']!r}, {cp['divergent']}/"
            f"{cp['frames']}, {cp['first_plane']}")
    log(f"[17 triage] triage_at3 against the stored {dev.type!r} key: "
        f"{'equal' if report == want.get('triage_at3') else 'DIFFERENT'}; "
        f"launches {c17} | {smi}")
    assert all(c17[k] > 0 for k in "ABC") or dev.type == "cpu", c17
    assert report == want.get("triage_at3"), report

    # (b) the gain divergences: noise or LOGIC
    for name, tag in (("default_stress", "stress"), ("js_mono", "js_mono")):
        rep = json.loads(json.dumps(triage_gain.triage(name, dev.type,
                                                       log=lambda *a: None)))
        classes = dict(Counter(r["class"] for r in rep))
        log(f"[17 triage] triage_gain {name} on {dev.type}: {len(rep)} "
            f"divergent (frame, ch, band) entries, classes {classes}; cpu key "
            f"{len(key['cpu'][f'gain_triage_{tag}'])}; stored {dev.type!r} "
            f"key {'equal' if rep == want.get(f'gain_triage_{tag}') else 'DIFFERENT'}")
        assert classes.get("LOGIC", 0) == 0, rep
        assert rep == want.get(f"gain_triage_{tag}"), rep

    # (c) the frames by which this device's bytes differ from the CPU path's
    log(f"[17 triage] probe: {_probe_reference_tools()}")
    with open(selfcheck.HASH_FILE) as fp:
        hashes = json.load(fp)
    found = []
    for mode in ("at3_full", "at3_plain", "at3_js"):
        rows = triage_at3.divergent_stages(selfcheck.corpus(),
                                           selfcheck.AT3_MODES[mode],
                                           device=dev.type)
        expect = hashes.get(dev.type, {}).get(mode) != hashes["cpu"][mode]
        assert bool(rows) == expect, (mode, rows, expect)
        found += [(f"selfcheck {mode}", e) for e in rows]
    c = golden_check.case("tonal_dense")
    found += [("tonal_dense", e) for e in triage_at3.divergent_stages(
        golden_check.load(c)[0], c[4], device=dev.type)]
    default = dict(frame_bytes=384, no_gain_control=False, no_tonal=False)
    t0 = time.perf_counter()
    rows = triage_at3.divergent_stages(pcm, default, device=dev.type,
                                       streams=(0, 2))
    if time.perf_counter() - t0 <= 30.0 and streams > 2:
        rows += triage_at3.divergent_stages(pcm, default, device=dev.type,
                                            streams=(2, streams))
    else:
        streams = 2
    found += [(f"bench {pcm.shape[0]} x {pcm.shape[2] // 1024}", e)
              for e in rows]
    for mode, e in found:
        log(f"[17 triage] {mode} stream {e['stream']} frame {e['frame']}: "
            f"first plane {e['first_plane']}, first stage {e['stage']} "
            f"{e['outputs']}, ulp gap {e['ulp']} ({e['input']}; "
            f"{e['peak_ulp']!r} of the spacing at its peak), integer inputs "
            f"that differ {e['int_inputs']}, upstream output gaps in "
            f"spacings at their peak {e['upstream']}, class {e['class']}")
    classes = dict(Counter(e["class"] for _, e in found))
    log(f"[17 triage] {len(found)} frames where {dev.type} differs from the "
        f"CPU path (the bench batch's first {streams} streams), classes "
        f"{classes}")
    assert all(e["class"] == "knife_edge" for _, e in found), found

    # (d) the ATRAC1 units by which this device's bytes differ from the CPU
    # path's: the two ATRAC1 goldens, whole tracks, E's counter zeroed first
    zero_counts()
    rep1 = triage_at1.triage(dev.type,
                             log=lambda line: log(f"[17 triage] at1 {line}"))
    e17 = counts()["E"]
    units = [e for r in rep1.values() for e in r["vs_cpu"]]
    classes1 = dict(Counter(e["class"] for e in units))
    log(f"[17 triage] triage_at1 on {dev.type}: {len(units)} units differ "
        f"from the CPU path, classes {classes1}; identities "
        + ", ".join(f"{n} {r['identity']!r} (cpu {key['cpu']['triage_at1'][n]['identity']!r})"
                    for n, r in rep1.items())
        + f"; stored {dev.type!r} key "
        f"{'equal' if rep1 == want.get('triage_at1') else 'DIFFERENT'}; "
        f"E launches {e17}")
    assert e17 > 0 or dev.type == "cpu", e17
    assert all(e["class"] == "knife_edge" for e in units), units
    assert rep1 == want.get("triage_at1"), rep1
    log(f"[17 triage] phase 17 took {time.perf_counter() - t_phase:.1f} s | "
        f"{smi}")


SWEEP_GRIDS = {"at3": "32x256,64x256,128x256,64x512",
               "at1": "8x512,32x512,128x512",
               "campaign": ["--seconds", "12", "--streams", "16,64"]}


def sweeps_phase(dev, smi, at3_digest, at1_digest, grids=SWEEP_GRIDS,
                 repeats=2, iters=2):
    """Phase 18: the batch-shape sweeps and the perf campaign on ``dev``
    at short grids, ``repeats`` windows of ``iters`` calls a point: the
    ATRAC3 sweep on the kernel route (A, B, C launched), the ATRAC1 sweep on
    both routes (E launched on the kernel route only), the campaign.  Every
    row's bytes checked before they were timed; ATRAC1's two routes give
    the same bytes at every point; the points at the bench's shapes give
    phase 6's (ATRAC3 64 x 256, ``at3_digest``) and phase 7's (ATRAC1 8 x
    512, ``at1_digest``) bytes."""
    from atracdenc_tpu_torch import (bench, perf_campaign, sweep_at1_batch,
                                     sweep_at3_batch)
    t_phase = time.perf_counter()
    common = ["--device", dev.type, "--repeats", str(repeats), "--iters",
              str(iters)]

    checks = []

    def counted(check):
        def wrapped(*a, **kw):
            checks.append(check.__name__)
            return check(*a, **kw)
        return wrapped

    def run(tool, args):
        zero_counts()
        saved = bench.check_at3, bench.check_at1
        bench.check_at3, bench.check_at1 = map(counted, saved)
        try:
            with contextlib.redirect_stdout(io.StringIO()) as out:
                line = tool.main(common + args)
        finally:
            bench.check_at3, bench.check_at1 = saved
        for text in out.getvalue().splitlines()[:-1]:
            log(f"[18 sweeps] {tool.__name__.rsplit('.', 1)[1]}: {text}")
        log(f"[18 sweeps] {json.dumps(line)}")
        return line, counts()

    at3, c3 = run(sweep_at3_batch, ["--grid", grids["at3"], "--pallas"])
    at1 = {k: run(sweep_at1_batch, ["--grid", grids["at1"]]
                  + (["--pallas"] if k else [])) for k in (True, False)}
    camp, _ = run(perf_campaign, grids["campaign"])
    rows = at3["rows"] + at1[True][0]["rows"] + at1[False][0]["rows"] + \
        list(camp["at3"].values()) + list(camp["at1"].values())
    assert all(r["status"] == "ok" for r in rows), rows
    assert len(checks) == len(rows), (len(checks), len(rows))   # one a point
    by_shape = {(r["streams"], r["frames"]): r["sha256"] for r in at3["rows"]}
    for kern, ten in zip(at1[True][0]["rows"], at1[False][0]["rows"]):
        assert kern["sha256"] == ten["sha256"], (kern, ten)
    at1_shapes = {(r["streams"], r["frames"]): r["sha256"]
                  for r in at1[False][0]["rows"]}
    if (64, 256) in by_shape:
        assert by_shape[(64, 256)] == at3_digest, by_shape
    if (8, 512) in at1_shapes:
        assert at1_shapes[(8, 512)] == at1_digest, at1_shapes
    cuda = dev.type == "cuda"
    assert not cuda or all(c3[k] > 0 for k in "ABC"), c3
    assert not cuda or at1[True][1]["E"] > 0, at1[True][1]
    assert at1[False][1]["E"] == 0, at1[False][1]
    log(f"[18 sweeps] {len(rows)} points, {len(checks)} byte checks "
        f"({checks.count('check_at3')} ATRAC3, {checks.count('check_at1')} "
        f"ATRAC1) before the windows; ATRAC1 routes "
        f"equal at {len(at1_shapes)} points; launches ATRAC3 {c3}, ATRAC1 "
        f"kernel route {at1[True][1]}, tensor-op route {at1[False][1]}; "
        f"phase 18 took {time.perf_counter() - t_phase:.1f} s | {smi}")


def main():
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false — needs a GPU")
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np
    from atracdenc_tpu_torch import bench, cli, kernels, runtime
    # the bench's shapes: ATRAC3 64 x 256 stereo frames, ATRAC1 8 x 2 x 512
    # sound units (bench.py:220), ATRAC3+ 8 x 128 stereo frames (bench.py:230)
    from atracdenc_tpu_torch.bench import (AT1_FRAMES, AT1_STREAMS,
                                           AT3P_FRAMES, AT3P_STREAMS, SHAPES,
                                           corpus)
    from atracdenc_tpu_torch.models.atrac1.device_pack import (
        PLANES as AT1_PLANES, merge_channels)
    STREAMS, NFRAMES = SHAPES["cuda"]
    from atracdenc_tpu_torch.containers import aea, at3, oma, rm
    from atracdenc_tpu_torch.io import audio, wav
    from atracdenc_tpu_torch.models.atrac1 import frame as at1_frame
    from atracdenc_tpu_torch.models.atrac3 import frame
    from atracdenc_tpu_torch.models.atrac1 import decoder as at1_decoder
    from atracdenc_tpu_torch.models.atrac1 import device_pack as at1_pack
    from atracdenc_tpu_torch.models.atrac1 import encoder as at1_encoder
    from atracdenc_tpu_torch.models.atrac3 import (bitalloc, decoder,
                                                   device_pack, encoder)
    from atracdenc_tpu_torch.models.atrac3p import decoder as at3p_decoder
    from atracdenc_tpu_torch.models.atrac3p import encoder as at3p_encoder
    from atracdenc_tpu_torch.models.atrac3p import frame as at3p_frame
    from atracdenc_tpu_torch.tools import omainfo
    from atracdenc_tpu_torch import trace
    from atracdenc_tpu_torch.ops import (at1_alloc, bitdeposit, greedy,
                                         quant_cost, rate_control)
    from atracdenc_tpu_torch.trace_encode import capture, cuda_ms, device_kernels

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
    path, build_s, report = kernels.build(verbose=True)
    lib = kernels.library()
    log(f"[2 build] {os.path.relpath(path, ROOT)} built in {build_s:.1f} s")
    for fn, use in kernels.ptxas_usage(report).items():
        if any(k in fn for k in ("quant_cost", "greedy_scan", "rate_control",
                                 "bisect", "at1_allocate", "deposit", "gha_",
                                 "spectrum", "gain_kernel")):
            log(f"[2 build] ptxas {fn}: {use.get('registers')} registers, "
                f"{use.get('smem', 0)} B shared memory, {use.get('stack')} B "
                f"stack, {use.get('spill')} B spill stores")
    log(f"[2 build] greedy_scan_kernel: {lib.atrac3_greedy_smem_bytes()} B of "
        f"dynamic shared memory a block (not in ptxas's count)")

    # --- 3. kernels at their paths' shapes: capture the inputs each kernel
    # gets during one encode of the bench corpus
    pcm = corpus(STREAMS, NFRAMES)
    x = torch.from_numpy(pcm).to(dev)
    x1 = torch.from_numpy(pcm[:AT1_STREAMS, :, :512 * AT1_FRAMES]).to(dev)
    default = dict(no_gain_control=False, no_tonal=False)
    calls = capture([(bitalloc, "quant_cost_plain", "A"), (bitalloc, "greedy_scan", "B"),
                     (bitalloc, "rate_control_block", "C")],
                    lambda: encoder.encode_frames(x, **default))
    calls.update(capture([(bitalloc, "quant_cost_full", "D")],
                         lambda: encoder.encode_frames(x, fused_memo=True,
                                                       **default)))
    calls.update(capture([(at1_encoder, "at1_allocate_block", "E")],
                         lambda: at1_encoder.encode_frames(x1)))
    torch.cuda.synchronize()

    rows = {}

    def row(name, src, rep, err, ms, pms, n_bytes, n_ops):
        b_ms, b_by = bound(n_bytes, n_ops)
        rows[name] = {"name": name, "route": "cuda",
                      "source": f"atracdenc_tpu_torch/csrc/{src}",
                      "replaces": rep and f"atracdenc_tpu/ops/{rep}",
                      "max_abs_err": err, "ms": ms, "plain_ms": pms,
                      "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        return f"bound {b_ms:.4f} ms ({b_by})"

    (a_args, _), = calls["A"]
    err_k, vlc_k = quant_cost.quant_cost_plain(*a_args)
    err_p, vlc_p = quant_cost.quant_cost_torch(*a_args)
    assert torch.equal(vlc_k, vlc_p), "kernel A: vlc differs"
    ulp = ulps(err_k, err_p)
    assert int(ulp.max()) <= 4, f"kernel A: err off by {int(ulp.max())} ulp"
    a_ms = cuda_ms(lambda: quant_cost.quant_cost_plain(*a_args), 20, 3)
    a_pms = cuda_ms(lambda: quant_cost.quant_cost_torch(*a_args), 5, 1)
    a_bound = row("quant_cost_plain", "quant_cost.cu", "pallas_quant.py:339",
                  float((err_k - err_p).abs().max()), a_ms, a_pms,
                  4 * kept_values(*a_args) + nbytes(a_args[1], err_k, vlc_k),
                  kept_values(*a_args) * OPS["A_value"])
    log(f"[3 kernels] A quant_cost_plain {tuple(a_args[0].shape)}: vlc equal, "
        f"err <= {int(ulp.max())} ulp; kernel {a_ms:.3f} ms, plain {a_pms:.3f} ms, "
        f"{a_bound}; sha256(err, vlc) {digest(err_k, vlc_k)}")

    (d_args, _), = calls["D"]
    err_k, vlc_k = quant_cost.quant_cost_full(*d_args)
    err_p, vlc_p = quant_cost.quant_cost_full_torch(*d_args)
    torch.cuda.synchronize()
    bad = vlc_k != vlc_p
    ulp = ulps(err_k, err_p)
    log(f"[3 kernels] D quant_cost_full {tuple(d_args[0].shape)}: "
        f"{int(bad.sum())} vlc differ ({int(bad[..., 19:, :].sum())} in the EA "
        f"BFUs 19-31); err <= {int(ulp.max())} ulp (EA lanes "
        f"{int(ulp[..., 19:, 1:].max())})")
    assert not bool(bad.any()), "kernel D: vlc differs"
    assert int(ulp.max()) <= 4, f"kernel D: err off by {int(ulp.max())} ulp"
    d_ms = cuda_ms(lambda: quant_cost.quant_cost_full(*d_args), 10, 2)
    d_pms = cuda_ms(lambda: quant_cost.quant_cost_full_torch(*d_args), 2, 1)
    ab_ms = cuda_ms(lambda: bitalloc.quant_tensors(*d_args, fused_memo=False), 3, 1)
    d_bound = row("quant_cost_full", "quant_full.cu", "pallas_quant.py:289",
                  float((err_k - err_p).abs().max()), d_ms, d_pms,
                  4 * kept_values(*d_args) + nbytes(d_args[1], err_k, vlc_k),
                  kept_values(*d_args) * OPS["A_value"]
                  + 7 * kept_values(*d_args, first_bfu=19) * OPS["D_ea_elem"])
    log(f"[3 kernels] D quant_cost_full: vlc equal; kernel {d_ms:.3f} ms, plain "
        f"{d_pms:.3f} ms, the A + B memo (quant_tensors(fused_memo=False)) "
        f"{ab_ms:.3f} ms on the same input; {d_bound}; sha256(err, vlc) "
        f"{digest(err_k, vlc_k)}")
    del err_k, vlc_k, err_p, vlc_p, bad, ulp

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
    b_bound = row("greedy_scan", "greedy.cu", "pallas_greedy.py:47", b_err, b_ms,
                  b_pms, sum(nbytes(*a) + nbytes(a[4]) + a[2].numel() for a in b_calls),
                  sum(a[0].numel() for a in b_calls) * OPS["B_step"])
    log(f"[3 kernels] B greedy_scan {len(b_calls)} calls "
        f"{[tuple(a[0].shape) for a in b_calls]}: bit-equal; all calls "
        f"kernel {b_ms:.3f} ms, plain {b_pms:.3f} ms, {b_bound}")

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
    outk = rate_control.rate_control_block(*c_args, **c_kw)
    rounds = int((c_args[5].long() - outk[0].long() + 1).sum())   # shrinks + 1
    c_bound = row("rate_control_block", "rate_control.cu", "pallas_rate.py:242",
                  c_err, c_ms, c_pms, nbytes(*c_args, *outk),
                  rounds * 12 * OPS["C_eval"])
    log(f"[3 kernels] C rate_control_block {tuple(c_args[0].shape)}: num_bfu/"
        f"mode/wl equal (auto and fixed); kernel {c_ms:.3f} ms, "
        f"plain {c_pms:.3f} ms, {c_bound} ({rounds} bisection rounds)")

    # F's only path: one call on C's inputs, counted alone
    zero_counts()
    wl_f = rate_control.bisect_block(*c_args)
    torch.cuda.synchronize()
    f_launches = counts()["F"]
    assert f_launches > 0, f_launches
    wl_fp = rate_control.bisect_torch(*c_args)
    _, _, wl_c = rate_control.rate_control_block(*c_args, auto=False)
    assert torch.equal(wl_f, wl_fp), "kernel F differs from its plain version"
    assert torch.equal(wl_f, wl_c), "kernel F differs from C with auto=False"
    f_ms = cuda_ms(lambda: rate_control.bisect_block(*c_args), 5, 1)
    f_pms = cuda_ms(lambda: rate_control.bisect_torch(*c_args), 2, 1)
    f_bound = row("bisect_block", "bisect.cu", "pallas_alloc.py:433",
                  float((wl_f - wl_fp).abs().max()), f_ms, f_pms,
                  nbytes(*c_args, wl_f), c_args[3].numel() * 12 * OPS["C_eval"])
    log(f"[3 kernels] F bisect_block {tuple(c_args[0].shape)}: wl equal to its "
        f"plain version and to C with auto=False; kernel {f_ms:.3f} ms, plain "
        f"{f_pms:.3f} ms, {f_bound}")

    (e_args, e_kw), = calls["E"]
    e_err = 0.0
    for const in (e_kw["bfu_idx_const"], 4):
        idx_k, wl_k = at1_alloc.at1_allocate_block(*e_args, bfu_idx_const=const)
        idx_p, wl_p = at1_alloc.at1_allocate_torch(*e_args, bfu_idx_const=const)
        assert torch.equal(idx_k, idx_p) and torch.equal(wl_k, wl_p), \
            f"kernel E (bfu_idx_const={const}) differs"
        e_err = max(e_err, float((wl_k - wl_p).abs().max()),
                    float((idx_k - idx_p).abs().max()))
    assert e_kw["bfu_idx_const"] == 0, e_kw
    idx_k, wl_k = at1_alloc.at1_allocate_block(*e_args, **e_kw)
    e_ms = cuda_ms(lambda: at1_alloc.at1_allocate_block(*e_args, **e_kw), 20, 3)
    e_pms = cuda_ms(lambda: at1_alloc.at1_allocate_torch(*e_args, **e_kw), 3, 1)
    one = torch.zeros(1, device=dev)
    floor_ms = cuda_ms(lambda: one.add_(1.0), 20, 3)
    rounds = int((8 - idx_k.long()).sum())          # 1 + (7 - bfu_idx) a row
    e_bound = row("at1_allocate_block", "at1_alloc.cu", "pallas_alloc.py:362",
                  e_err, e_ms, e_pms, nbytes(*e_args, idx_k, wl_k),
                  rounds * 12 * OPS["E_eval"])
    log(f"[3 kernels] E at1_allocate_block {tuple(e_args[0].shape)}: bfu_idx/wl "
        f"equal (auto and --bfuidxconst 4); kernel {e_ms:.4f} ms, "
        f"plain {e_pms:.3f} ms, launch floor (one-element add_) "
        f"{floor_ms:.4f} ms, {e_bound} ({rounds} bisection rounds); "
        f"sha256(bfu_idx, wl) {digest(idx_k, wl_k)}")

    # G, the bit deposit (replaces no TPU kernel), on the packers' fields
    # tiled to the cells' shapes: ATRAC1 64 x 2 x 512 units, ATRAC3 64 x 512
    # frames a channel (two deposits a call)
    g_legs = {
        "at1": [a for a, _ in capture(
            [(at1_pack, "deposit_fields", "G")], lambda: at1_pack.pack_device(
                merge_channels(at1_encoder.encode_frames(x1))))["G"]],
        "at3": [a for a, _ in capture(
            [(device_pack, "deposit_fields", "G")],
            lambda: device_pack.pack_device_batch(
                encoder.encode_frames(x, **default), 384))["G"]]}
    for label, units in (("at1", 64 * 2 * 512), ("at3", 64 * 512)):
        g_args = [tuple(t.repeat(units // t.shape[0], 1) for t in a[:3]) + a[3:]
                  for a in g_legs.pop(label)]
        outs = [bitdeposit.deposit_fields(*a) for a in g_args]
        for a, out in zip(g_args, outs):
            assert torch.equal(out, bitdeposit.deposit_fields_torch(*a)), \
                f"kernel G ({label}) differs from its plain version"
        g_ms = cuda_ms(lambda: [bitdeposit.deposit_fields(*a) for a in g_args],
                       20, 3)
        g_pms = cuda_ms(lambda: [bitdeposit.deposit_fields_torch(*a)
                                 for a in g_args], 2, 1)
        g_bound = row(f"deposit_fields.{label}", "bitdeposit.cu", None, 0.0,
                      g_ms, g_pms, sum(nbytes(*a[:3]) for a in g_args)
                      + nbytes(*outs), 0)
        log(f"[3 kernels] G deposit_fields ({label}) "
            f"{[(tuple(a[0].shape), str(a[0].dtype), a[3]) for a in g_args]}: "
            f"bytes equal its plain version; kernel {g_ms:.4f} ms, plain "
            f"{g_pms:.3f} ms, {g_bound} a call; sha256 {digest(*outs)}")
        del g_args, outs
        torch.cuda.empty_cache()
    at3p_calls = at3p_cell_calls(x)
    log(gha_kernel_check(at3p_calls.pop("H"), row))
    log(spectrum_kernel_check(at3p_calls.pop("I"), row))
    del at3p_calls
    from atracdenc_tpu_torch.testing import gain_cell_call
    log(gain_kernel_check(gain_cell_call(dev), row))
    del calls, b_calls, a_args, c_args, d_args, e_args, outk
    torch.cuda.empty_cache()

    # --- 4. golden (reference-oracle frames)
    gdir = os.path.join(ROOT, "tests", "golden")
    g3 = np.load(os.path.join(gdir, "at3_golden.npz"))
    gd = np.load(os.path.join(gdir, "at3_default_golden.npz"))
    counts0 = counts()
    for (label, pcm_g, ref, floor, nogain), fused in itertools.product((
            ("at3_golden (no gain, no tonal)", g3["pcm_in"], g3["ref_frames"],
             0.99, True),
            ("at3_default_golden pcm_in", gd["pcm_in"], gd["ref_frames"],
             0.98, False),
            ("at3_default_golden pcm_stress", gd["pcm_stress"], gd["ref_stress"],
             0.85, False)), (False, True)):
        planes = encoder.encode_track(pcm_g, no_gain_control=nogain,
                                      no_tonal=nogain, device="cuda",
                                      fused_memo=fused)
        ident = float((frame.pack(planes, 384) == ref).mean())
        memo = "fused memo (D)" if fused else "A + B memo"
        log(f"[4 golden] {label}, {memo}: byte identity vs reference "
            f"{ident:.4f} (floor {floor})")
        assert ident >= floor, (label, memo)
    # ATRAC1: identity over every frame of the reference AEA (its first
    # frame is the writer's zero dummy), as the port's CPU tests count it
    for name, ref_file, floor in (("at1_golden", "at1_ref.aea", 0.93),
                                  ("at1_stress_pcm", "at1_stress_ref.aea", 0.97)):
        pcm_g = np.load(os.path.join(gdir, f"{name}.npz"))["pcm_in"]
        planes = at1_encoder.encode_track(pcm_g, device="cuda")
        units = at1_frame.pack(merge_channels(planes))
        ref, _, _, _ = aea.read(os.path.join(gdir, ref_file))
        ident = float((units == ref).mean())
        log(f"[4 golden] {name} (ATRAC1): byte identity vs reference "
            f"{ident:.5f} (floor {floor})")
        assert ident >= floor, name
    counts1 = counts()
    assert all(counts1[k] > counts0[k] for k in "ABCDE"), (counts0, counts1)
    g3p = np.load(os.path.join(gdir, "at3p_golden.npz"))
    for key in ("mixed", "loud"):
        planes = at3p_encoder.encode_track(g3p[f"pcm_{key}"], use_gha=False,
                                           device="cuda")
        ours, ref = at3p_frame.pack(planes, 2), g3p[f"ref_{key}"]
        n3p = min(len(ours), len(ref))
        ident = float((ours[:n3p] == ref[:n3p]).mean())
        log(f"[4 golden] at3p_golden pcm_{key} (ATRAC3+, GHA off): byte "
            f"identity vs reference {ident!r} over {n3p} frames (floor 0.99)")
        assert n3p == 8 and ident >= 0.99, key
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
    # the ATRAC3 QA decoder on CUDA against itself on the CPU
    for name, mod in (("ref_c.oma", oma), ("ref_c.at3", at3), ("ref_c.rm", rm),
                      ("ref_js.oma", oma)):
        frames_g, info = mod.read(os.path.join(gdir, name))
        js = info.get("joint_stereo", False)
        on_gpu, on_cpu = (decoder.decode_track(frames_g, info["channels"],
                                               js=js, device=d)
                          for d in ("cuda", "cpu"))
        assert on_gpu.shape == on_cpu.shape and np.isfinite(on_gpu).all()
        err3 = float(np.abs(on_gpu - on_cpu).max())
        log(f"[4 golden] {name} (ATRAC3{', joint stereo' if js else ''}) "
            f"decoded on CUDA: {on_gpu.shape}, max |CUDA - CPU| {err3!r} "
            f"(bound 1e-5)")
        assert err3 <= 1e-5, (name, err3)
    # quality parity (tests/test_at3_decoder.py): the port's frames and the
    # reference encoder's, both encoded and decoded on CUDA
    ours3 = frame.pack(encoder.encode_track(g3["pcm_in"], device="cuda"), 384)
    dec_ref3, dec_ours3 = (decoder.decode_track(f, 2, device="cuda")
                           for f in (g3["ref_frames"], ours3))
    n3 = min(dec_ref3.shape[1], g3["pcm_in"].shape[1]) - 2048
    x3 = g3["pcm_in"][:, 1024:n3].astype(np.float64)
    p_ref, p_ours = (float(psnr(x3, d[:, 1024:n3].astype(np.float64)))
                     for d in (dec_ref3, dec_ours3))
    log(f"[4 golden] at3_golden quality parity on CUDA: PSNR of the port's "
        f"frames {p_ours!r} dB, of the reference frames {p_ref!r} dB "
        f"(gate: > reference - 0.05 dB)")
    assert p_ours > p_ref - 0.05, (p_ours, p_ref)

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

    # --- 6. ATRAC3 real size, main path (encode + device packer); the
    # counters zeroed just before and read just after
    opts = default
    encoder.encode_frames_bytes(x, **opts)                  # warm
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    dev_bytes = encoder.encode_frames_bytes(x, **opts)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    c6 = counts()
    launches = {"quant_cost_plain": c6["A"], "greedy_scan": c6["B"],
                "rate_control_block": c6["C"], "bisect_block": f_launches,
                "deposit_fields.at3": trace.counter("launch.deposit"),
                "at3_gain_analysis": trace.counter("launch.at3_gain")}
    assert all(c6[k] > 0 for k in "ABC") and c6["D"] == 0, c6
    assert launches["deposit_fields.at3"] == 2, launches    # one a channel
    assert launches["at3_gain_analysis"] == 1, launches     # one a call
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
        f"{n_st / t_all:.1f} stereo frames/s; bytes equal, sha256 "
        f"{digest(fr_dev)} | {smi} | launches {launches}")

    # --- 7. ATRAC1 real size: bench.py's AT1 leg; E's counter zeroed just
    # before and read just after
    at1_pack.pack_device(merge_channels(at1_encoder.encode_frames(x1)))  # warm
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    planes1 = at1_encoder.encode_frames(x1)
    units_dev = at1_pack.pack_device(merge_channels(planes1))
    torch.cuda.synchronize()
    t1 = time.perf_counter() - t0
    launches["at1_allocate_block"] = counts()["E"]
    launches["deposit_fields.at1"] = trace.counter("launch.deposit")
    assert counts()["E"] > 0, counts()["E"]
    assert launches["deposit_fields.at1"] == 1, launches
    n_units = AT1_STREAMS * CHANNELS * AT1_FRAMES
    units_host = at1_frame.pack({k: runtime.to_numpy(v)
                                 for k, v in merge_channels(planes1).items()})
    assert units_dev.shape == (n_units, 212)
    assert np.array_equal(runtime.to_numpy(units_dev), units_host), \
        "ATRAC1 device packer differs from frame.pack"
    log(f"[7 atrac1 real size] {AT1_STREAMS} x {CHANNELS} x {AT1_FRAMES} "
        f"sound units: encode + device pack {t1:.4f} s = {n_units / t1:.1f} "
        f"units/s; bytes equal the host packer's, sha256 {digest(units_host)} "
        f"| {smi} | launches {counts()['E']}")

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
    assert all(c1[k] > c0[k] for k in "ABC"), (c0, c1)
    log(f"[8 cli] 30 s WAV -> {os.path.relpath(oma_out, ROOT)}: "
        f"{frames_cli.shape[0]} frames of 384 bytes, launches {c0} -> {c1}")
    wav3_back = os.path.join(work, "back30s_at3.wav")
    cli.main(["-d", "-i", oma_out, "-o", wav3_back, "--nostdout"])
    back3, rate = audio.read(wav3_back)
    assert rate == 44100 and back3.shape == (2, want * 1024 - 1162), back3.shape
    seg3 = slice(1024, back3.shape[1] - 1024)
    gain3_db = 20 * np.log10(np.sqrt(np.mean(back3[:, seg3] ** 2))
                             / np.sqrt(np.mean(pcm30[:, seg3] ** 2)))
    assert abs(gain3_db) < 1.0, gain3_db
    yaml_out = os.path.join(work, "gain30s.yaml")
    cli.main(["-e", "atrac3", "-i", wav_in, "-o",
              os.path.join(work, "yaml30s.oma"), "--nostdout",
              "--yaml-log", yaml_out])
    with open(yaml_out) as fp:
        docs = fp.read().count("---\n")
    assert docs == n // 1024, (docs, n // 1024)
    info_out = io.StringIO()
    with contextlib.redirect_stdout(info_out):
        assert omainfo.main([oma_out]) == 0
    info_line = info_out.getvalue().strip()
    assert "ATRAC3" in info_line and "framesize: 384" in info_line, info_line
    log(f"[8 cli] -d {os.path.basename(oma_out)} back to WAV: RMS "
        f"{gain3_db:+.3f} dB against the input; --yaml-log: {docs} documents "
        f"(one per whole frame); omainfo: {info_line.split(': ', 1)[1]}")
    aea_out = os.path.join(work, "out30s.aea")
    wav_back = os.path.join(work, "back30s.wav")
    cli.main(["-e", "atrac1", "-i", wav_in, "-o", aea_out, "--nostdout"])
    c2 = counts()
    assert c2["E"] > c1["E"], (c1, c2)
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
        f"{gain_db:+.3f} dB against the input, E launches {c1['E']} -> {c2['E']}")
    oma3p = os.path.join(work, "out30s_at3p.oma")
    wav3p_back = os.path.join(work, "back30s_at3p.wav")
    t0 = time.perf_counter()
    cli.main(["-e", "atrac3plus", "-i", wav_in, "-o", oma3p, "--nostdout"])
    t_enc3p = time.perf_counter() - t0
    frames3p, info3p = oma.read(oma3p)
    want3p = -(-n // 2048)
    assert frames3p.shape == (want3p, 2048), (frames3p.shape, want3p)
    assert info3p["codec"] == oma.CODEC_ATRAC3PLUS
    t0 = time.perf_counter()
    cli.main(["-d", "-i", oma3p, "-o", wav3p_back, "--nostdout"])
    t_dec3p = time.perf_counter() - t0
    back3p, rate = audio.read(wav3p_back)
    assert rate == 44100 and back3p.shape == (2, want3p * 2048 - 368), \
        back3p.shape
    d3p = at3p_decoder.DELAY - 368          # the decoder drops the PQF delay
    seg = slice(2048, n - 2 * d3p)
    gain3p_db = 20 * np.log10(
        np.sqrt(np.mean(back3p[:, d3p + seg.start: d3p + seg.stop] ** 2))
        / np.sqrt(np.mean(pcm30[:, seg] ** 2)))
    assert abs(gain3p_db) < 1.0, gain3p_db
    oma3p_wb = os.path.join(work, "out30s_at3p_wideband.oma")
    cli.main(["-e", "atrac3plus", "--advanced", "ghadbg=15,ghawbrefine=1",
              "-i", wav_in, "-o", oma3p_wb, "--nostdout"])
    frames_wb, info_wb = oma.read(oma3p_wb)
    assert frames_wb.shape == (want3p, 2048)
    assert info_wb["codec"] == oma.CODEC_ATRAC3PLUS
    parsed_wb = [at3p_frame.unpack_frame(frames_wb[i], 2)
                 for i in range(100, 110)]
    n_tonal = sum(p_["tones"] is not None for p_ in parsed_wb)
    assert n_tonal > 0 and all(p_["bits_used"] <= 2048 * 8 for p_ in parsed_wb)
    log(f"[8 cli] 30 s WAV -> {os.path.relpath(oma3p, ROOT)} (ATRAC3+): "
        f"{frames3p.shape[0]} frames of 2048 bytes in {t_enc3p:.2f} s; -d back "
        f"to WAV in {t_dec3p:.2f} s: RMS {gain3p_db:+.3f} dB against the "
        f"input; --advanced ghadbg=15,ghawbrefine=1: {frames_wb.shape[0]} "
        f"frames, {n_tonal} of frames 100-109 parse with a tonal block")

    # --- 9. the fused memo at real size: phase 6's corpus and options with
    # kernel D computing the memo; the counters zeroed just before
    fused = dict(opts, fused_memo=True)
    encoder.encode_frames_bytes(x, **fused)                 # warm
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    fused_bytes = encoder.encode_frames_bytes(x, **fused)
    torch.cuda.synchronize()
    t_fused = time.perf_counter() - t0
    c9 = counts()
    launches["quant_cost_full"] = c9["D"]
    assert c9["D"] > 0 and c9["B"] > 0 and c9["C"] > 0 and c9["A"] == 0, c9
    fr_fused = runtime.to_numpy(fused_bytes)
    assert fr_fused.shape == fr_dev.shape, fr_fused.shape
    ident = float(np.mean(fr_fused == fr_dev))
    log(f"[9 fused memo] {STREAMS} x {NFRAMES} stereo frames: encode + device "
        f"pack with kernel D {t_fused:.3f} s = {n_st / t_fused:.1f} stereo "
        f"frames/s (phase 6, A + B memo: {n_st / t_dev:.1f}); byte identity "
        f"with phase 6's bytes {ident!r} (floor 0.999), sha256 "
        f"{digest(fr_fused)} | {smi} | launches {c9}")
    assert ident >= 0.999, ident

    # --- 10. ATRAC3 decode at real size: phase 6's device-packed bytes
    n10 = 8
    t0 = time.perf_counter()
    parsed = []
    for s_ in range(n10):
        parsed.append(decoder.dequantize(frame.unpack(fr_dev[s_], CHANNELS)))
        if s_ == 3 and 2 * (time.perf_counter() - t0) > 60.0:
            n10 = 4                       # 8 streams would parse for > 60 s
            break
    specs, gnp, glev, gloc = (np.concatenate(a) for a in zip(*parsed))
    t_parse = time.perf_counter() - t0
    decoder.decode_frames(specs, gnp, glev, gloc, device="cuda")      # warm
    t0 = time.perf_counter()
    pcm10 = decoder.decode_frames(specs, gnp, glev, gloc, device="cuda")
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    assert pcm10.shape == (n10 * CHANNELS, NFRAMES * 1024 - 1162), pcm10.shape
    assert np.isfinite(pcm10).all() and np.abs(pcm10).max() <= 1.0
    one_cpu = decoder.decode_frames(specs[:2], gnp[:2], glev[:2], gloc[:2],
                                    device="cpu")
    err10 = float(np.abs(pcm10[:2] - one_cpu).max())
    assert err10 <= 1e-5, err10
    pcm16 = np.clip(np.round(pcm10 * 32767.0), -32768, 32767).astype(np.int16)
    n10_st = n10 * NFRAMES
    # where the device decode's time goes: one more call under the profiler
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        decoder.decode_frames(specs, gnp, glev, gloc, device="cuda")
    dev_ev = device_kernels(prof)
    busy10 = sum(ms for _, ms, _ in dev_ev)
    copy10 = sum(ms for k, ms, _ in dev_ev if "memcpy" in k.lower())
    top10 = ", ".join(f"{k[:40]} {ms:.3f} ms x{c}" for k, ms, c in
                      sorted(dev_ev, key=lambda r: -r[1])[:4])
    log(f"[10 atrac3 decode] {n10} x {NFRAMES} stereo frames of 384 B"
        f"{' (cut from 8 streams: the host parse of 8 would pass 60 s)' if n10 < 8 else ''}"
        f": host parse (unpack + dequantize) {t_parse:.3f} s = "
        f"{n10_st / t_parse:.1f} stereo frames/s; device decode "
        f"(decode_frames {tuple(specs.shape)}) {t_dec:.4f} s = "
        f"{n10_st / t_dec:.1f}; whole {n10_st / (t_parse + t_dec):.1f} stereo "
        f"frames/s; stream 0 max |CUDA - CPU| {err10!r}; sha256(int16 PCM) "
        f"{digest(pcm16)} | {smi}")
    log(f"[10 atrac3 decode] decode_frames profiled: device busy "
        f"{busy10:.3f} ms, of which copies {copy10:.3f} ms, in "
        f"{sum(c for _, _, c in dev_ev)} device events; top: {top10}")

    # --- 11. ATRAC3+ real size: bench.py's AT3P leg, GHA mask 7
    t_phase11 = time.perf_counter()
    s11, f11 = AT3P_STREAMS, AT3P_FRAMES
    x11 = x[:s11, :, :2048 * f11].contiguous()
    at3p_encoder.encode_frames_bytes(x11, CHANNELS)           # warm
    torch.cuda.synchronize()
    zero_counts()
    t11 = []
    for _ in range(3):
        t0 = time.perf_counter()
        b11 = at3p_encoder.encode_frames_bytes(x11, CHANNELS)
        torch.cuda.synchronize()
        t11.append(time.perf_counter() - t0)
    c11 = counts()
    assert not any(c11.values()), c11        # ATRAC3+ has no TPU kernel
    assert trace.counter("launch.deposit") == 3, "G: one deposit a call"
    launches["gha_greedy"] = trace.counter("launch.gha_greedy") // 3
    assert launches["gha_greedy"] == 16, "H: 8 rounds a pass, two passes"
    launches["at3p_spectrum_fields"] = trace.counter("launch.at3p_spectrum") // 3
    assert launches["at3p_spectrum_fields"] == 2, "I: one launch a channel"
    fr11 = runtime.to_numpy(b11)
    assert fr11.shape == (s11, f11, 2048), fr11.shape
    t0 = time.perf_counter()
    n_host = s11
    for s_ in range(s11):
        planes = at3p_encoder.encode_track(pcm[s_, :, :2048 * f11],
                                           device="cuda")
        assert np.array_equal(at3p_frame.pack(planes, CHANNELS), fr11[s_]), \
            f"ATRAC3+ stream {s_}: device bytes differ from frame.pack"
        if s_ == 1 and (time.perf_counter() - t0) * s11 / 2 > 30.0:
            n_host = 4                 # 8 streams would take > 30 s here
        if s_ + 1 == n_host:
            break
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    specs11, tones11 = at3p_decoder.dequantize(fr11[0], CHANNELS)
    t_parse11 = time.perf_counter() - t0
    at3p_decoder.decode_frames(specs11, tones11, device="cuda")    # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pcm11 = at3p_decoder.decode_frames(specs11, tones11, device="cuda")
    t_dec11 = time.perf_counter() - t0
    pcm11_cpu = at3p_decoder.decode_frames(specs11, tones11, device="cpu")
    assert pcm11.shape == (CHANNELS, 2048 * f11 - 368), pcm11.shape
    assert np.isfinite(pcm11).all() and np.abs(pcm11).max() <= 1.0
    err11 = float(np.abs(pcm11 - pcm11_cpu).max())
    assert err11 <= 1e-5, err11
    with torch.profiler.profile(activities=acts) as prof:
        at3p_encoder.encode_frames_bytes(x11, CHANNELS)
        torch.cuda.synchronize()
    ev11 = device_kernels(prof)
    busy11 = sum(ms for _, ms, _ in ev11)
    top11 = ", ".join(f"{k[:40]} {ms:.3f} ms x{c}" for k, ms, c in
                      sorted(ev11, key=lambda r: -r[1])[:5])
    n11 = s11 * f11
    log(f"[11 atrac3+ real size] {s11} x {f11} stereo frames of 2048 B, GHA "
        f"mask 7: encode + device pack {', '.join(f'{v:.4f}' for v in t11)} s "
        f"= {', '.join(f'{n11 / v:.1f}' for v in t11)} stereo frames/s; bytes "
        f"equal encode_track + frame.pack on {n_host} streams"
        f"{' (cut from 8: the host part would pass 60 s)' if n_host < s11 else ''}"
        f" in {t_host:.1f} s; sha256 {digest(fr11)}; A-F launches {c11} | {smi}")
    log(f"[11 atrac3+ real size] stream 0 decode: host parse {t_parse11:.2f} s, "
        f"device decode_frames {t_dec11:.4f} s, max |CUDA - CPU| {err11!r}")
    log(f"[11 atrac3+ real size] encode_frames_bytes profiled: device busy "
        f"{busy11:.3f} ms in {sum(c for _, _, c in ev11)} device launches; "
        f"top: {top11}")
    # the batched chunk call at the atrac3plus.batch cell's shape: 64
    # tracks x 2 chunks of 512 frames, the carry passed on, against the
    # whole-track call on one track
    del b11, x11
    torch.cuda.empty_cache()
    kc = 512
    xc = x.repeat(1, 1, -(-2 * kc * 2048 // x.shape[-1]))[..., :2 * kc * 2048]
    xc = xc.contiguous()
    cut = kc * 2048
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    c1, st = at3p_encoder.encode_chunk_bytes(
        xc[..., :cut].contiguous(), None, xc[..., cut:cut + 2048].contiguous())
    c2, _ = at3p_encoder.encode_chunk_bytes(xc[..., cut:].contiguous(), st,
                                            None)
    torch.cuda.synchronize()
    t_chunk = time.perf_counter() - t0
    peak_chunk = torch.cuda.max_memory_allocated() / 2 ** 30
    whole = at3p_encoder.encode_frames_bytes(xc[:1], CHANNELS)
    assert torch.equal(torch.cat([c1[0], c2[0]]), whole[0]), \
        "ATRAC3+ chunked bytes differ from the whole-track call's"
    log(f"[11 atrac3+ real size] encode_chunk_bytes at {xc.shape[0]} x "
        f"2 x {kc} stereo frames with the carry: {t_chunk:.3f} s = "
        f"{xc.shape[0] * 2 * kc / t_chunk:.1f} stereo frames/s (the first "
        f"calls at this shape), peak {peak_chunk:.2f} GiB; stream 0 equals "
        f"encode_frames_bytes, sha256 {digest(runtime.to_numpy(c1))}; phase "
        f"11 took {time.perf_counter() - t_phase11:.1f} s")
    del xc, c1, c2, st, whole
    torch.cuda.empty_cache()

    # --- 12. the mesh at full width; 13. the batch transcoder
    torch.cuda.empty_cache()
    mesh_phase(dev, smi, work, pcm, fr_dev, t_dev,
               {k: runtime.to_numpy(planes1[k]) for k in AT1_PLANES})
    transcode_phase(smi, work, [wav_in], {"atrac3": oma_out, "atrac1": aea_out,
                                          "atrac3plus": oma3p})

    # --- 14. the port's bench in this process, its counters zeroed just
    # before and read just after; its line goes to the log, never last
    zero_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as bench_out:
        line = bench.main(["--repeats", "3"])
    c14 = counts()
    log(f"[14 bench] {bench_out.getvalue().strip()}")
    ex = line["extra"]
    assert ex["platform"] == "cuda" and ex["repeats"] == 3, ex
    assert line["value"] == max(ex["at3_fps_xla_rate_ctl"],
                                ex["at3_fps_pallas_rate_ctl"]), line
    assert all(lo > 0 for lo, _ in ex["spread"].values()), ex["spread"]
    want = {"at3": digest(fr_dev), "at1": digest(units_host), "at3p": digest(fr11)}
    assert ex["sha256"] == want, (ex["sha256"], want)
    assert all(c14[k] > 0 for k in "ABCE"), c14
    log(f"[14 bench] python -m atracdenc_tpu_torch.bench --repeats 3 in "
        f"{time.perf_counter() - t0:.1f} s: value {line['value']:.1f} stereo "
        f"frames/s; leg digests equal phases 6, 7 and 11; launches in its "
        f"window {c14} | {smi}")

    # --- 15. every ATRAC3 mode on the card; 16. the scaling bench
    modes_phase(dev, smi, work, pcm)
    scaling_phase(smi)

    # --- 17. the byte-identity triage on the card; 18. the sweeps
    triage_phase(dev, smi, pcm)
    sweeps_phase(dev, smi, digest(fr_dev), digest(units_host))

    print(json.dumps({"kernels": [dict(r, launches=launches[name])
                                  for name, r in rows.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(int(sys.argv[2]), *sys.argv[3:6]))
    sys.exit(main())
