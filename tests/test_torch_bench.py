"""The port's benchmark (``python -m atracdenc_tpu_torch.bench``) on the CPU:
bench.py's keys, bench.py's corpus, a tiny liveness run, and no fallback."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_py_keys():
    """(top-level keys, extra keys) of the JSON line in bench.py's source,
    read with ast: bench.py imports JAX and is never run here."""
    with open(os.path.join(ROOT, "bench.py")) as fp:
        tree = ast.parse(fp.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            top = {k.value: v for k, v in zip(node.keys, node.values)}
            return set(top), {k.value for k in top["extra"].keys}
    raise AssertionError("no JSON line with 'metric' in bench.py")


@pytest.fixture(scope="module")
def tiny_run():
    """main() on the CPU with its CPU shape cut to 1 stream of 2 stereo
    frames (ATRAC1 1 x 2 x 4, ATRAC3+ 1 x 1), one repeat; the line it
    returns and what it printed."""
    import contextlib
    import io
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setitem(bench.SHAPES, "cpu", (1, 2))
        line = bench.main(["--device", "cpu", "--repeats", "1"])
    return line, out.getvalue()


def test_line_has_every_key_of_bench_py(tiny_run):
    line, _ = tiny_run
    top, extra = _bench_py_keys()
    assert len(extra) == 12, extra          # bench.py:243-261
    assert top <= set(line), top - set(line)
    assert extra <= set(line["extra"]), extra - set(line["extra"])
    for k in ("device_name", "power_limit_w", "repeats", "spread", "sha256",
              "at3_fps_fused_memo", "shapes"):
        assert k in line["extra"], k


def test_corpus_is_bench_py_s():
    """bench.py:153-165 written out here, at bench.py's CPU shape."""
    streams, channels, nframes = 4, 2, 32
    t = 1024 * nframes
    rng = np.random.default_rng(42)
    n = np.arange(t, dtype=np.float64)
    base = 0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
    want = np.clip(base[None, None, :] * np.asarray([1.0, 0.8])[None, :, None]
                   + 0.05 * rng.standard_normal((streams, channels, t)),
                   -1, 1).astype(np.float32)
    got = bench.corpus(4, 32)
    assert got.dtype == np.float32 and got.shape == (4, 2, 32768)
    assert np.array_equal(got, want)
    assert not np.array_equal(bench.corpus(4, 32, seed=43), want)


def test_tiny_cpu_run(tiny_run):
    """One JSON last line, platform cpu, every rate > 0, value the larger
    route; the routes' bytes were held equal inside main (it asserts)."""
    line, printed = tiny_run
    last = printed.strip().splitlines()[-1]
    assert json.loads(last) == line
    ex = line["extra"]
    assert ex["platform"] == "cpu" and ex["repeats"] == 1
    assert ex["device_name"] is None and ex["power_limit_w"] is None
    assert ex["shapes"] == {"at3": [1, 2], "at1": [1, 8], "at3p": [1, 1]}
    assert set(ex["spread"]) == {
        "at3_fps_xla_rate_ctl", "at3_fps_pallas_rate_ctl",
        "at3_fps_compute_only", "at3_fps_fused_memo", "d2h_link_mbps",
        "atrac1_units_per_s", "at1_units_per_s_compute_only",
        "at3p_gha_frames_per_s", "at3p_fps_compute_only"}
    for k, (lo, hi) in ex["spread"].items():
        assert 0 < lo <= ex[k] <= hi, k
    assert line["value"] == max(ex["at3_fps_xla_rate_ctl"],
                                ex["at3_fps_pallas_rate_ctl"])
    assert line["vs_baseline"] == line["value"] / bench.REF_FRAMES_PER_S
    assert set(ex["sha256"]) == {"at3", "at1", "at3p"}


def test_leg_digests_are_the_bytes_of_the_legs(tiny_run):
    """The line's SHA-256s are those of the legs' bytes, packed on the host
    here (ATRAC3: frame.pack per stream; ATRAC1: frame.pack of the merged
    units), so that the card's digests can be held against chip_smoke.py."""
    import hashlib
    from atracdenc_tpu_torch.models.atrac1 import device_pack as at1_pack
    from atracdenc_tpu_torch.models.atrac1 import encoder as at1_encoder
    from atracdenc_tpu_torch.models.atrac1 import frame as at1_frame
    from atracdenc_tpu_torch.models.atrac3 import encoder, frame
    from atracdenc_tpu_torch.runtime import to_numpy
    line, _ = tiny_run
    x = torch.from_numpy(bench.corpus(1, 2))
    planes = encoder.encode_frames(x, no_gain_control=False, no_tonal=False)
    at3 = frame.pack({k: to_numpy(v[0]) for k, v in planes.items()}, 384)
    planes1 = at1_pack.merge_channels(
        at1_encoder.encode_frames(x[:, :, :512 * 4]))
    at1 = at1_frame.pack({k: to_numpy(v) for k, v in planes1.items()})
    digest = {"at3": hashlib.sha256(at3[None].tobytes()).hexdigest(),
              "at1": hashlib.sha256(at1.tobytes()).hexdigest()}
    assert {k: line["extra"]["sha256"][k] for k in digest} == digest


def test_refuses_without_cuda():
    """Without a GPU and without --device cpu the bench exits non-zero with
    runtime.device's message and prints no JSON."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the bench would run")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "atracdenc_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env=env)
    assert res.returncode != 0
    assert "CUDA requested" in res.stderr
    assert "{" not in res.stdout


def test_bad_options_exit():
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--repeats", "0"])
    with pytest.raises(SystemExit):                 # no shape options
        bench.main(["--device", "cpu", "--frames", "2"])
