"""The port's selfcheck (``python -m atracdenc_tpu_torch.selfcheck``) on the
CPU: its corpus against ``tools/selfcheck.py``'s, the ``at3_js``, ``at1``
and ``at3p`` hashes against the port's ``cpu`` key and the JAX tool's, the
exit codes of ``main``, and no fallback without a card.  The two LP2 modes
are in tests/test_torch_selfcheck_at3.py, a separate file so that the two
halves of the CPU encode run on separate test workers."""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from atracdenc_tpu_torch import selfcheck
from atracdenc_tpu_torch.testing import cpu_setup

cpu_setup()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("at3_js", "at1", "at3p")


def jax_tool():
    """tools/selfcheck.py as a module (it imports JAX only inside
    ``compute_hashes``, which no test here calls)."""
    spec = importlib.util.spec_from_file_location(
        "jax_selfcheck_tool", os.path.join(ROOT, "tools", "selfcheck.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stored(path=selfcheck.HASH_FILE):
    with open(path) as fp:
        return json.load(fp)


@pytest.fixture(scope="module")
def hashes():
    return selfcheck.compute_hashes("cpu", MODES)


def test_corpus_is_the_jax_tools():
    want = jax_tool().corpus()
    got = selfcheck.corpus()
    assert got.dtype == np.float32 and got.shape == (4, 2, 65536)
    assert np.array_equal(got, want)


def test_hash_file_layout():
    """The JAX file's layout, a key per platform with the five modes; the
    ``cuda`` key was taken on an H100 and confirmed by a second run."""
    keys = stored()
    assert set(keys) == {"cpu", "cuda"}
    for plat, modes in keys.items():
        assert tuple(modes) == selfcheck.MODES, plat
        assert all(len(h) == 32 for h in modes.values()), plat


@pytest.mark.parametrize("mode", MODES)
def test_hash_equals_port_cpu_key(hashes, mode):
    assert hashes[mode] == stored()["cpu"][mode]


@pytest.mark.parametrize("mode", MODES)
def test_hash_equals_jax_tools_cpu_key(hashes, mode):
    """The JAX tool's stored key for these three modes is current: the
    port's CPU bytes are the JAX package's."""
    assert hashes[mode] == stored(jax_tool().HASH_FILE)["cpu"][mode]


def test_main_exit_codes(hashes, tmp_path, monkeypatch, capsys):
    """0 when every mode is equal, 1 with one MISMATCH line per mode that
    differs, 2 without a stored key; --update writes the key.  The hashes
    are this file's own CPU hashes (with the two LP2 modes from the key,
    which tests/test_torch_selfcheck_at3.py computes)."""
    got = {**stored()["cpu"], **hashes}
    monkeypatch.setattr(selfcheck, "compute_hashes", lambda dev: dict(got))
    path = tmp_path / "hashes.json"
    path.write_text(json.dumps(stored()))
    monkeypatch.setattr(selfcheck, "HASH_FILE", str(path))

    assert selfcheck.main(["--device", "cpu"]) == 0
    assert "selfcheck OK [cpu]: 5 modes" in capsys.readouterr().out

    tampered = stored()
    tampered["cpu"]["at1"] = "0" * 32
    tampered["cpu"]["at3p"] = "1" * 32
    path.write_text(json.dumps(tampered))
    assert selfcheck.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out.splitlines()
    assert out == [f"MISMATCH at1: want {'0' * 32} got {got['at1']}",
                   f"MISMATCH at3p: want {'1' * 32} got {got['at3p']}"]

    assert selfcheck.main(["--device", "cpu", "--platform-key", "tpu"]) == 2
    assert "no stored hashes for platform tpu" in capsys.readouterr().out

    assert selfcheck.main(["--device", "cpu", "--update"]) == 0
    assert json.loads(path.read_text())["cpu"] == got
    assert selfcheck.main(["--device", "cpu"]) == 0


def test_unknown_mode_raises():
    with pytest.raises(ValueError, match="unknown mode"):
        selfcheck.compute("cpu", ("at3_lp1",))


def test_refuses_without_cuda():
    """Without a GPU and without --device cpu the selfcheck exits non-zero
    with runtime.device's message and hashes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the selfcheck would run")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "atracdenc_tpu_torch.selfcheck"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT,
                         env=env)
    assert res.returncode != 0
    assert "CUDA requested" in res.stderr
    assert "selfcheck OK" not in res.stdout and "MISMATCH" not in res.stdout
