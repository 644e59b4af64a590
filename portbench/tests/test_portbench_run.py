"""``python3 -m portbench.run`` refuses to run without a card (no CPU
fallback), and in a checkout that holds only the benchmark."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import manifest, run

ARGS = ["--workload", "atrac3-lp2.batch", "--seed", "7", "--seconds", "1",
        "--trace", "0"]


def test_no_card_no_line(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "CUDA" in out.err


def test_too_few_cards(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_command_without_card():
    """The command itself, in a fresh interpreter: no card here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run"] + ARGS,
                       cwd=manifest.ROOT, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_alone_fails(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ has no program:
    the run exits non-zero and prints no line, even where a card is
    found (faked here, so that the missing program is what stops it)."""
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "from portbench import run\n"
            f"sys.exit(run.main({ARGS!r}))\n")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120, env=env)
    assert p.returncode != 0 and p.stdout == ""
    assert "atracdenc_tpu_torch" in p.stderr


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "atracdenc_tpu_torch_probe",
                        sys.modules["os"])
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys.modules["os"])
    assert run.loaded_forbidden() == ["jax"]
