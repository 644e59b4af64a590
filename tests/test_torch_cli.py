"""The port's CLI where it once differed from the JAX CLI: an unexpected
exception becomes ``Encode/Decode error: ...`` and a non-zero exit, and
``--bfuidxfast`` is accepted as a deprecated no-op with the JAX CLI's
notice.  Each case runs through both CLIs on the same file; encoding runs
the port's CPU path."""
import os

import numpy as np
import pytest

from atracdenc_tpu import cli as jax_cli
from atracdenc_tpu.io import wav
from atracdenc_tpu_torch import cli as torch_cli

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CLIS = {"jax": jax_cli, "torch": torch_cli}
NOTICE = "--bfuidxfast option is deprecated and will be removed."


@pytest.mark.parametrize("name", sorted(CLIS))
def test_truncated_aea_exits_with_a_message(tmp_path, name):
    """A whole 2048-byte AEA header and 5 bytes: no complete sound unit, so
    the decoder's reshape fails past the header."""
    with open(os.path.join(GOLDEN, "at1_ref.aea"), "rb") as fp:
        head = fp.read(2048 + 5)
    src = tmp_path / "truncated.aea"
    src.write_bytes(head)
    with pytest.raises(SystemExit) as exc:
        CLIS[name].main(["-d", "-i", str(src), "-o", str(tmp_path / "out.wav"),
                         "--nostdout"])
    assert exc.value.code == ("Encode/Decode error: cannot reshape array of "
                              "size 0 into shape (0,newaxis)")
    assert not (tmp_path / "out.wav").exists()


@pytest.mark.parametrize("name", sorted(CLIS))
def test_bfuidxfast_notice_comes_before_the_mode_check(tmp_path, name, capsys):
    with pytest.raises(SystemExit) as exc:
        CLIS[name].main(["--bfuidxfast", "-i", str(tmp_path / "in.wav"),
                         "-o", str(tmp_path / "out.aea")])
    assert exc.value.code == "Select mode: encode or decode"
    assert capsys.readouterr().out == NOTICE + "\n"


def test_bfuidxfast_encodes_as_without_it(tmp_path, capsys):
    src = str(tmp_path / "in.wav")
    k = np.arange(512 * 6)
    sig = 0.4 * np.sin(2 * np.pi * 997 * k / 44100)
    wav.write(src, np.stack([sig, 0.7 * sig]).astype(np.float32), 44100)
    outs = []
    for extra in ([], ["--bfuidxfast"]):
        out = tmp_path / f"out{len(outs)}.aea"
        torch_cli.main(["-e", "atrac1", "-i", src, "-o", str(out), "--nostdout",
                        "--device", "cpu"] + extra)
        outs.append(out.read_bytes())
    assert capsys.readouterr().out == NOTICE + "\n"
    assert outs[0] == outs[1] and len(outs[0]) == 2048 + 12 * 212
