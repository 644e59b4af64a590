"""The port's OMA tools against the JAX package's on one file: omainfo and
omacp print the same text, omacp writes the same bytes, and both return 1
with a usage line when called without their arguments."""
import os

import pytest

from atracdenc_tpu.tools import omacp as jomacp, omainfo as jomainfo
from atracdenc_tpu_torch.tools import omacp, omainfo

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TOOLS = {"jax": (jomainfo, jomacp), "torch": (omainfo, omacp)}


@pytest.mark.parametrize("src", ["ref_c.oma", "ref_js.oma"])
def test_tools_match(src, tmp_path, capsys):
    path = os.path.join(GOLDEN, src)
    out, copies = {}, {}
    for name, (info, cp) in TOOLS.items():
        dst = tmp_path / f"{name}.oma"
        assert info.main([path]) == 0
        assert cp.main([path, str(dst)]) == 0
        out[name] = capsys.readouterr().out
        copies[name] = dst.read_bytes()
    assert out["torch"] == out["jax"]
    assert "codec: ATRAC3" in out["torch"] and "framesize:" in out["torch"]
    assert copies["torch"] == copies["jax"]


@pytest.mark.parametrize("name", sorted(TOOLS))
def test_usage(name, capsys):
    info, cp = TOOLS[name]
    assert info.main([]) == 1 and cp.main(["one"]) == 1
    text = capsys.readouterr().out
    assert text.count("usage") == 2
    if name == "torch":
        assert "atracdenc_tpu_torch.tools.omainfo" in text
