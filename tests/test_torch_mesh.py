"""The port's scale-out (atracdenc_tpu_torch/parallel/) on the CPU.

One module fixture starts four gloo ranks on the CPU (fresh interpreters,
a free port, a timeout) that run every sharded case once; the tests hold
their results against the port's single-rank (1x1 mesh) results, computed
here, and those against the JAX package's 1x1 mesh on the same numpy
input (tests/test_mesh.py runs the JAX mesh itself).  Bytes and integer
planes must be equal; the ATRAC1 decode, raw matmul output, within 1e-6 as
in the JAX package.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from atracdenc_tpu.models.atrac3p import encoder as jax_at3p
from atracdenc_tpu.parallel import distributed as JD
from atracdenc_tpu.parallel import mesh as JM
from atracdenc_tpu_torch.models.atrac3 import device_pack as at3_pack
from atracdenc_tpu_torch.parallel import distributed as D
from atracdenc_tpu_torch.parallel import mesh as M
from atracdenc_tpu_torch.testing import (assert_equal, cpu_setup,
                                         roll_jax_scans, t)

cpu_setup()
AT3_MESHES = [(4, 1), (2, 2), (1, 4)]
AT3P_CASES = [(7, None), (7, True), (15, True)]

# one rank of the 2 x 2 / 4 x 1 / 1 x 4 meshes over a 4-rank gloo group;
# argv: input npz, output prefix, coordinator, rank
_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from atracdenc_tpu_torch.parallel import distributed as D, mesh as M

src, out, coord, rank = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
dev = D.initialize(coord, 4, rank, device="cpu")
x = np.load(src)
res = {}
for dp, sp in %(at3)r:
    res[f"at3_{dp}x{sp}"] = M.encode_batch_at3_bytes_sharded(
        x["at3"], M.Mesh(dp, sp, dev))
m22 = M.make_mesh(4, device=dev)
assert m22.shape == {"dp": 2, "sp": 2}
res["at3_js"] = M.encode_batch_at3_bytes_sharded(x["at3"], m22, js=True,
                                                 frame_bytes=192)
planes = M.encode_batch_at3_sharded(x["at3"], m22)
res.update({f"at3_planes.{k}": v for k, v in planes.items()})
at1 = M.encode_batch_sharded(x["at1"], m22)
res.update({f"at1.{k}": v for k, v in at1.items()})
m41 = M.make_mesh(4, dp=4, device=dev)
res["at1_decode"] = M.decode_batch_at1_sharded(at1, m41)
for mask, wb in %(at3p)r:
    core = M.encode_core_at3p_sharded(x["at3p"], m22, gha_mask=mask,
                                      wb_refine=wb)
    res.update({f"at3p_{mask}_{wb}.{k}": v for k, v in core.items()})
start, count = D.local_batch_slice(4, m22)
mine = D.encode_batch_global(x["at3"][start:start + count], m22)
np.save(f"{out}.global{rank}.npy", mine)
try:
    D.local_batch_slice(7, m41)
    raised = ""
except ValueError as e:
    raised = str(e)
if rank == 0:
    np.savez(out + ".npz", **res)
    with open(out + ".json", "w") as fp:
        json.dump({"slice": [start, count], "raised": raised,
                   "global_mesh": [D.global_mesh(device=dev).shape,
                                   D.global_mesh(2, device=dev).shape]}, fp)
D.finalize()
""" % {"at3": AT3_MESHES, "at3p": AT3P_CASES}


@pytest.fixture(autouse=True, scope="module")
def _jax_reference_setup():
    """Rolled scans for the JAX encoders; and, as tests/test_mesh.py does,
    no persistent jit cache for executables compiled with shardings."""
    jax.config.update("jax_enable_compilation_cache", False)
    with pytest.MonkeyPatch.context() as mp:
        roll_jax_scans(mp, jax.lax)
        yield
    jax.clear_caches()
    jax.config.update("jax_enable_compilation_cache", True)


def _pcm(s, t, seed):
    """tests/test_mesh.py's input: a 997 Hz tone and noise."""
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    base = 0.4 * np.sin(2 * np.pi * 997.0 * n / 44100.0)
    return np.clip(base[None, None, :]
                   + 0.05 * rng.standard_normal((s, 2, t)),
                   -1, 1).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    return {"at3": _pcm(4, 1024 * 8, 0), "at1": _pcm(4, 512 * 4, 1),
            "at3p": _pcm(2, 2048 * 4, 5)}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """The four ranks' results: rank 0's global outputs, every rank's
    ``encode_batch_global`` row, and rank 0's slice and error text."""
    d = tmp_path_factory.mktemp("mesh")
    src, out = str(d / "in.npz"), str(d / "out")
    np.savez(src, **inputs)
    D.launch(lambda r, coord: [sys.executable, "-c", _RANK, src, out, coord,
                               str(r)], 4, timeout=300)
    res = dict(np.load(out + ".npz"))
    res["global"] = [np.load(f"{out}.global{r}.npy") for r in range(4)]
    with open(out + ".json") as fp:
        res.update(json.load(fp))
    return res


@pytest.fixture(scope="module")
def single(inputs):
    """The port's single-rank run: the 1 x 1 mesh, no process group."""
    m1 = M.Mesh(1, 1, "cpu")
    out = {"at3": M.encode_batch_at3_bytes_sharded(inputs["at3"], m1),
           "at3_js": M.encode_batch_at3_bytes_sharded(
               inputs["at3"], m1, js=True, frame_bytes=192),
           "at1": M.encode_batch_sharded(inputs["at1"], m1)}
    for mask, wb in AT3P_CASES:
        out[f"at3p_{mask}_{wb}"] = M.encode_core_at3p_sharded(
            inputs["at3p"], m1, gha_mask=mask, wb_refine=wb)
    return out


def _jax_mesh1():
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))


@pytest.mark.parametrize("dp,sp", AT3_MESHES)
def test_at3_bytes_sharded_equal_single_rank(ranks, single, dp, sp):
    got = ranks[f"at3_{dp}x{sp}"]
    assert got.shape == (4, 8, 384) and got.dtype == np.uint8
    assert_equal(single["at3"], got, f"{dp} x {sp}")


def test_at3_planes_sharded_equal_single_rank(ranks, single, inputs):
    """Every plane of the default mode on 2 x 2, the float loudness and
    clip_max included, equal to one rank's and to ``encode_batch_at3`` on
    the whole batch."""
    whole = M.encode_batch_at3(t(inputs["at3"]))
    assert sorted(k for k in ranks if k.startswith("at3_planes.")) == \
        sorted(f"at3_planes.{k}" for k in whole)
    for k, v in whole.items():
        assert_equal(v, ranks[f"at3_planes.{k}"], k)
    assert_equal(single["at3"], at3_pack.pack_device_batch(whole, 384), "bytes")


def test_at3_js_bytes_sharded_equal_single_rank(ranks, single):
    """Joint stereo at 192 B: M/S matrixing, the byte-budget shift and the
    reversed channel-1 deposit across the sp chain."""
    assert_equal(single["at3_js"], ranks["at3_js"], "js")


def test_at1_planes_sharded_equal_single_rank(ranks, single):
    """2 x 2 with 2 frames a column: the 3-frame PCM tail of the carry
    reaches past the previous column."""
    assert sorted(single["at1"]) == ["bfu_idx", "mant", "sfi", "short_mask",
                                     "wordlen"]
    for k, v in single["at1"].items():
        assert_equal(v, ranks[f"at1.{k}"], k)


@pytest.mark.parametrize("mask,wb", AT3P_CASES,
                         ids=["gha7", "gha7_wb_refine", "gha15_wideband"])
def test_at3p_core_sharded_equal_single_rank(ranks, single, mask, wb):
    """Every plane of the core, the tone planes included.  With mask 7 the
    wb_refine flag is inert (tests/test_mesh.py's wideband case); mask 15
    runs the wideband strategy itself."""
    ref = single[f"at3p_{mask}_{wb}"]
    assert "tones.valid" in ref and ref["tones.valid"].any()
    for k, v in ref.items():
        assert_equal(v, ranks[f"at3p_{mask}_{wb}.{k}"], k)


def test_at1_decode_sharded_over_dp(ranks, inputs):
    """dp = 4 decode of the 2 x 2 mesh's planes against one rank's."""
    planes = {k: ranks[f"at1.{k}"] for k in ("short_mask", "wordlen", "sfi",
                                             "mant")}
    dec1 = M.decode_batch_at1_sharded(planes, M.Mesh(1, 1, "cpu"))
    dec = ranks["at1_decode"]
    assert dec.shape == (4, 2, 512 * 4)
    assert np.max(np.abs(dec - dec1)) <= 1e-6
    pcm = inputs["at1"]
    assert np.sqrt((dec ** 2).mean()) > 0.1 * np.sqrt((pcm ** 2).mean())


def test_encode_batch_global_returns_each_stream_once(ranks, single):
    """Each rank gets its dp row's streams once (not sp copies of them),
    with every frame, equal to the single-rank bytes of those streams."""
    assert ranks["slice"] == [0, 2]
    for r, got in enumerate(ranks["global"]):
        row = r // 2
        assert got.shape == (2, 8, 384)
        assert_equal(single["at3"][2 * row:2 * row + 2], got, f"rank {r}")


def test_local_batch_slice_rejects_indivisible(ranks):
    assert "must divide the dp axis" in ranks["raised"]


def test_global_mesh_is_all_dp_by_default(ranks):
    assert ranks["global_mesh"] == [{"dp": 4, "sp": 1}, {"dp": 2, "sp": 2}]


def test_corpus_shard_equals_jax():
    paths = [f"t{i}.wav" for i in range(7)]
    for n in (1, 2, 3, 4):
        for k in range(n):
            assert D.corpus_shard(paths, k, n) == JD.corpus_shard(paths, k, n)


def test_mesh_needs_the_whole_group():
    """A mesh of more than one rank needs a process group of its size;
    the 1 x 1 mesh needs none."""
    assert M.make_mesh(device="cpu").shape == {"dp": 1, "sp": 1}
    with pytest.raises(ValueError, match="process group of 4 ranks"):
        M.Mesh(2, 2, "cpu")


def test_single_rank_equals_jax_at3_bytes(inputs, single):
    ref = JM.encode_batch_at3_bytes_sharded(jnp.asarray(inputs["at3"]),
                                            _jax_mesh1())
    assert_equal(np.asarray(ref), single["at3"], "at3 bytes")


def test_single_rank_equals_jax_at1_planes(inputs, single):
    ref = JM.encode_batch_sharded(jnp.asarray(inputs["at1"]), _jax_mesh1())
    assert sorted(ref) == sorted(single["at1"])
    for k, v in single["at1"].items():
        assert_equal(np.asarray(ref[k]), v, k)


def test_single_rank_equals_jax_at3p_core(inputs, single):
    """The JAX core vmapped over streams (its dryrun_sharded's function) on
    the 1 x 1 mesh's input, GHA 7."""
    ref = jax.device_get(jax.vmap(lambda p: jax_at3p._encode_core(
        p, gha_mask=7))(jnp.asarray(inputs["at3p"])))
    *arrays, tones = ref
    want = dict(zip(("sfi", "mant", "spec_tab", "spec_bits"), arrays))
    want.update({f"tones.{k}": v for k, v in tones.items()})
    got = single["at3p_7_None"]
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        assert_equal(np.asarray(v), got[k], k)
