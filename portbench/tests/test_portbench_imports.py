"""What the benchmark loads: never ``jax``, ``jaxlib``, ``flax`` or the JAX
package (by whole top-level name: ``atracdenc_tpu_torch`` is the port),
and the reference loads nothing of the program."""
import subprocess
import sys

from portbench import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "atracdenc_tpu"}


def _top_level(code):
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=manifest.ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    return set(p.stdout.split())


def test_benchmark_loads_no_jax():
    names = [w["name"] for w in manifest.benchmark()["workloads"]]
    code = ("from portbench import manifest, run, tracing, work, control\n"
            f"for n in {names!r}:\n"
            "    c = manifest.cell(n)\n"
            "    c.codec_module(); c.reference_module(); c.driver_module()\n"
            "    [manifest.reader(m['name']) for m in c.per_layer]\n")
    loaded = _top_level(code)
    assert "atracdenc_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    """The upstream model and its adapters load numpy and the standard
    library only: not the program, not torch, not JAX."""
    loaded = _top_level(
        "import portbench.reference.atrac3, portbench.reference.atrac1\n")
    assert not loaded & (FORBIDDEN | {"atracdenc_tpu_torch", "torch"})
