"""Resolve a cell by its name in ``BENCHMARK.json`` to its files.

A workload ``<config>.<mix>`` names a configuration (``configs[].file``,
whose ``"codec"`` picks ``portbench/codecs/<codec>.py`` and
``portbench/reference/<codec>.py``), a traffic mix
(``portbench/traffic/<mix>.json``, whose ``"driver"`` picks
``portbench/drivers/<driver>.py``), its limits
(``portbench/limits/<workload>.json``), its end-to-end metrics and its
per-layer metrics (each read by ``portbench/metrics/<metric>.py``).
Nothing here names a cell: a new cell is new files and entries.
"""
import dataclasses
import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path):
    with open(path) as fp:
        return json.load(fp)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list          # metric entries this cell reports (trace 0)
    per_layer: list           # metric entries this cell reports (trace 1)

    def codec_module(self):
        return importlib.import_module(f"portbench.codecs.{self.config['codec']}")

    def reference_module(self):
        return importlib.import_module(
            f"portbench.reference.{self.config['codec']}")

    def driver_module(self):
        return importlib.import_module(
            f"portbench.drivers.{self.traffic['driver']}")


def benchmark(root=ROOT):
    return _json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric, name, e2e_names):
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def cell(name, root=ROOT):
    """The cell ``name`` of ``BENCHMARK.json`` with every file it needs
    read; KeyError for a name the manifest does not hold."""
    bench = benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = _json(os.path.join(root, cfg_entry["file"]))
    traffic = _json(os.path.join(HERE, "traffic", wl["traffic"] + ".json"))
    limits = _json(os.path.join(HERE, "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, wl, config, traffic, limits, e2e, per_layer)


def reader(metric_name):
    """The module ``portbench/metrics/<metric_name>.py`` (names hold dots,
    so it is loaded by path)."""
    path = os.path.join(HERE, "metrics", metric_name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
