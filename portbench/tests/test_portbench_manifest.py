"""BENCHMARK.json against the contract's shape, and each cell resolved by
name to its configuration, traffic, limits and metric readers."""
import json
import os
import re

import pytest

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = manifest.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_references():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", ()):
            assert w in {x["name"] for x in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert os.path.exists(os.path.join(manifest.ROOT, c["file"]))


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(name):
    cell = manifest.cell(name)
    assert cell.workload["chips"] == 1
    assert cell.codec_module().Codec(cell.config).row_bytes > 0
    assert cell.reference_module().Reference(cell.config).row_bytes > 0
    assert hasattr(cell.driver_module(), "Driver")
    assert cell.limits and set(cell.limits) <= {
        "frames_differ", "worst_frame_err", "mean_frame_err"}
    assert cell.config["check_frames"] > 0
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert len([n for n in e2e if n.split(".")[0] == "encode_rate"]) == 1
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        r = manifest.reader(m["name"])
        assert callable(r.read)
        for spec in r.SPANS:
            assert spec["clock"] in ("sync", "events", "host")


def test_unknown_cell():
    with pytest.raises(KeyError):
        manifest.cell("no-such-config.batch")
