"""``BENCHMARK.json`` against the structure the benchmark's contract sets,
and every file it names or the harness finds by name there."""

import json
import os
import re

import pytest

from conftest import REPO
from portbench.harness import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_keys_and_names(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"][:2] == ["python3", "portbench/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    for p in spec["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p)
        assert os.path.isdir(os.path.join(REPO, p))
    names = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert c["file"].startswith("portbench/")
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    cells = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names
        assert NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] == 1
        cells.add(w["name"])
    assert len(cells) == len(spec["workloads"])
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("cell", ["flagship.serve.b1", "flagship.train.b2",
                                  "i64x32.serve.k16"])
def test_every_cell_has_its_files_and_metrics(spec, cell):
    w = {x["name"]: x for x in spec["workloads"]}[cell]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    assert os.path.isfile(os.path.join(REPO, cfg["file"]))
    traffic = bench.load_json(os.path.join(REPO, "portbench", "traffic",
                                           w["traffic"] + ".json"))
    assert os.path.isfile(os.path.join(REPO, "portbench", "drivers",
                                       traffic["driver"] + ".py"))
    assert os.path.isfile(os.path.join(REPO, "portbench", "limits",
                                       cell + ".json"))
    e2e, layer = bench.cell_metrics(spec, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and layer
    for m in e2e + layer:
        assert os.path.isfile(os.path.join(REPO, "portbench", "metrics",
                                           m["name"] + ".py"))
    for m in layer:
        assert m["moves"] in names
