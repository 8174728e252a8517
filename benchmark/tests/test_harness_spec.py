"""BENCHMARK.json and the files it names hold together."""

import importlib
import json
import re

import pytest

from benchmark.harness import common

ROOT = json.loads((common.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in ROOT["workloads"]]


def test_top_level_keys_and_limits():
    assert set(ROOT) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert ROOT["paths"] == ["benchmark"]
    assert 1 <= ROOT["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (ROOT["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [m["name"] for m in ROOT["end_to_end"] + ROOT["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    setup = next(m for m in ROOT["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    for m in ROOT["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_names_what_exists(cell):
    spec = common.load_spec(cell)
    entry = next(w for w in ROOT["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1 and len(entry["why"]) <= 200
    kind = importlib.import_module(f"benchmark.traffic.{spec.traffic['kind']}")
    for fn in ("setup", "unit", "end_to_end", "shapes", "check"):
        assert callable(getattr(kind, fn))
    assert spec.config["name"] == entry["config"]
    assert all(map(callable, common.reference_model(spec.config)))
    assert all(callable(common.named("work", f)) for f in spec.config["work"].values())
    assert set(spec.cell) == {"trace_units", "limits"}
    e2e = [m["name"] for m in spec.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and spec.per_layer
    for m in spec.per_layer:
        assert m["moves"] in e2e
        path = common.BENCH / "metrics" / f"{m['name']}.py"
        assert callable(common.load_module(path, m["name"]).read)


@pytest.mark.parametrize("entry", ROOT["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    conf = json.loads((common.REPO / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"] == [] and conf["dtype"] == "float32"
    assert not conf["tf32"]
    assert any(w["config"] == entry["name"] for w in ROOT["workloads"])
