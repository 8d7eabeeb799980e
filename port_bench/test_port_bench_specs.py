"""``BENCHMARK.json`` and the files it names: every cell, configuration,
driver and per-layer metric resolves by name, every name and unit keeps
to the characters allowed, and each cell reports what it must."""
from __future__ import annotations

import json
import re

import pytest

from port_bench import bench

SPEC = bench.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["port_bench"]
    assert SPEC["command"] == ["python3", "port_bench/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    w = next(x for x in SPEC["workloads"] if x["name"] == name)
    cell = bench.cell_spec(name)
    assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
    assert cell["why"] == w["why"] and len(w["why"]) <= 200
    assert (bench.HERE / "drivers" / f"{cell['driver']}.py").exists()
    assert bench.config_spec(cell["config"])["name"] == cell["config"]
    assert cell["limits"], "a cell compares at least one number"
    for key in ("name", "config", "traffic"):
        assert NAME.match(w[key]), w[key]


@pytest.mark.parametrize("name", CELLS)
def test_cell_reports_what_it_must(name):
    e2e = [m["name"] for m in SPEC["end_to_end"]
           if name in m.get("workloads", [name])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in SPEC["per_layer"]
             if name in m.get("workloads", [name])]
    assert layer and all(m["moves"] in e2e for m in layer)


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(cfg):
    f = bench.ROOT / cfg["file"]
    assert f.exists() and cfg["file"].startswith("port_bench/")
    data = json.loads(f.read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    assert sorted(data["published"]) == sorted(cfg["reduced"])
    assert all(data[k] != v for k, v in data["published"].items())
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])
    widths = ("hidden_size", "intermediate_size", "num_attention_heads",
              "num_key_value_heads", "num_experts_per_tok")
    assert not set(cfg["reduced"]) & set(widths)


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names_and_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert set(m["workloads"]) <= set(CELLS) if "workloads" in m else True
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(m):
    assert (bench.HERE / "metrics" / f"{m['name']}.py").exists()
    assert callable(bench.reader(m["name"]).read)
    assert "\n" not in m["layer"] and len(m["layer"]) <= 200


def test_names_are_unique():
    for group in (CELLS, [m["name"] for m in METRICS],
                  [c["name"] for c in SPEC["configs"]]):
        assert len(group) == len(set(group))
