"""The harness finds every configuration, workload, traffic kind and metric
by its name in BENCHMARK.json, and BENCHMARK.json keeps to its contract."""

import importlib
import json
import re

import pytest

from portbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_loads(cfg):
    assert cfg["file"] == f"portbench/configs/{cfg['name']}.json"
    c = harness.load_json("configs", cfg["name"] + ".json")
    assert set(cfg["reduced"]) <= set(c)
    assert {"hpfw", "source", "assumed", "guarantees"} <= set(c)


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_workload_file_and_kind_load(cell):
    w = harness.load_json("workloads", cell["name"] + ".json")
    kind = importlib.import_module(f"portbench.traffic.{w['kind']}")
    for fn in ("setup", "window", "release", "check", "control"):
        assert callable(getattr(kind, fn))
    assert w["limits"]
    e2e, per = harness.cell_metrics(BENCH, cell["name"])
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per
    assert {m["moves"] for m in per} <= {m["name"] for m in e2e}


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_reader_loads(metric):
    assert callable(harness.load_module("metrics", metric["name"] + ".py").read)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert BENCH["paths"] == ["portbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + METRICS]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in METRICS)
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    assert all(m["source"] in ("host_clock", "device_trace") for m in BENCH["end_to_end"])
    assert all(m["unit"] == "%" for m in METRICS if "roofline" in m["name"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in BENCH["configs"]}
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers <= {"serve", "match", "extract", "kernels", "device"}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.Run("no.such.cell", 1, 1.0, False, None, 0.0)
