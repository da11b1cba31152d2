"""The benchmark's files: every configuration, traffic mix, cell and metric
loads by name, its names and units use the allowed characters, and
BENCHMARK.json agrees with the cells' files."""

import importlib.util
import json
import os
import re

import pytest

from portbench.driver import HERE, load

ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CALLS = {"warm_start", "sample_hypers", "optimize_Z", "predict"}


def _names(kind, ext=".json"):
    return sorted(f[:-len(ext)] for f in os.listdir(os.path.join(HERE, kind)) if f.endswith(ext))


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert {m["name"] for m in bench["end_to_end"]} == {"draws_per_s", "setup_s"}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", _names("configs"))
def test_config_loads(name, bench):
    cfg = load("configs", name)
    assert NAME.match(name)
    entry = {c["name"]: c for c in bench["configs"]}[name]
    assert entry["file"] == f"portbench/configs/{name}.json"
    assert entry["reduced"] == cfg["reduced"]
    for key in ("N", "D", "M", "dtype", "jitter", "data", "data_seed"):
        assert key in cfg


@pytest.mark.parametrize("name", _names("traffic"))
def test_traffic_loads(name):
    mix = load("traffic", name)
    assert NAME.match(name)
    assert isinstance(mix["fresh_model"], bool)
    assert {op["op"] for op in mix["setup"] + mix["unit"]} <= CALLS
    assert any(op["op"] == "sample_hypers" for op in mix["unit"])


@pytest.mark.parametrize("name", _names("workloads"))
def test_cell_loads(name, bench):
    w = load("workloads", name)
    assert NAME.match(name)
    entry = {c["name"]: c for c in bench["workloads"]}[name]
    assert (entry["config"], entry["traffic"], entry["chips"]) == (w["config"], w["traffic"],
                                                                   w["chips"])
    load("configs", w["config"])
    load("traffic", w["traffic"])
    assert w["limits"] and all(v >= 0 for v in w["limits"].values())


@pytest.mark.parametrize("name", _names("metrics", ".py"))
def test_metric_loads(name, bench):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert NAME.match(name) and UNIT.match(mod.UNIT) and callable(mod.read)
    entry = {m["name"]: m for m in bench["per_layer"]}[name]
    assert entry["unit"] == mod.UNIT and entry["moves"] == "draws_per_s"
    assert set(entry["workloads"]) <= {w["name"] for w in bench["workloads"]}


def test_every_entry_has_a_file(bench):
    assert {c["name"] for c in bench["configs"]} == set(_names("configs"))
    assert {w["name"] for w in bench["workloads"]} == set(_names("workloads"))
    assert {m["name"] for m in bench["per_layer"]} == set(_names("metrics", ".py"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
