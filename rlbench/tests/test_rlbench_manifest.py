"""BENCHMARK.json against the contract's shape, and every cell's files
found by name."""
import json
import os
import re

import pytest

from rlbench import run as R

ROOT = R.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["rlbench"]
    assert bench["command"][:2] == ["python3", "rlbench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(ROOT / "BENCHMARK.json") <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group in ("end_to_end", "per_layer"), e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
    metric_names = [n for m, n in names if m]
    assert len(metric_names) == len(set(metric_names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for c in bench["configs"]:
        for k in c["reduced"]:
            assert NAME.match(k)


def test_metric_rules(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for w in m.get("workloads", []):
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", [w])
    for w in bench["workloads"]:
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
        assert any(R.applies(m, w["name"], {x["name"] for x in reported})
                   for m in bench["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in json.load(
    open(R.ROOT / "BENCHMARK.json"))["workloads"]])
def test_cell_files_found_by_name(cell):
    files = R.cell_files(cell)
    assert files.cell["name"] == cell
    assert files.workload["driver"] == "grpo"
    assert (ROOT / "rlbench" / "harness" /
            f"{files.workload['driver']}.py").exists()
    limits = files.workload["check"]["limits"]
    assert limits and all(v > 0 for v in limits.values())
    assert files.config["name"] == files.cell["config"]


def test_configs_one_file_each(bench):
    paths = [c["file"] for c in bench["configs"]]
    assert len(paths) == len(set(paths))
    for c in bench["configs"]:
        assert c["file"].startswith("rlbench/")
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["flop_params"] > 0
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_every_per_layer_metric_has_a_reader(bench):
    for m in bench["per_layer"]:
        assert callable(R.reader(m["name"]))
