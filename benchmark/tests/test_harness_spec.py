"""BENCHMARK.json against the contract's shape, and every name in it
resolved to its files."""

import json
import re

import pytest

from benchmark.harness import common

SPEC = common.load_json(common.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1] == "benchmark/run.py"


def test_names_units_and_texts():
    items = (SPEC["configs"] + SPEC["workloads"] + SPEC["end_to_end"]
             + SPEC["per_layer"])
    for it in items:
        assert NAME.match(it["name"]), it["name"]
        for k in ("why", "layer"):
            if k in it:
                assert TEXT.match(it[k]), (it["name"], k)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in SPEC["configs"]:
        assert TEXT.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    names = [it["name"] for it in items]
    assert len(names) == len(set(names))


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = common.cell(name)
    assert cell["traffic"]["generator"]
    assert (common.BENCH / "harness"
            / f"{cell['traffic']['generator']}.py").is_file()
    assert cell["limits"]
    conf = next(c for c in SPEC["configs"]
                if c["name"] == cell["workload"]["config"])
    assert conf["file"].startswith("benchmark/configs/")
    assert cell["config"]["name"] == conf["name"]
    assert sorted(cell["config"]["reduced"]) == sorted(conf["reduced"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_reports_setup_another_e2e_and_a_layer(name):
    cell = common.cell(name)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        assert m["moves"] in e2e, (name, m["name"])


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_per_layer_metric_has_its_reader(metric):
    assert callable(common.reader(metric).read)


def test_configs_used_and_files_distinct():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
