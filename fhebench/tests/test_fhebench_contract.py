"""BENCHMARK.json against the benchmark's contract, and every name in it
against the files the harness finds by that name."""

import importlib
import json
import os
import re

import pytest

from fhebench.run import ROOT, metrics_of, resolve

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
CELLS = [w["name"] for w in BENCH["workloads"]]


def line(text) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_run_seconds_fit_the_check_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"])
        assert NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_e2e_and_a_layer(cell):
    e2e = [m["name"] for m in metrics_of(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert metrics_of(BENCH, cell, True)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    _, entry, config, mix = resolve(cell)
    driver = importlib.import_module(f"fhebench.traffic.{mix['driver']}")
    assert callable(driver.setup) and callable(driver.check)
    assert set(mix["limits"]) and all(v == 0 for v in mix["limits"].values())
    for trace in (False, True):
        for m in metrics_of(BENCH, cell, trace):
            mod = importlib.import_module(
                f"fhebench.metrics.{m['name'].split('.')[0]}")
            assert callable(mod.read)


def test_every_config_is_used_and_at_most_a_quarter_on_four_chips():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
