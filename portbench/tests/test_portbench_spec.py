"""BENCHMARK.json against the contract's form, and the harness finding
each cell's configuration, traffic, limits and metric readers by name
from files alone."""

from __future__ import annotations

import json
import re

import pytest

from portbench import harness
from portbench.tests.portbench_fixtures import REPO, with_ready_cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def spec(ready: bool = False) -> dict:
    s = harness.load_spec(REPO)
    return with_ready_cells(s) if ready else s


BOTH = pytest.mark.parametrize("ready", (False, True),
                               ids=("committed", "with_ready_cells"))


def test_top_level_keys_and_limits():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["command"][:2] == ["python3", "portbench/run.py"]
    assert s["paths"] == ["portbench"]
    assert 1 <= s["run_seconds"] <= 51
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@BOTH
def test_entries_have_the_contract_keys(ready):
    s = spec(ready)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (REPO / c["file"]).is_file()
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        # a ready cell's bound is set by the PR that adds the cell
        assert m["bound"] is None or 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES


@BOTH
def test_names_units_and_uniqueness(ready):
    s = spec(ready)
    texts = ([c["why"] for c in s["configs"] + s["workloads"]]
             + [c["source"] for c in s["configs"]]
             + [m["layer"] for m in s["per_layer"]] + s["command"])
    assert all(0 < len(x) <= 200 and "\n" not in x and "\t" not in x
               for x in texts)
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in s[kind]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    pairs = [(w["config"], w["traffic"]) for w in s["workloads"]]
    assert len(pairs) == len(set(pairs))


@BOTH
def test_every_cell_reports_what_the_contract_asks(ready):
    s = spec(ready)
    e2e = {m["name"]: m for m in s["end_to_end"]}
    for w in s["workloads"]:
        names = [m["name"] for m in harness.cell_metrics(s, w["name"], False)]
        assert "setup_s" in names and len(names) >= 2
        layers = harness.cell_metrics(s, w["name"], True)
        assert layers
        for m in layers:
            moved = e2e[m["moves"]]
            assert w["name"] in moved.get("workloads", [w["name"]])


@BOTH
def test_cells_found_by_name_from_files(ready):
    s = spec(ready)
    for w in s["workloads"]:
        wl, cfg, traffic, limits = harness.cell_files(s, w["name"], REPO)
        assert cfg["name"] == w["config"] and "model" in cfg
        assert (REPO / "portbench/drivers" / f"{cfg['model']}.py").is_file()
        assert traffic["loop"] in ("train", "score")
        assert limits and all(v > 0 for v in limits.values())
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(harness.reader(m["name"]).read)


def test_a_new_metric_on_an_existing_reader_needs_no_edit():
    # a later cell's device_idle.<suffix> finds metrics/device_idle.py
    assert harness.reader("device_idle.some_new_cell").__file__.endswith(
        "device_idle.py")


def test_configurations_state_f32_without_tf32():
    for c in spec(ready=True)["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["dtype"] == "float32" and cfg["tf32"] is False
