"""The plain reference against the port on the host at a tiny size, and
the control (the reference in TF32 put in the program's place) failing
the limits that ``checks/`` commits."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import harness, reference
from portbench.tests.portbench_fixtures import (  # noqa: F401
    REPO, run_cell, with_ready_cells, tiny_root)
from portbench.tracing import Spans

CELLS = ("tfinance.train", "tam-photo.train", "tfinance.score")


@pytest.mark.parametrize("workload", CELLS)
def test_reference_equals_the_port_on_the_host(tiny_root, workload):
    result, lines = run_cell(tiny_root, workload)
    assert result["correct"], lines
    for c in result["checks"].values():
        assert c["value"] < 1e-4


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_the_committed_limits(tiny_root, workload):
    import importlib

    spec = harness.load_spec(tiny_root)
    wl, cfg, traffic, limits = harness.cell_files(spec, workload, tiny_root)
    reference.set_f32()
    drv = importlib.import_module(f"portbench.drivers.{cfg['model']}")
    cell = drv.Cell(cfg, traffic, "cpu", Spans())
    ref = cell.reference()
    for seed in (5, 6, 7):
        cell.start(seed)
        base = cell.readings(ref)
        ctrl = cell.readings(ref, "tf32")
        got = cell.gaps([ctrl] if traffic["loop"] == "score" else ctrl, base)
        assert any(got[k] > lim for k, lim in limits.items()), got


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12), 3.0e-3])
    r = reference.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2 ** -10
    assert r[2] == 1.0                       # a tie goes to the even 1.0
    assert r[3] == 1.0 + 2 ** -9             # a tie goes to the even side
    assert r[4] == -1.0
    assert abs(float(r[5]) - 3.0e-3) <= 3.0e-3 * 2 ** -11


def test_the_limits_files_name_the_drivers_numbers():
    for wl in with_ready_cells(harness.load_spec(REPO))["workloads"]:
        limits = json.loads((REPO / "portbench/checks" / f"{wl['name']}.json")
                            .read_text())
        loop = json.loads((REPO / "portbench/traffic" / f"{wl['traffic']}"
                           ".json").read_text())["loop"]
        want = ({"score_gap"} if loop == "score"
                else {"loss_gap", "grad_gap", "change_gap"})
        assert set(limits) == want
