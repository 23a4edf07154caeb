"""Fixtures and helpers of the benchmark's own tests (``pytest
portbench/``), imported by the test modules that use them: a checkout
root whose ``BENCHMARK.json`` holds the real cells and those kept ready
in ``ready/``, their configurations cut to a size the host runs in
seconds, and the graph cache in a temporary directory."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench import graphgen, harness

REPO = harness.PB.parent


def tiny_configs() -> dict:
    """The real configurations at a host-sized shape: the same models,
    routes forced where the tiny graph would take another."""
    g = json.loads((REPO / "portbench/configs/ggad-tfinance.json")
                   .read_text())
    g["graph"].update(n_nodes=600, n_entries=20000)
    g.update(embedding_dim=32, spmm_impl="ell")
    t = json.loads((REPO / "portbench/configs/tam-photo.json").read_text())
    t["graph"].update(n_nodes=500, n_entries=8000, feat_dim=40)
    t.update(embedding_dim=16)
    return {"ggad-tfinance": g, "tam-photo": t}


def with_ready_cells(spec: dict) -> dict:
    """``spec`` with the entries of every cell kept in ``ready/``."""
    for path in sorted((REPO / "portbench/ready").glob("*.json")):
        ready = json.loads(path.read_text())
        for kind in ("configs", "workloads", "end_to_end", "per_layer"):
            spec[kind] += ready[kind]
    return spec


@pytest.fixture
def tiny_root(tmp_path, monkeypatch) -> Path:
    monkeypatch.setattr(graphgen, "CACHE_DIR", tmp_path / "cache")
    spec = with_ready_cells(harness.load_spec(REPO))
    for entry in spec["configs"]:
        path = tmp_path / f"{entry['name']}.json"
        path.write_text(json.dumps(tiny_configs()[entry["name"]]))
        entry["file"] = str(path)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path


def run_cell(root: Path, workload: str, *, seed: int = 3_000_000_001,
             seconds: float = 0.5, trace: int = 0):
    return harness.run(["--workload", workload, "--seed", str(seed),
                        "--seconds", str(seconds), "--trace", str(trace)],
                       root=root, device="cpu")
