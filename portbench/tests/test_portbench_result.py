"""The result line's keys, and the runs that must print no result."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.portbench_fixtures import (  # noqa: F401
    REPO, run_cell, tiny_root)

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("workload", ("tfinance.train", "tfinance.score",
                                      "tam-photo.train"))
def test_the_last_line_has_the_contract_keys(tiny_root, workload):
    result, lines = run_cell(tiny_root, workload)
    assert list(result) == KEYS                  # the checks come last
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    spec = harness.load_spec(tiny_root)
    want = {m["name"] for m in harness.cell_metrics(spec, workload, False)}
    assert set(result["metrics"]) == want
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for k, c in result["checks"].items():
        assert set(c) == {"value", "limit"}
        assert any(line.startswith(f"check {k}:") for line in lines)
    assert result["attempted"] > 0 and result["failed"] == 0
    json.dumps(result)


def test_main_prints_the_result_as_its_last_line(tiny_root, monkeypatch,
                                                 capsys):
    run = harness.run
    monkeypatch.setattr(harness, "run", lambda argv, t_start=None: run(
        argv, root=tiny_root, device="cpu", t_start=t_start))
    rc = harness.main(["--workload", "tfinance.score", "--seed",
                       "3000000002", "--seconds", "0.3"])
    out = capsys.readouterr()
    assert rc == 0
    last = json.loads(out.out.strip().splitlines()[-1])
    assert list(last) == KEYS
    err = out.err.strip().splitlines()
    assert err[-1].startswith("check score_gap:") and err[-1].endswith("ok")


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    rc = harness.main(["--workload", "tfinance.train", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    """A checkout holding only BENCHMARK.json and portbench/ has no
    program to measure: the run fails and prints nothing."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    code = ("import sys; sys.path.insert(0, '.');"
            "from portbench import harness;"
            "harness.run(['--workload', 'tfinance.train', '--seed', '1',"
            " '--seconds', '1'], device='cpu')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "ggad_tpu_torch" in proc.stderr
