"""On the card (skips on a host without one): the cells at the host's
tiny size, untraced and traced, correct, with the device's numbers."""

from __future__ import annotations

import pytest

from portbench import harness
from portbench.tests.portbench_fixtures import tiny_root  # noqa: F401

CELLS = ("tfinance.train", "tam-photo.train", "tfinance.score")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", (0, 1))
def test_tiny_cells_on_the_card(tiny_root, workload, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, lines = harness.run(
        ["--workload", workload, "--seed", "4000000003", "--seconds", "1",
         "--trace", str(trace)], root=tiny_root, device="cuda:0")
    assert result["correct"], lines
    assert result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
