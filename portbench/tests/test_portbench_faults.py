"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have. (There is no exchange between chips
to leave out: every cell takes one card.)"""

from __future__ import annotations

import pytest
import torch

from portbench.tests.portbench_fixtures import (  # noqa: F401
    run_cell, tiny_root)


def _no_step(self, *args, **kwargs):
    return None


@pytest.mark.parametrize("workload", ("tfinance.train", "tam-photo.train"))
def test_a_step_that_leaves_the_state_unchanged(tiny_root, monkeypatch,
                                                 workload):
    monkeypatch.setattr(torch.optim.Adam, "step", _no_step)
    result, lines = run_cell(tiny_root, workload)
    assert not result["correct"], lines


def test_ggad_half_of_the_batch_left_out(tiny_root, monkeypatch):
    from ggad_tpu_torch.train import losses

    bce = losses.bce_with_logits
    monkeypatch.setattr(losses, "bce_with_logits",
                        lambda x, y, w=1.0: bce(x[::2], y[::2], w))
    result, lines = run_cell(tiny_root, "tfinance.train")
    assert not result["correct"], lines


def test_tam_half_of_the_batch_left_out(tiny_root, monkeypatch):
    from ggad_tpu_torch.models import tam

    init = tam.TAMEnsemble.__init__

    def half(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.normal_idx = self.normal_idx[::2]

    monkeypatch.setattr(tam.TAMEnsemble, "__init__", half)
    result, lines = run_cell(tiny_root, "tam-photo.train")
    assert not result["correct"], lines


def test_a_score_altered_where_it_is_produced(tiny_root, monkeypatch):
    from ggad_tpu_torch.train.full_batch import FullBatchTrainer

    logits = FullBatchTrainer.logits

    def altered(self, params=None):
        out = logits(self, params).clone()
        out[7] += 0.01 * out.abs().max()
        return out

    monkeypatch.setattr(FullBatchTrainer, "logits", altered)
    result, lines = run_cell(tiny_root, "tfinance.score")
    assert not result["correct"], lines
