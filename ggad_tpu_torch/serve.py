"""Serving: restore a GGAD checkpoint and score every node (counterpart of
``ggad_tpu/serve.py``).

    scores = score_dataset("ckpts/photo", dataset)           # one request
    scorer = Scorer("ckpts/photo", dataset); scorer.score()  # many requests
    python -m ggad_tpu_torch.cli --dataset photo --score_only \
        --checkpoint_dir ckpts/photo --score_out scores.npz   # CLI

A :class:`Scorer` prepares the graph, its forward BCSR tiles or ELL table,
the hoisted Â·x and the weights once; each ``score()`` is one eval forward
(one BCSR kernel launch on a tile-dense graph, the ELL table's gathers on a
tile-sparse one) plus host-side metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ggad_tpu_torch.device import DeviceLike
from ggad_tpu_torch.ops.metrics import average_precision, roc_auc
from ggad_tpu_torch.train.checkpoint import Checkpointer
from ggad_tpu_torch.train.full_batch import FullBatchTrainer


@dataclasses.dataclass
class ScoreResult:
    scores: np.ndarray     # [N] anomaly scores (one-class logits)
    auc: float
    ap: float
    step: Optional[int]    # checkpoint step restored (None = fresh init)


class Scorer:
    """Holds a prepared graph and weights and answers scoring requests.

    The checkpoint is one written by :class:`Checkpointer` with
    ``{"params": state_dict, ...}`` at the same ``embedding_dim``; with no
    checkpoint in ``checkpoint_dir`` the seeded init (seed 0) is scored,
    as ``ggad_tpu.serve.score_dataset`` does.
    """

    def __init__(self, checkpoint_dir: str, dataset, *,
                 embedding_dim: int = 300, spmm_impl: str = "auto",
                 spmm_dtype: str = "float32", device: DeviceLike = None):
        self.dataset = dataset
        self.trainer = FullBatchTrainer(
            dataset, embedding_dim=embedding_dim, spmm_impl=spmm_impl,
            spmm_dtype=spmm_dtype, device=device)
        self.params = self.trainer.init()
        ckpt = Checkpointer(checkpoint_dir)
        self.step = ckpt.latest_step()
        if self.step is not None:
            restored = ckpt.restore(self.step)
            self.params = {k: v.to(self.trainer.device)
                           for k, v in restored["params"].items()}

    @property
    def device(self):
        return self.trainer.device

    def score(self, subset: str = "test") -> ScoreResult:
        scores = self.trainer.eval_scores(self.params)
        ds = self.dataset
        idx = {"test": ds.idx_test, "val": ds.idx_val,
               "train": ds.idx_train,
               "all": np.arange(ds.n_nodes)}[subset]
        return ScoreResult(
            scores=scores,
            auc=roc_auc(ds.ano_labels[idx], scores[idx]),
            ap=average_precision(ds.ano_labels[idx], scores[idx]),
            step=self.step,
        )


def score_dataset(checkpoint_dir: str, dataset, *,
                  embedding_dim: int = 300,
                  spmm_impl: str = "auto",
                  spmm_dtype: str = "float32",
                  subset: str = "test",
                  device: DeviceLike = None) -> ScoreResult:
    """Restore the latest checkpoint and score every node of ``dataset``
    (one request; build a :class:`Scorer` to answer many)."""
    return Scorer(checkpoint_dir, dataset, embedding_dim=embedding_dim,
                  spmm_impl=spmm_impl, spmm_dtype=spmm_dtype,
                  device=device).score(subset)
