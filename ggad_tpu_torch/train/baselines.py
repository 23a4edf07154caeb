"""Baseline runners (counterpart of ``ggad_tpu/train/baselines.py``).

Only the ``ggad-minibatch`` branch of ``run_minibatch_model``
(``baselines.py:581-605``) is ported so far; the baseline zoo joins it
later.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from ggad_tpu_torch.datasets.core import GADDataset
from ggad_tpu_torch.datasets.splits import minibatch_split_for
from ggad_tpu_torch.train.minibatch import MiniBatchTrainer


def minibatch_trainer(ds: GADDataset, *, split_seed: int,
                      test_ratio: float = 0.6, **kw) -> MiniBatchTrainer:
    """A :class:`MiniBatchTrainer` on ``ds`` with self-loops added and the
    dataset's split preset (reference ``src/model_handler.py:31-214``)
    drawn with ``split_seed``; ``kw`` sets the trainer's fields."""
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    idx_train, idx_valid, idx_test, labels, idx_anom = minibatch_split_for(
        ds.name, ds.ano_labels, seed=split_seed, test_ratio=test_ratio)
    return MiniBatchTrainer(
        adj=adj, features=ds.features, labels=labels, idx_train=idx_train,
        idx_anomaly=idx_anom, idx_valid=idx_valid, idx_test=idx_test, **kw)


def run_minibatch_model(name: str, ds: GADDataset, args) -> dict:
    """Train a minibatch model on ``ds`` with the CLI's ``args`` (seed,
    num_epoch, checkpoint_dir, device) and return the CLI's record. As in
    JAX, ``--seed`` draws the split; the trainer keeps its seed 0."""
    if name != "ggad-minibatch":
        raise ValueError(f"minibatch model {name!r} is not ported")
    tr = minibatch_trainer(ds, split_seed=args.seed,
                           num_epochs=args.num_epoch or 30,
                           checkpoint_dir=args.checkpoint_dir,
                           device=args.device)
    res = tr.train(verbose=True)
    out = {"model": name, "dataset": ds.name,
           "best_val_auc": res.best_val_auc,
           "best_epoch": res.best_epoch,
           "wall_time_s": res.wall_time_s}
    out.update({f"test_{k}": v for k, v in res.test_metrics.items()})
    return out
