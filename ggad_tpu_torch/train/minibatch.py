"""Minibatch GGAD trainer, the DGraph-scale path (counterpart of
``ggad_tpu/train/minibatch.py:43-314``).

It re-designs the reference's ``src/model_handler.py``:
  * each batch is ``batch_size`` train slots followed by
    ``n_anom_per_batch`` outlier-seed slots (reference ``:330-348``);
  * ``num_batches`` batches an epoch (the reference hardcodes 150);
  * validation every ``valid_epochs`` epochs and at the last, keeping the
    best-AUROC parameters (reference ``:379-399``);
  * the test metrics (F1 macro/pos/neg, AUROC, AP, G-mean) are taken on
    the best parameters (reference ``src/utils.py:207-247``).

The host draws each epoch's batch ids with numpy, as JAX does; everything
else (sampling, aggregation, loss, AdamW) runs on the trainer's device.
An epoch's steps run with no host sync between them: its draws are made
at once, and the last step's losses are read once at its end, as JAX
returns ``losses[-1]`` of its ``lax.scan``.

The sampler's uniform draws come from the trainer's own generator (seeded
with ``seed``; scoring from a fresh one seeded 1234, JAX's
``PRNGKey(1234)`` default), or from ``draws``, a callable that returns the
next draw for a shape, so that a test can feed JAX's draws. Every draw is
asked for in one of three shapes: an epoch's first hop
``(num_batches, B, K1)``, its second hop ``(num_batches, B·K1, K2)``, and
a scoring call's ``(n_chunks, eval_batch, K1)``.

With ``mesh`` (a shard count D or a 1-D ``parallel.mesh`` communicator)
the batch axis is data parallel (``parallel.minibatch_dp``, JAX's
``minibatch.py:99-123``): D must divide ``batch_size + n_anom_per_batch``
and ``eval_batch``; the feature table, the neighbor table and the
parameters are replicated (held once on a local mesh); each step's
``[B]`` ids and its draws are sliced by shard, so D shards see the
single-device draws; ``score_nodes`` shards each ``eval_batch`` chunk and
all-gathers the scores. Under the ``"dist"`` communicator rank 0 alone
writes the best-validation checkpoint, and every rank waits for it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ggad_tpu_torch.device import DeviceLike, resolve_device
from ggad_tpu_torch.interop import as_state_dict
from ggad_tpu_torch.models.sage import (
    MiniBatchGGAD,
    MiniBatchGGADLosses,
    minibatch_ggad_losses,
)
from ggad_tpu_torch.ops.metrics import (
    average_precision,
    confusion,
    f1_scores,
    gmean_from_confusion,
    prob_to_pred,
    roc_auc,
)
from ggad_tpu_torch.ops.normalize import row_normalize_smoothed
from ggad_tpu_torch.parallel.mesh import make_mesh
from ggad_tpu_torch.parallel.minibatch_dp import (
    check_divides,
    dp_minibatch_losses,
)
from ggad_tpu_torch.sampler.neighbor import NeighborTable
from ggad_tpu_torch.train.checkpoint import Checkpointer

# rows scored in one pass: a [2^16, K1, F] gather, not one over the split
EVAL_ROWS_PER_PASS = 1 << 16

Draws = Callable[[tuple], Any]


@dataclasses.dataclass
class MiniBatchResult:
    params: dict
    best_params: dict
    best_val_auc: float
    best_epoch: int
    test_metrics: dict
    history: list
    wall_time_s: float
    train_time_s: float = 0.0   # the epochs' steps only (no validation,
                                # host batch draws or checkpoints)


@dataclasses.dataclass
class MiniBatchTrainer:
    """GGAD minibatch trainer over a sampled-neighborhood encoder."""

    adj: Any                      # scipy sparse adjacency WITH self-loops
    features: np.ndarray          # [N, F]
    labels: np.ndarray            # [N] mutated labels (seeds = 1)
    idx_train: np.ndarray         # train-slot candidate ids
    idx_anomaly: np.ndarray       # outlier-seed ids (label 1)
    idx_valid: np.ndarray
    idx_test: np.ndarray

    emb_dim: int = 64
    fanout1: int = 16
    fanout2: int = 8
    lr: float = 1e-3
    weight_decay: float = 0.007   # reference src/dgraph.yml
    batch_size: int = 150
    n_anom_per_batch: int = 50
    num_batches: int = 150
    num_epochs: int = 100
    valid_epochs: int = 5
    thres: float = 0.4            # reference src/dgraph.yml
    seed: int = 0
    eval_batch: int = 1024
    logger: Optional[Callable[[dict], None]] = None
    checkpoint_dir: Optional[str] = None
    initial_params: Optional[Any] = None   # flax tree or state_dict
    draws: Optional[Draws] = None
    device: DeviceLike = None
    mesh: Optional[Any] = None    # shard count D or a 1-D parallel.mesh
                                  # communicator → data-parallel batches

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.mesh is not None:
            if isinstance(self.mesh, int):
                self.mesh = make_mesh(self.mesh, device=self.device)
            check_divides(self.mesh, self.batch_size + self.n_anom_per_batch,
                          self.eval_batch)
            self.device = self.mesh.device
        self.table = NeighborTable.from_scipy(self.adj, device=self.device)
        self.features = row_normalize_smoothed(self.features)
        self.feats = torch.as_tensor(
            np.asarray(self.features, np.float32)).to(self.device)
        self.model = MiniBatchGGAD(
            self.feats.shape[1], self.emb_dim, self.fanout1, self.fanout2,
            generator=torch.Generator().manual_seed(self.seed)
        ).to(self.device)
        if self.initial_params is not None:
            self.model.load_state_dict(
                as_state_dict(self.initial_params, self.device))
        self._start = self.params()
        # train-slot candidates by label, so shapes stay static (JAX's
        # documented deviation from the reference, SURVEY.md §7.1); seeds
        # may already sit in idx_train under some presets, so the seed
        # pool is deduplicated
        labels = np.asarray(self.labels)
        idx_train = np.asarray(self.idx_train)
        train_labels = labels[idx_train]
        self._train_pool = idx_train[train_labels == 0].astype(np.int32)
        self._anom_pool = np.unique(np.concatenate([
            np.asarray(self.idx_anomaly), idx_train[train_labels == 1]
        ]).astype(np.int32))
        # made at the first step: building a torch optimizer imports
        # torch._dynamo (seconds), which scoring never needs
        self.optimizer: Optional[torch.optim.Optimizer] = None

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Back to the starting weights (``initial_params``, else the
        port's init seeded with ``seed``) with no optimizer state."""
        self.model.load_state_dict(self._start)
        self.optimizer = None

    def params(self) -> dict[str, torch.Tensor]:
        """A copy of the model's current ``state_dict``."""
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    def make_optimizer(self) -> torch.optim.Optimizer:
        """AdamW with ``optax.adamw``'s update (b1 0.9, b2 0.999, eps
        1e-8, decoupled weight decay on every parameter)."""
        return torch.optim.AdamW(self.model.parameters(), lr=self.lr,
                                 weight_decay=self.weight_decay)

    def draw(self, shape: tuple, generator: torch.Generator
             ) -> torch.Tensor:
        """Uniform [0, 1) draws of ``shape`` on the device, from ``draws``
        when set, else from ``generator``."""
        if self.draws is not None:
            return torch.as_tensor(self.draws(shape),
                                   dtype=torch.float32).to(self.device)
        return torch.rand(shape, generator=generator, device=self.device)

    def draw_batches(self, host_rng: np.random.Generator) -> torch.Tensor:
        """An epoch's ``[num_batches, B]`` int32 batch ids on the device,
        drawn on the host with JAX's numpy calls (``minibatch.py:271-279``)."""
        train_ids = host_rng.choice(
            self._train_pool, size=(self.num_batches, self.batch_size),
            replace=True)
        anom_ids = host_rng.choice(
            self._anom_pool, size=(self.num_batches, self.n_anom_per_batch),
            replace=True)
        return torch.from_numpy(np.concatenate(
            [train_ids, anom_ids], axis=1).astype(np.int32)).to(self.device)

    # ------------------------------------------------------------------
    def compute_losses(self, batch: torch.Tensor, u1: torch.Tensor,
                       u2: torch.Tensor) -> MiniBatchGGADLosses:
        """Train-branch forward and loss at the model's current
        parameters, with autograd recording (over the mesh's shards when
        ``mesh`` is set)."""
        if self.mesh is not None:
            return dp_minibatch_losses(self.model, self.feats, self.table,
                                       batch, u1, u2, self.n_anom_per_batch,
                                       self.mesh)
        out = self.model(self.feats, self.table, batch,
                         self.n_anom_per_batch, True, u1=u1, u2=u2)
        return minibatch_ggad_losses(out, self.n_anom_per_batch)

    def train_step(self, batch: torch.Tensor, u1: torch.Tensor,
                   u2: torch.Tensor) -> MiniBatchGGADLosses:
        """One step: forward, loss, backward, AdamW. Returns the losses,
        detached (on the device, not read)."""
        if self.optimizer is None:
            self.optimizer = self.make_optimizer()
        self.optimizer.zero_grad(set_to_none=True)
        losses = self.compute_losses(batch, u1, u2)
        losses.total.backward()
        self.optimizer.step()
        return MiniBatchGGADLosses(*(t.detach() for t in losses))

    def train_epoch(self, batches: torch.Tensor,
                    generator: torch.Generator) -> MiniBatchGGADLosses:
        """Every batch of ``batches`` ([num_batches, B]) in turn, the
        draws made at once; the last step's losses, not read."""
        nb, b = batches.shape
        u1 = self.draw((nb, b, self.fanout1), generator)
        u2 = self.draw((nb, b * self.fanout1, self.fanout2), generator)
        for i in range(nb):
            losses = self.train_step(batches[i], u1[i], u2[i])
        return losses

    # ------------------------------------------------------------------
    @torch.no_grad()
    def score_nodes(self, params: Optional[Mapping[str, torch.Tensor]],
                    node_ids: np.ndarray) -> np.ndarray:
        """Sigmoid scores of ``node_ids`` on the host, at ``params`` (or
        the model's own). The ids are padded with node 0 to whole
        ``eval_batch`` chunks, each with its own draw
        (``minibatch.py:217-233``); the rows are independent, so several
        chunks are scored in one pass."""
        node_ids = np.asarray(node_ids)
        n = node_ids.shape[0]
        bs = self.eval_batch
        n_chunks = (n + bs - 1) // bs
        padded = np.zeros(n_chunks * bs, np.int32)
        padded[:n] = node_ids
        ids = torch.from_numpy(padded).to(self.device)
        u = self.draw((n_chunks, bs, self.fanout1),
                      torch.Generator(self.device).manual_seed(1234))
        u = u.reshape(n_chunks * bs, self.fanout1)
        if params is None:
            params = dict(self.model.state_dict())
        probs = torch.empty(n_chunks * bs, device=self.device)
        step = max(EVAL_ROWS_PER_PASS // bs, 1)
        for c0 in range(0, n_chunks, step):
            c = min(step, n_chunks - c0)
            sl = slice(c0 * bs, (c0 + c) * bs)
            probs[sl] = self._score_rows(params, ids[sl].view(c, bs),
                                         u[sl].view(c, bs, -1))
        return probs[:n].cpu().numpy()

    def _score_rows(self, params, ids: torch.Tensor,
                    u: torch.Tensor) -> torch.Tensor:
        """Sigmoid scores of the ``[c, bs]`` ids with draws ``[c, bs, K1]``;
        with ``mesh``, each shard scores its slice of every chunk and one
        all-gather returns them in order."""
        mesh = self.mesh
        if mesh is not None:
            c, bs = ids.shape
            d = mesh.n_shards
            ids = ids.view(c, d, bs // d).transpose(0, 1)[mesh.shards]
            u = u.view(c, d, bs // d, -1).transpose(0, 1)[mesh.shards]
        out = torch.func.functional_call(
            self.model, params, (self.feats, self.table, ids.reshape(-1), 0,
                                 False), {"u1": u.reshape(-1, u.shape[-1])})
        probs = torch.sigmoid(out.scores)
        if mesh is None:
            return probs
        probs = mesh.all_gather(probs.view(ids.shape[0], -1))
        return probs.view(d, c, bs // d).transpose(0, 1).reshape(-1)

    def metrics_on(self, params: Optional[Mapping[str, torch.Tensor]],
                   node_ids, labels) -> dict:
        probs = self.score_nodes(params, np.asarray(node_ids))
        labels = np.asarray(labels)
        preds = prob_to_pred(probs, self.thres)
        f1_mac, f1_pos, f1_neg = f1_scores(labels, preds)
        return {
            "auc": roc_auc(labels, probs),
            "ap": average_precision(labels, probs),
            "f1_macro": f1_mac,
            "f1_pos": f1_pos,
            "f1_neg": f1_neg,
            "gmean": gmean_from_confusion(confusion(labels, preds)),
        }

    # ------------------------------------------------------------------
    def train(self, verbose: bool = False) -> MiniBatchResult:
        self.reset()
        generator = torch.Generator(self.device).manual_seed(self.seed)
        host_rng = np.random.default_rng(self.seed)
        ckpt = Checkpointer(self.checkpoint_dir) if self.checkpoint_dir \
            else None

        best_auc, best_epoch = -1.0, -1
        best_params = self.params()
        history = []
        t0 = time.time()
        t_train = 0.0
        labels = np.asarray(self.labels)
        for epoch in range(self.num_epochs):
            batches = self.draw_batches(host_rng)
            ts = time.time()
            losses = self.train_epoch(batches, generator)
            total, cls, constraint, rec_loss = torch.stack(
                list(losses)).tolist()
            t_train += time.time() - ts

            rec = {"epoch": epoch, "loss": total, "loss_cls": cls,
                   "loss_constraint": constraint, "loss_rec": rec_loss}
            if epoch % self.valid_epochs == 0 or epoch == self.num_epochs - 1:
                val = self.metrics_on(None, self.idx_valid,
                                      labels[self.idx_valid])
                rec.update({f"val_{k}": v for k, v in val.items()})
                if val["auc"] > best_auc:
                    best_auc, best_epoch = val["auc"], epoch
                    best_params = self.params()
                    # replicated: under the "dist" communicator rank 0
                    # alone writes and prunes the shared directory
                    if ckpt is not None and getattr(self.mesh, "rank",
                                                    0) == 0:
                        ckpt.save(epoch, {
                            "params": {k: v.cpu()
                                       for k, v in best_params.items()},
                            "metrics": {"val_auc": float(best_auc)}})
                    if ckpt is not None and self.mesh is not None:
                        self.mesh.barrier()
                if verbose:
                    print(f"epoch {epoch:4d}  val AUROC {val['auc']:.4f}  "
                          f"AP {val['ap']:.4f}  loss {rec['loss']:.4f}")
            history.append(rec)
            if self.logger is not None:
                self.logger(rec)

        test = self.metrics_on(best_params, self.idx_test,
                               labels[self.idx_test])
        return MiniBatchResult(
            params=self.params(), best_params=best_params,
            best_val_auc=best_auc, best_epoch=best_epoch, test_metrics=test,
            history=history, wall_time_s=time.time() - t0,
            train_time_s=t_train)
