"""Baseline runners (counterpart of ``ggad_tpu/train/baselines.py``).

The full-batch baseline zoo (DOMINANT, AnomalyDAE, OCGNN, AEGIS, GAAN;
``baselines.py:27-487,550-579``): one run class per objective family,
each preparing the graph once (:func:`_prep`), holding the model at its
initial weights and its optimizers, and running one epoch per ``step()``;
``_loop`` runs the epochs with the reference's evaluation cadence. The
minibatch GGAD branch of ``run_minibatch_model`` (``baselines.py:581-605``)
is here too.

TAM (``run_tam_baseline``, ``baselines.py:488-545``) trains its
truncated-affinity ensemble through ``models.tam.run_tam``, which picks
its own route (the block-diagonal tile pair on K1, or the shared ELL
tables) and reports one AUROC/AP a round.

The zoo's graph takes the GGAD trainer's route (``full_batch.maybe_bcsr``,
decided by the graph alone): on a tile-dense graph OCGNN's and AEGIS's
GCN layers run K1 forward and, on the transposed tiles, backward, which
only they build. DOMINANT, AnomalyDAE and GAAN read the edge list alone
and launch no kernel. Noise is drawn from a ``torch.Generator`` seeded
with ``seed`` on the device, or replayed from ``noise_seq`` (one
``[N, noise_dim]`` draw per forward, JAX's own in the tests). The loss is
read on the host only at an evaluation (and each AEGIS pretrain epoch),
as JAX's ``_loop`` reads it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ggad_tpu_torch.datasets.core import GADDataset
from ggad_tpu_torch.datasets.splits import minibatch_split_for, tam_split
from ggad_tpu_torch.device import DeviceLike, resolve_device
from ggad_tpu_torch.graph import add_self_loops, from_scipy
from ggad_tpu_torch.interop import as_state_dict
from ggad_tpu_torch.models.aegis import AEGIS, aegis_losses, aegis_scores
from ggad_tpu_torch.models.anomaly_dae import AnomalyDAE, anomaly_dae_loss
from ggad_tpu_torch.models.dominant import Dominant, dominant_loss
from ggad_tpu_torch.models.gaan import GAAN, gaan_losses, gaan_scores
from ggad_tpu_torch.models.ocgnn import (
    OCGNNEncoder,
    init_ocgnn_state,
    ocgnn_loss,
    ocgnn_scores,
)
from ggad_tpu_torch.models.tam import run_tam
from ggad_tpu_torch.ops.metrics import average_precision, roc_auc
from ggad_tpu_torch.ops.normalize import normalize_adj_reference
from ggad_tpu_torch.train.full_batch import maybe_bcsr
from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

# the reconstruction family: model and training loss by name
RECONSTRUCTION = {"dominant": (Dominant, dominant_loss),
                  "anomalydae": (AnomalyDAE, anomaly_dae_loss)}
BASELINES = (*RECONSTRUCTION, "ocgnn", "aegis", "gaan", "tam")


@dataclasses.dataclass
class BaselineResult:
    auc: float
    ap: float
    history: list
    wall_time_s: float

    def as_dict(self, name: str, dataset: str) -> dict:
        return {"model": name, "dataset": dataset, "auc": self.auc,
                "ap": self.ap, "wall_time_s": self.wall_time_s}


def _prep(ds: GADDataset, spmm_impl: str = "auto", *,
          transpose: bool = False, device: DeviceLike = None):
    """(adj, x, train_idx) on ``device``: the normalised +I graph on its
    route (with the transposed tiles or table only if ``transpose``), the
    features and the labeled normals. A + I, which JAX's ``_prep`` also
    returns for DOMINANT's structure branch, is not kept: at the runners'
    structure weight 1.0 nothing reads it."""
    device = resolve_device(device)
    adj, _ = normalize_adj_reference(from_scipy(ds.adj, device=device))
    adj = maybe_bcsr(adj, spmm_impl, transpose=transpose)
    x = torch.as_tensor(ds.features, dtype=torch.float32, device=device)
    train_idx = torch.as_tensor(ds.normal_label_idx, dtype=torch.int64,
                                device=device)
    return adj, x, train_idx


def _eval_auc_ap(ds: GADDataset, scores: np.ndarray):
    idx = ds.idx_test
    return (roc_auc(ds.ano_labels[idx], scores[idx]),
            average_precision(ds.ano_labels[idx], scores[idx]))


def _loop(num_epoch: int, eval_every: int, run, ds: GADDataset,
          verbose: bool, logger=None) -> BaselineResult:
    """``num_epoch`` calls of ``run.step()``; at epoch 0, every
    ``eval_every`` and the last, the loss and ``run.scores()`` are read
    and AUROC/AP taken on the test split (``baselines.py:59-77``)."""
    history = []
    t0 = time.time()
    auc = ap = float("nan")
    for epoch in range(num_epoch):
        loss = run.step()
        if epoch % eval_every == 0 or epoch == num_epoch - 1:
            auc, ap = _eval_auc_ap(ds, run.scores().cpu().numpy())
            rec = {"epoch": epoch, "loss": float(loss), "auc": auc,
                   "ap": ap}
            history.append(rec)
            if logger:
                logger(rec)
            if verbose:
                print(f"epoch {epoch:4d}  loss {rec['loss']:.4f}  "
                      f"AUROC {auc:.4f}  AP {ap:.4f}")
    return BaselineResult(auc=auc, ap=ap, history=history,
                          wall_time_s=time.time() - t0)


class BaselineRun:
    """A full-batch baseline ready to train: the graph from :func:`_prep`,
    the model at its initial weights (the port's init seeded with
    ``seed``, or ``initial_params``: a flax tree or a ``state_dict``).
    Subclasses build the model and the optimizers and define ``step()``
    (one epoch; the loss, detached, on the device) and ``scores()``
    (``[N]``, what an evaluation reads)."""

    transpose = False      # a GCN reads adj with a gradient

    def __init__(self, ds: GADDataset, *, seed: int = 0,
                 initial_params=None, spmm_impl: str = "auto",
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.dataset = ds
        self.adj, self.x, self.train_idx = _prep(
            ds, spmm_impl, transpose=self.transpose, device=self.device)
        self.model = self.make_model(
            torch.Generator().manual_seed(seed)).to(self.device)
        if initial_params is not None:
            self.model.load_state_dict(
                as_state_dict(initial_params, self.device))

    def make_model(self, generator: torch.Generator) -> torch.nn.Module:
        raise NotImplementedError

    def noise_source(self, noise_seq: Optional[Sequence], seed: int,
                     noise_dim: int) -> Callable[[], torch.Tensor]:
        """The next ``[N, noise_dim]`` draw: from ``noise_seq`` in order,
        else ``N(0, 1)`` from a generator seeded with ``seed`` on the
        device."""
        # the closures hold the device, not the run: a run that held
        # itself in a cycle would keep its device memory until the next
        # garbage collection
        device = self.device
        if noise_seq is not None:
            draws = iter(noise_seq)
            return lambda: torch.as_tensor(
                np.asarray(next(draws), np.float32)).to(device)
        gen = torch.Generator(device).manual_seed(seed)
        shape = (self.dataset.n_nodes, noise_dim)
        return lambda: torch.randn(shape, generator=gen, device=device)


# ---------------------------------------------------------------------------
# Reconstruction family: DOMINANT / AnomalyDAE
# ---------------------------------------------------------------------------

class ReconstructionRun(BaselineRun):
    """DOMINANT or AnomalyDAE: one Adam step on the mean score over the
    labeled normals; an evaluation reads the step's own scores, from the
    weights before the update (reference ``dominant.py:138-153``).
    DOMINANT runs at ``structure_weight`` 1.0, the reference's, where its
    structure branch (and so its ``gcn_norm_graph``) is never read."""

    def __init__(self, model_name: str, ds: GADDataset, *,
                 lr: float = 1e-3, embedding_dim: int = 300, **kw):
        if model_name not in RECONSTRUCTION:
            raise ValueError(f"not a reconstruction baseline: "
                             f"{model_name!r}")
        self.model_cls, self.loss_of = RECONSTRUCTION[model_name]
        self.embedding_dim = embedding_dim
        super().__init__(ds, **kw)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr)
        self._scores = None

    def make_model(self, generator):
        return self.model_cls(self.dataset.feat_dim, self.embedding_dim,
                              generator=generator)

    def step(self) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        out = self.model(self.adj, self.x)
        loss = self.loss_of(out, self.train_idx)
        loss.backward()
        self.optimizer.step()
        self._scores = out.scores.detach()
        return loss.detach()

    def scores(self) -> torch.Tensor:
        return self._scores


def run_reconstruction(model_name: str, ds: GADDataset, *,
                       num_epoch: int = 100, lr: float = 1e-3,
                       embedding_dim: int = 300, eval_every: int = 5,
                       seed: int = 0, verbose: bool = False, logger=None,
                       initial_params=None, spmm_impl: str = "auto",
                       device: DeviceLike = None) -> BaselineResult:
    run = ReconstructionRun(model_name, ds, lr=lr,
                            embedding_dim=embedding_dim, seed=seed,
                            initial_params=initial_params,
                            spmm_impl=spmm_impl, device=device)
    return _loop(num_epoch, eval_every, run, ds, verbose, logger)


# ---------------------------------------------------------------------------
# OCGNN
# ---------------------------------------------------------------------------

class OCGNNRun(BaselineRun):
    """OCGNN: one Adam step on the hypersphere loss of the labeled
    normals. Unlike DOMINANT, the reference evaluates with a fresh forward
    after the update (``ocgnn.py:196-203``), so ``scores()`` runs one."""

    transpose = True

    def __init__(self, ds: GADDataset, *, lr: float = 1e-3,
                 embedding_dim: int = 300, beta: float = 0.5,
                 use_warmup: bool = False, **kw):
        self.embedding_dim = embedding_dim
        self.beta = beta
        self.use_warmup = use_warmup
        super().__init__(ds, **kw)
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=lr)
        self.state = init_ocgnn_state(embedding_dim, device=self.device)

    def make_model(self, generator):
        return OCGNNEncoder(self.dataset.feat_dim, self.embedding_dim,
                            generator=generator)

    def step(self) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        emb = self.model(self.adj, self.x)
        loss, _, self.state = ocgnn_loss(emb[self.train_idx], self.state,
                                         beta=self.beta,
                                         use_warmup=self.use_warmup)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def scores(self) -> torch.Tensor:
        return ocgnn_scores(self.model(self.adj, self.x), self.state)


def run_ocgnn(ds: GADDataset, *, num_epoch: int = 100, lr: float = 1e-3,
              embedding_dim: int = 300, eval_every: int = 5, seed: int = 0,
              beta: float = 0.5, use_warmup: bool = False,
              verbose: bool = False, logger=None, initial_params=None,
              spmm_impl: str = "auto",
              device: DeviceLike = None) -> BaselineResult:
    run = OCGNNRun(ds, lr=lr, embedding_dim=embedding_dim, beta=beta,
                   use_warmup=use_warmup, seed=seed,
                   initial_params=initial_params, spmm_impl=spmm_impl,
                   device=device)
    return _loop(num_epoch, eval_every, run, ds, verbose, logger)


# ---------------------------------------------------------------------------
# Adversarial family: AEGIS / GAAN
# ---------------------------------------------------------------------------

class AEGISRun(BaselineRun):
    """AEGIS: ``pretrain_step()`` is an AE epoch (Adam at lr 1e-3, its own
    moments), ``step()`` an adversarial one (a fresh Adam at ``lr``).

    ``faithful=False``: the intended objective, one Adam step on loss_ae
    (labeled normals) + loss_dis + loss_g. ``faithful=True``: the
    reference's effective behaviour, bugs included (``aegis.py:118-140``,
    ``model_AEGIS.py:240``): pretraining never zeroes the gradients, so
    they accumulate over the pretrain epochs; an adversarial epoch zeroes
    them, backpropagates loss_ae over all nodes + loss_g, and steps a
    full-parameter Adam and then a generator-only Adam (its own moments)
    on the same gradients. Scores come from the step's own forward."""

    transpose = True

    def __init__(self, ds: GADDataset, *, lr: float = 1e-3,
                 embedding_dim: int = 300, faithful: bool = False,
                 noise_seq: Optional[Sequence] = None, seed: int = 0,
                 **kw):
        self.embedding_dim = embedding_dim
        self.faithful = faithful
        super().__init__(ds, seed=seed, **kw)
        self.all_idx = torch.arange(ds.n_nodes, device=self.device)
        self.next_noise = self.noise_source(noise_seq, seed,
                                            self.model.noise_dim)
        params = list(self.model.parameters())
        self.opt_ae = torch.optim.Adam(params, lr=1e-3)   # aegis.py:96
        self.opt = torch.optim.Adam(params, lr=lr)
        self.opt_g = torch.optim.Adam(self.model.generator.parameters(),
                                      lr=lr)
        self._scores = None

    def make_model(self, generator):
        return AEGIS(self.dataset.feat_dim, self.embedding_dim,
                     generator=generator)

    def pretrain_step(self) -> torch.Tensor:
        if not self.faithful:
            self.opt.zero_grad(set_to_none=True)
        out = self.model(self.adj, self.x, self.next_noise())
        loss_ae = aegis_losses(out, self.x, self.train_idx)[0]
        loss_ae.backward()
        self.opt_ae.step()
        return loss_ae.detach()

    def step(self) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        out = self.model(self.adj, self.x, self.next_noise())
        if self.faithful:
            loss_ae, _, loss_g = aegis_losses(out, self.x, self.all_idx)
            (loss_ae + loss_g).backward()
            self.opt.step()
            self.opt_g.step()
        else:
            loss_ae, loss_dis, loss_g = aegis_losses(out, self.x,
                                                     self.train_idx)
            (loss_ae + loss_dis + loss_g).backward()
            self.opt.step()
        self._scores = aegis_scores(out).detach()
        return loss_ae.detach()

    def scores(self) -> torch.Tensor:
        return self._scores


def run_aegis(ds: GADDataset, *, num_epoch: int = 100,
              recon_num_epoch: int = 10, lr: float = 1e-3,
              embedding_dim: int = 300, eval_every: int = 5, seed: int = 0,
              faithful: bool = False, verbose: bool = False, logger=None,
              initial_params=None, noise_seq: Optional[Sequence] = None,
              spmm_impl: str = "auto",
              device: DeviceLike = None) -> BaselineResult:
    """``recon_num_epoch`` AE epochs, then ``num_epoch`` adversarial ones
    (:class:`AEGISRun`). ``noise_seq``: one draw per epoch, the pretrain
    epochs' first. The history starts with the pretrain losses (read each
    pretrain epoch, as JAX reads them)."""
    run = AEGISRun(ds, lr=lr, embedding_dim=embedding_dim,
                   faithful=faithful, noise_seq=noise_seq, seed=seed,
                   initial_params=initial_params, spmm_impl=spmm_impl,
                   device=device)
    pretrain = [float(run.pretrain_step()) for _ in range(recon_num_epoch)]
    res = _loop(num_epoch, eval_every, run, ds, verbose, logger)
    res.history = ([{"pretrain_epoch": i, "loss": v}
                    for i, v in enumerate(pretrain)] + res.history)
    return res


class GAANRun(BaselineRun):
    """GAAN on all nodes (reference ``gaan.py:131``). ``faithful=False``:
    one Adam step on loss_dis + loss_g, whose gradients reach disjoint
    parameters (the fake edges are detached), which is the reference's
    ``optimiser.step()``. ``faithful=True`` adds the reference's second,
    generator-only Adam (its own moments) on the same gradients
    (``gaan.py:100-102,132-135``). Scores come from the step's own
    forward."""

    def __init__(self, ds: GADDataset, *, lr: float = 1e-3,
                 faithful: bool = False,
                 noise_seq: Optional[Sequence] = None, seed: int = 0,
                 **kw):
        self.faithful = faithful
        super().__init__(ds, seed=seed, **kw)
        self.all_idx = torch.arange(ds.n_nodes, device=self.device)
        self.train_mask = torch.ones(ds.n_nodes, dtype=torch.bool,
                                     device=self.device)
        self.next_noise = self.noise_source(noise_seq, seed,
                                            self.model.noise_dim)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=lr)
        self.opt_g = torch.optim.Adam(self.model.generator.parameters(),
                                      lr=lr)
        self._scores = None

    def make_model(self, generator):
        return GAAN(self.dataset.feat_dim, generator=generator)

    def step(self) -> torch.Tensor:
        self.opt.zero_grad(set_to_none=True)
        out = self.model(self.x, self.next_noise())
        loss_dis, loss_g = gaan_losses(out, self.adj, self.x,
                                       self.train_mask, self.all_idx)
        (loss_dis + loss_g).backward()
        self.opt.step()
        if self.faithful:
            self.opt_g.step()
        self._scores = gaan_scores(out, self.x).detach()
        return loss_dis.detach()

    def scores(self) -> torch.Tensor:
        return self._scores


def run_gaan(ds: GADDataset, *, num_epoch: int = 100, lr: float = 1e-3,
             eval_every: int = 5, seed: int = 0, faithful: bool = False,
             verbose: bool = False, logger=None, initial_params=None,
             noise_seq: Optional[Sequence] = None, spmm_impl: str = "auto",
             device: DeviceLike = None) -> BaselineResult:
    run = GAANRun(ds, lr=lr, faithful=faithful, noise_seq=noise_seq,
                  seed=seed, initial_params=initial_params,
                  spmm_impl=spmm_impl, device=device)
    return _loop(num_epoch, eval_every, run, ds, verbose, logger)


# ---------------------------------------------------------------------------
# TAM
# ---------------------------------------------------------------------------

def run_tam_baseline(ds: GADDataset, *, n_h: int = 300, cutting: int = 8,
                     n_tree: int = 1, num_epoch: int = 500, lr: float = 1e-5,
                     seed: int = 0, use_tam_split: bool = True,
                     eval_every: Optional[int] = None, verbose: bool = False,
                     logger=None, device: DeviceLike = None,
                     **tam_kwargs) -> BaselineResult:
    """TAM on ``ds`` (``baselines.py:488-545``). ``use_tam_split=True``
    (the default) takes TAM's own protocol, ``tam_split`` with ``seed``
    (80% labeled normals, 15% of the real anomalies added to them and
    removed from the test split), instead of the dataset's GGAD split.

    The history holds one AUROC/AP record a round (the running mean score
    after each cut; ``eval_every`` takes every k-th round), then the final
    one. ``tam_kwargs`` go to ``run_tam`` (``impl``, ``member_chunk``,
    ``draws``, ``val_stack``, ``member_params``, ``loss_record``)."""
    t0 = time.time()
    raw_adj = add_self_loops(from_scipy(ds.adj,
                                        device=resolve_device(device)))
    if use_tam_split:
        split = tam_split(ds.ano_labels, seed=seed)
        normal_idx, idx_test = split.normal_label_idx, split.idx_test
    else:
        normal_idx, idx_test = ds.normal_label_idx, ds.idx_test
    res = run_tam(raw_adj, ds.features, normal_idx, n_h=n_h,
                  cutting=cutting, n_tree=n_tree, num_epoch=num_epoch, lr=lr,
                  seed=seed, verbose=verbose, **tam_kwargs)
    labels = ds.ano_labels[idx_test]
    history = []
    for r in range(0, cutting, max(int(eval_every or 1), 1)):
        s = res.per_round_scores[r][idx_test]
        rec = {"round": r + 1, "auc": roc_auc(labels, s),
               "ap": average_precision(labels, s)}
        history.append(rec)
        if logger:
            logger(rec)
        if verbose:
            print(f"tam round {r + 1}/{cutting}: AUROC {rec['auc']:.4f} "
                  f"AP {rec['ap']:.4f}")
    auc = roc_auc(labels, res.scores[idx_test])
    ap = average_precision(labels, res.scores[idx_test])
    rec = {"epoch": num_epoch, "auc": auc, "ap": ap}
    history.append(rec)
    if logger:
        logger(rec)
    return BaselineResult(auc=auc, ap=ap, history=history,
                          wall_time_s=time.time() - t0)


# ---------------------------------------------------------------------------
# CLI dispatch
# ---------------------------------------------------------------------------

def run_baseline(name: str, ds: GADDataset, args) -> dict:
    """Train full-batch baseline ``name`` on ``ds`` with the CLI's ``args``
    (num_epoch, lr, seed, eval_every, embedding_dim, aegis_faithful,
    tam_split, spmm_impl, device) and return the CLI's record
    (``baselines.py:550-578``). TAM takes its own defaults (500 epochs,
    lr 1e-5) and route, as in JAX."""
    common = dict(num_epoch=args.num_epoch or 100, lr=args.lr or 1e-3,
                  seed=args.seed, eval_every=args.eval_every, verbose=True,
                  spmm_impl=args.spmm_impl, device=args.device)
    if name in RECONSTRUCTION:
        res = run_reconstruction(name, ds, embedding_dim=args.embedding_dim,
                                 **common)
    elif name == "ocgnn":
        res = run_ocgnn(ds, embedding_dim=args.embedding_dim, **common)
    elif name == "aegis":
        res = run_aegis(ds, embedding_dim=args.embedding_dim,
                        faithful=args.aegis_faithful, **common)
    elif name == "gaan":
        res = run_gaan(ds, **common)
    elif name == "tam":
        res = run_tam_baseline(ds, n_h=args.embedding_dim,
                               num_epoch=args.num_epoch or 500,
                               lr=args.lr or 1e-5, seed=args.seed,
                               use_tam_split=args.tam_split,
                               eval_every=args.eval_every, verbose=True,
                               device=args.device)
    else:
        raise ValueError(f"full-batch baseline {name!r} is not ported")
    return res.as_dict(name, ds.name)


# ---------------------------------------------------------------------------
# Minibatch GGAD
# ---------------------------------------------------------------------------

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
