"""Baseline runners (counterpart of ``ggad_tpu/train/baselines.py``).

The full-batch baseline zoo (DOMINANT, AnomalyDAE, OCGNN, AEGIS, GAAN;
``baselines.py:27-487,550-579``): one run class per objective family,
each preparing the graph once (:func:`_prep`), holding the model at its
initial weights and its optimizers, and running one epoch per ``step()``;
``_loop`` runs the epochs with the reference's evaluation cadence.

The minibatch models (``baselines.py:581-872``): ``run_minibatch_model``
dispatches GGAD's DGraph trainer and the minibatch baselines, GraphSAGE
and PC-GNN (``run_minibatch_classifier``, :class:`MiniBatchClassifierRun`)
and the sampled DOMINANT, AnomalyDAE and AEGIS (``run_minibatch_recon``,
:class:`MiniBatchReconRun`), plain PyTorch on the device.

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
from ggad_tpu_torch.models.pcgnn import PCGNN, pcgnn_loss, pcgnn_prob
from ggad_tpu_torch.models.sage import GraphSAGEClassifier
from ggad_tpu_torch.models.sage_recon import (
    MiniBatchAEGIS,
    MiniBatchRecon,
    aegis_mb_losses,
)
from ggad_tpu_torch.models.tam import run_tam
from ggad_tpu_torch.ops.metrics import average_precision, roc_auc
from ggad_tpu_torch.ops.normalize import normalize_adj_reference
from ggad_tpu_torch.sampler.neighbor import NeighborTable
from ggad_tpu_torch.train.full_batch import maybe_bcsr
from ggad_tpu_torch.train.minibatch import MiniBatchTrainer

# the reconstruction family: model and training loss by name
RECONSTRUCTION = {"dominant": (Dominant, dominant_loss),
                  "anomalydae": (AnomalyDAE, anomaly_dae_loss)}
BASELINES = (*RECONSTRUCTION, "ocgnn", "aegis", "gaan", "tam")
MINIBATCH_CLASSIFIERS = ("sage", "pcgnn")
MINIBATCH_RECON = ("dominant-minibatch", "anomalydae-minibatch",
                   "aegis-minibatch")
MINIBATCH_MODELS = ("ggad-minibatch", *MINIBATCH_CLASSIFIERS,
                    *MINIBATCH_RECON)


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
    elif name in MINIBATCH_MODELS:
        return run_minibatch_model(name, ds, args)
    else:
        raise ValueError(f"unknown model {name!r}")
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
    """Train minibatch model ``name`` on ``ds`` with the CLI's ``args``
    (seed, num_epoch, lr, checkpoint_dir, device; ``dp_devices``, a shard
    count or a communicator, for GGAD) and return the CLI's record
    (``baselines.py:581-622``). As in JAX, ``--seed`` draws the split; the
    GGAD trainer keeps its seed 0, the baselines take it."""
    if name not in MINIBATCH_MODELS:
        raise ValueError(f"unknown minibatch model {name!r}")
    if name == "ggad-minibatch":
        tr = minibatch_trainer(ds, split_seed=args.seed,
                               num_epochs=args.num_epoch or 30,
                               checkpoint_dir=args.checkpoint_dir,
                               device=args.device,
                               mesh=getattr(args, "dp_devices", None))
        res = tr.train(verbose=True)
        out = {"model": name, "dataset": ds.name,
               "best_val_auc": res.best_val_auc,
               "best_epoch": res.best_epoch,
               "wall_time_s": res.wall_time_s}
        out.update({f"test_{k}": v for k, v in res.test_metrics.items()})
        return out
    adj = ds.adj + sp.eye(ds.n_nodes, format="csr", dtype=np.float32)
    idx_train, idx_valid, idx_test, labels, idx_anom = minibatch_split_for(
        ds.name, ds.ano_labels, seed=args.seed)
    common = dict(num_epochs=args.num_epoch or 30, lr=args.lr or 1e-3,
                  seed=args.seed, verbose=True, device=args.device)
    if name in MINIBATCH_CLASSIFIERS:
        res = run_minibatch_classifier(
            name, adj, ds.features, labels, idx_train, idx_anom, idx_valid,
            idx_test, relations=ds.relations, **common)
    else:
        res = run_minibatch_recon(name, adj, ds.features, labels, idx_train,
                                  idx_valid, idx_test, **common)
    res.update({"model": name, "dataset": ds.name})
    return res


# ---------------------------------------------------------------------------
# Minibatch baselines: GraphSAGE, PC-GNN and the sampled reconstructions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _SampledRun:
    """What the minibatch baselines share (``baselines.py:625-872``): the
    neighbor table and features on the device, the model at its initial
    weights (seeded init, or ``initial_params``: a flax tree or a
    ``state_dict``), the uniform draws, and scoring in zero-padded chunks
    of 1,024 ids, each chunk with its own draw.

    The draws come from ``generator`` (seeded with ``seed``; scoring from
    a fresh one seeded ``eval_seed``, JAX's scoring key), or from
    ``draws``, a callable that returns the next draw for a shape, so that a
    test can feed JAX's. An epoch's draws are asked for at once, one
    ``(num_batches, *shape)`` each shape of ``sample_shapes(B)``; a
    scoring call's one ``(n_chunks, *shape)`` each shape of
    ``sample_shapes(1024)``. Each step's loss stays on the device, unread,
    in ``losses``, for the caller."""

    adj: object                   # scipy adjacency WITH self-loops
    features: np.ndarray          # [N, F]
    labels: np.ndarray            # [N] 0/1
    idx_train: np.ndarray
    idx_valid: np.ndarray
    idx_test: np.ndarray
    emb_dim: int = 64
    batch_size: int = 150
    num_batches: int = 50
    num_epochs: int = 30
    lr: float = 1e-3
    seed: int = 0
    initial_params: Optional[object] = None
    draws: Optional[Callable[[tuple], object]] = None
    device: DeviceLike = None

    eval_batch = 1024
    eval_seed = 0
    rows_per_pass = 1 << 16   # chunks scored together (rows independent)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.table = NeighborTable.from_scipy(self.adj, device=self.device)
        self.feats = torch.as_tensor(
            np.asarray(self.features, np.float32)).to(self.device)
        self.labels = np.asarray(self.labels)
        self.generator = torch.Generator(self.device).manual_seed(self.seed)
        self.model = self.make_model(
            torch.Generator().manual_seed(self.seed)).to(self.device)
        if self.initial_params is not None:
            self.model.load_state_dict(
                as_state_dict(self.initial_params, self.device))
        self.optimizer = self.make_optimizer()
        self.losses: list[torch.Tensor] = []

    # the model's hooks -------------------------------------------------
    def make_model(self, generator: torch.Generator) -> torch.nn.Module:
        raise NotImplementedError

    def make_optimizer(self) -> torch.optim.Optimizer:
        raise NotImplementedError

    def sample_shapes(self, b: int) -> list[tuple]:
        """The shapes of one forward's draws over ``b`` rows."""
        raise NotImplementedError

    def loss(self, batch, y, us) -> torch.Tensor:
        raise NotImplementedError

    def probs(self, ids, us) -> torch.Tensor:
        raise NotImplementedError

    # -------------------------------------------------------------------
    def draw(self, shape: tuple, generator: torch.Generator) -> torch.Tensor:
        if self.draws is not None:
            return torch.as_tensor(self.draws(shape),
                                   dtype=torch.float32).to(self.device)
        return torch.rand(shape, generator=generator, device=self.device)

    def step(self, batch: torch.Tensor, y: Optional[torch.Tensor],
             us: list) -> torch.Tensor:
        """One step: forward, loss, backward, optimizer. Returns the loss,
        detached and unread."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(batch, y, us)
        loss.backward()
        self.optimizer.step()
        loss = loss.detach()
        self.losses.append(loss)
        return loss

    def train_epoch(self, batches: torch.Tensor,
                    ys: Optional[torch.Tensor]) -> torch.Tensor:
        """Every batch of ``batches`` ([num_batches, B]) in turn, the
        draws made at once; the last loss, unread."""
        nb, b = batches.shape
        us = [self.draw((nb, *s), self.generator)
              for s in self.sample_shapes(b)]
        for i in range(nb):
            loss = self.step(batches[i], None if ys is None else ys[i],
                             [u[i] for u in us])
        return loss

    @torch.no_grad()
    def score_nodes(self, node_ids) -> np.ndarray:
        """Scores of ``node_ids`` on the host at the model's weights."""
        node_ids = np.asarray(node_ids)
        n, bs = node_ids.shape[0], self.eval_batch
        n_chunks = -(-n // bs)
        padded = np.zeros(n_chunks * bs, np.int32)
        padded[:n] = node_ids
        ids = torch.from_numpy(padded).to(self.device)
        gen = torch.Generator(self.device).manual_seed(self.eval_seed)
        us = [self.draw((n_chunks, *s), gen).reshape(n_chunks * s[0],
                                                     *s[1:])
              for s in self.sample_shapes(bs)]
        out = torch.empty(n_chunks * bs, device=self.device)
        rows = max(self.rows_per_pass // bs, 1) * bs
        per_row = [u.shape[0] // (n_chunks * bs) for u in us]
        for r0 in range(0, n_chunks * bs, rows):
            r1 = min(r0 + rows, n_chunks * bs)
            out[r0:r1] = self.probs(ids[r0:r1], [
                u[r0 * k: r1 * k] for u, k in zip(us, per_row)])
        return out[:n].cpu().numpy()

    def test_metrics(self) -> dict:
        probs = self.score_nodes(self.idx_test)
        y = self.labels[np.asarray(self.idx_test)]
        return {"test_auc": roc_auc(y, probs),
                "test_ap": average_precision(y, probs)}


@dataclasses.dataclass
class MiniBatchReconRun(_SampledRun):
    """DOMINANT-mb, AnomalyDAE-mb and AEGIS-mb (``baselines.py:625-735``):
    Adam, ``batch_size`` ids a step drawn from ``idx_train`` with
    replacement by ``default_rng(seed)``, fanout 16; scoring draws from
    seed 999. AEGIS-mb's ``[N, F]`` noise table is ``noise_table``, or a
    standard normal draw of ``generator`` made before anything else (JAX
    draws it from the first split of its key). Scoring pads each chunk
    with node 0; AEGIS-mb scores one chunk a forward, since the pad rows
    enter its BatchNorm statistics, as in JAX."""

    name: str = "dominant-minibatch"
    noise_table: Optional[object] = None

    eval_seed = 999
    fanout = 16

    def __post_init__(self):
        if self.name not in MINIBATCH_RECON:
            raise ValueError(f"unknown minibatch reconstruction model "
                             f"{self.name!r}")
        super().__post_init__()
        if self.name == "aegis-minibatch":
            self.rows_per_pass = self.eval_batch
            self.noise_table = (
                torch.randn(self.feats.shape, generator=self.generator,
                            device=self.device)
                if self.noise_table is None else torch.as_tensor(
                    self.noise_table, dtype=torch.float32).to(self.device))

    def make_model(self, generator):
        f = self.feats.shape[1]
        if self.name == "aegis-minibatch":
            return MiniBatchAEGIS(f, self.emb_dim, self.fanout,
                                  generator=generator)
        return MiniBatchRecon(
            f, self.emb_dim, self.fanout,
            pos_weighted=self.name == "anomalydae-minibatch",
            generator=generator)

    def make_optimizer(self):
        return torch.optim.Adam(self.model.parameters(), lr=self.lr)

    def sample_shapes(self, b):
        return [(b, self.fanout)]

    def loss(self, batch, y, us):
        if self.name == "aegis-minibatch":
            ld, lg = aegis_mb_losses(self.model(
                self.feats, self.noise_table, self.table, batch, u=us[0]))
            return ld + lg
        x_rec = self.model(self.feats, self.table, batch, u=us[0])
        return self.model.train_loss(x_rec, self.feats[batch])

    def probs(self, ids, us):
        if self.name == "aegis-minibatch":
            return self.model(self.feats, self.noise_table, self.table, ids,
                              u=us[0]).prob_real
        x_rec = self.model(self.feats, self.table, ids, u=us[0])
        return MiniBatchRecon.scores(x_rec, self.feats[ids])

    def draw_batches(self, host_rng: np.random.Generator
                     ) -> tuple[torch.Tensor, None]:
        """An epoch's ``[num_batches, batch_size]`` ids (and no labels),
        one numpy call a step as JAX makes them."""
        pool = np.asarray(self.idx_train, np.int64)
        ids = [host_rng.choice(pool, self.batch_size, replace=True)
               for _ in range(self.num_batches)]
        return torch.from_numpy(np.stack(ids).astype(np.int32)).to(
            self.device), None

    def train(self, verbose: bool = False) -> dict:
        host_rng = np.random.default_rng(self.seed)
        t0 = time.time()
        for epoch in range(self.num_epochs):
            loss = self.train_epoch(*self.draw_batches(host_rng))
            if verbose and epoch % 5 == 0:
                print(f"epoch {epoch}  loss {float(loss):.4f}")
        return {**self.test_metrics(), "wall_time_s": time.time() - t0}


@dataclasses.dataclass
class MiniBatchClassifierRun(_SampledRun):
    """GraphSAGE (cross-entropy, fanout 5) and PC-GNN (cross-entropy +
    5·affinity margin, fanouts 16/8 a relation) (``baselines.py:738-872``):
    AdamW (decoupled decay 0.007, as ``optax.adamw``); each step
    ``batch_size`` normal ids and ``n_anom`` ids of the deduplicated
    anomaly pool, drawn by ``default_rng(seed)``; validation at every
    fifth epoch and the last, the best-AUROC weights scoring
    ``idx_test``; scoring draws from seed 4321. ``relations``: one
    adjacency a relation (each gets +I); without them PC-GNN shares one
    table of ``adj`` over three relations."""

    idx_anomaly: np.ndarray = None
    name: str = "sage"
    n_anom: int = 50
    weight_decay: float = 0.007
    relations: Optional[list] = None

    eval_seed = 4321

    def __post_init__(self):
        if self.name not in MINIBATCH_CLASSIFIERS:
            raise ValueError(f"unknown minibatch classifier {self.name!r}")
        super().__post_init__()
        if self.name == "pcgnn" and self.relations is None:
            self.tables = [self.table] * self.model.n_relations   # shared
        elif self.name == "pcgnn":
            eye = sp.eye(self.adj.shape[0], format="csr", dtype=np.float32)
            self.tables = [NeighborTable.from_scipy(r + eye,
                                                    device=self.device)
                           for r in self.relations]
        labels, idx_train = self.labels, np.asarray(self.idx_train)
        self._train_pool = idx_train[labels[idx_train] == 0].astype(np.int64)
        self._anom_pool = np.unique(np.concatenate([
            np.asarray(self.idx_anomaly), idx_train[labels[idx_train] == 1]
        ]).astype(np.int64))

    def make_model(self, generator):
        f = self.feats.shape[1]
        if self.name == "pcgnn":
            n_rel = 3 if self.relations is None else len(self.relations)
            return PCGNN(f, self.emb_dim, n_rel, generator=generator)
        return GraphSAGEClassifier(f, self.emb_dim, fanout=5,
                                   generator=generator)

    def make_optimizer(self):
        return torch.optim.AdamW(self.model.parameters(), lr=self.lr,
                                 weight_decay=self.weight_decay)

    def sample_shapes(self, b):
        if self.name == "pcgnn":
            m = self.model
            return [(b, m.fanout1), (b * m.fanout1, m.fanout2)] \
                * m.n_relations
        return [(b, self.model.fanout)]

    def _forward(self, ids, us):
        if self.name == "pcgnn":
            return self.model(self.feats, self.tables, ids,
                              draws=list(zip(us[::2], us[1::2])))
        return self.model(self.feats, self.table, ids, u=us[0])

    def loss(self, batch, y, us):
        out = self._forward(batch, us)
        if self.name == "pcgnn":
            return pcgnn_loss(out, y)[0]
        return torch.nn.functional.cross_entropy(out, y.long())

    def probs(self, ids, us):
        out = self._forward(ids, us)
        return pcgnn_prob(out) if self.name == "pcgnn" \
            else torch.sigmoid(out[:, 1])

    def draw_batches(self, host_rng: np.random.Generator
                     ) -> tuple[torch.Tensor, torch.Tensor]:
        """An epoch's ``[num_batches, batch_size + n_anom]`` ids and their
        labels, the numpy calls of JAX's steps in JAX's order."""
        replace = len(self._anom_pool) < self.n_anom
        ids = np.stack([np.concatenate([
            host_rng.choice(self._train_pool, self.batch_size, replace=True),
            host_rng.choice(self._anom_pool, self.n_anom, replace=replace)])
            for _ in range(self.num_batches)])
        return (torch.from_numpy(ids.astype(np.int32)).to(self.device),
                torch.from_numpy(self.labels[ids].astype(np.int32)).to(
                    self.device))

    def train(self, verbose: bool = False) -> dict:
        host_rng = np.random.default_rng(self.seed)
        best_auc, best = -1.0, None
        y_valid = self.labels[np.asarray(self.idx_valid)]
        t0 = time.time()
        for epoch in range(self.num_epochs):
            loss = self.train_epoch(*self.draw_batches(host_rng))
            if epoch % 5 == 0 or epoch == self.num_epochs - 1:
                auc = roc_auc(y_valid, self.score_nodes(self.idx_valid))
                if auc > best_auc:
                    best_auc = auc
                    best = {k: v.detach().clone()
                            for k, v in self.model.state_dict().items()}
                if verbose:
                    print(f"epoch {epoch}  val AUROC {auc:.4f}  "
                          f"loss {float(loss):.4f}")
        if best is not None:
            self.model.load_state_dict(best)
        return {"best_val_auc": best_auc, **self.test_metrics(),
                "wall_time_s": time.time() - t0}


def run_minibatch_recon(name, adj, features, labels, idx_train, idx_valid,
                        idx_test, *, verbose: bool = False, **kw) -> dict:
    """DOMINANT-mb, AnomalyDAE-mb or AEGIS-mb (``baselines.py:625-735``):
    ``{"test_auc", "test_ap", "wall_time_s"}``. ``kw`` sets
    :class:`MiniBatchReconRun`'s fields."""
    return MiniBatchReconRun(adj, features, labels, idx_train, idx_valid,
                             idx_test, name=name, **kw).train(verbose)


def run_minibatch_classifier(name, adj, features, labels, idx_train,
                             idx_anomaly, idx_valid, idx_test, *,
                             verbose: bool = False, **kw) -> dict:
    """GraphSAGE or PC-GNN (``baselines.py:738-872``): ``{"best_val_auc",
    "test_auc", "test_ap", "wall_time_s"}``. ``kw`` sets
    :class:`MiniBatchClassifierRun`'s fields."""
    return MiniBatchClassifierRun(adj, features, labels, idx_train,
                                  idx_valid, idx_test, name=name,
                                  idx_anomaly=idx_anomaly, **kw
                                  ).train(verbose)
