"""Full-batch GGAD trainer (counterpart of ``ggad_tpu/train/full_batch.py``).

A :class:`FullBatchTrainer` prepares the graph once (normalization, the
forward BCSR tiles or ELL table of :func:`spmm_route`'s route, the hoisted
Â·x) and owns the model and its optimizer. What only training reads (the
transposed tiles or table, the seed-row subgraph and the labeled-column
affinity subset) is built by :meth:`FullBatchTrainer.prepare_training` at
the first step, so serving never holds it. ``train()`` runs forward,
three-term loss, backward and Adam once per epoch, with the JAX trainer's
log, eval and checkpoint cadence (``full_batch.py:454-551``);
``eval_scores`` is the scoring program that serving calls.

On a tile-dense graph an f32 step launches K1 twice (gcn2 forward on the
tiles, backward on the transposed tiles). A bf16 step also computes the
margin's affinity with K2 on the rectangular tiles of raw_adj[:, labeled]
and its backward with two more K1 launches. On a tile-sparse graph (the
ELL route) gcn2, the seed aggregation and the margin's affinity run on
sigma tables in plain PyTorch and launch neither kernel.

With ``mesh`` (a shard count D or a 1-D ``parallel.mesh`` communicator)
the trainer runs over D shards instead: the halo-partitioned path of
``parallel.halo_trainer`` (``dist_impl="halo"``) or the all-gather layout
of ``parallel.full_batch`` (``dist_impl="gspmd"``). Both keep the same
model, optimizer, ``train()``, ``evaluate()`` and checkpoints, with the
forward, the losses and the scores computed over the shards. On the BCSR
route a halo step launches, per shard, K1 six times (gcn2 forward and
backward on the local and remote rect pairs, the margin subset's
backward) and K2 once (the margin subset); a halo evaluation launches K1
twice a shard. The GSPMD path runs the edge-parallel gathers
(``spmm_impl`` is forced to ``"coo"``, as JAX forces its XLA path) and
launches neither kernel.

Preparation, each step and each scoring call run under spans
(``utils.tracing``): ``prepare`` (``prepare.normalize``, ``.route``,
``.tables``, ``.ax``), ``prepare_training`` (``prepare.transpose``,
``.seed_rows``, ``.subset``), ``step`` (``step.noise``, ``.forward``,
``.loss``, ``.backward``, ``.optimizer``) and ``score``
(``score.forward``, ``score.copy``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ggad_tpu_torch.datasets.core import GADDataset
from ggad_tpu_torch.datasets.registry import preset_for
from ggad_tpu_torch.device import DeviceLike, resolve_device
from ggad_tpu_torch.graph import Graph, from_scipy, rows_subgraph
from ggad_tpu_torch.interop import as_state_dict
from ggad_tpu_torch.models.ggad import GGAD
from ggad_tpu_torch.ops.bcsr_spmm import TILE, BCSRGraph, as_bcsr_graph
from ggad_tpu_torch.ops.ell_spmm import (
    ELLGraph,
    ELLPair,
    as_ell_graph,
    ell_affinity_subset,
    ell_sigma_from_coo,
)
from ggad_tpu_torch.ops.metrics import (
    average_precision,
    roc_auc,
    roc_auc_torch,
)
from ggad_tpu_torch.ops.normalize import normalize_adj_reference
from ggad_tpu_torch.ops.sddmm import affinity_subset, tile_affinity_subset
from ggad_tpu_torch.ops.spmm import spmm
from ggad_tpu_torch.train.checkpoint import Checkpointer
from ggad_tpu_torch.train.losses import GGADLosses, ggad_losses
from ggad_tpu_torch.utils.tracing import span

SPMM_IMPLS = ("auto", "coo", "bcsr", "ell")
# the JAX package's routing constants (full_batch.py:29-30), measured on
# the TPU; re-deriving them on the H100 is open work (ROADMAP)
MIN_EDGES_PER_TILE = 8.0
MEM_BUDGET_BYTES = 4 << 30


def spmm_route(adj: Graph, impl: str, *, dtype="float32") -> str:
    """``"bcsr"``, ``"ell"`` or ``"coo"``: the route of
    ``ggad_tpu.train.full_batch.maybe_bcsr``, decided by the graph alone
    and never by the device.

    ``"auto"`` takes BCSR when the occupied 128×128 tiles hold at least
    ``MIN_EDGES_PER_TILE`` edges each and the forward + backward tile
    stores fit ``MEM_BUDGET_BYTES`` (halved for bf16; the same count as the
    JAX package, so the same graphs take the same path), and the ELL sigma
    tables otherwise. ``"bcsr"`` and ``"ell"`` force their route; ``"coo"``
    (JAX's ``"xla"``) keeps the gather path.
    """
    if impl not in SPMM_IMPLS:
        raise ValueError(f"spmm_impl must be one of {SPMM_IMPLS}, "
                         f"got {impl!r}")
    if impl != "auto":
        return impl
    row, col, _ = adj.host_coo()
    n_pad_tiles = (adj.n_nodes + TILE - 1) // TILE
    tiles = np.unique(row // TILE * n_pad_tiles + col // TILE).shape[0]
    mem = 2 * tiles * TILE * TILE * 4  # fwd + bwd tile stores
    if dtype == "bfloat16":
        mem //= 2
    if (adj.n_edges / max(tiles, 1) < MIN_EDGES_PER_TILE
            or mem > MEM_BUDGET_BYTES):
        return "ell"
    return "bcsr"


def maybe_bcsr(adj: Graph, impl: str, *, dtype="float32",
               transpose: bool = True):
    """``adj`` with what :func:`spmm_route` picks: its BCSR tile pair, its
    ELL sigma tables (each forward only unless ``transpose``), or ``adj``
    itself."""
    route = spmm_route(adj, impl, dtype=dtype)
    if route == "bcsr":
        return as_bcsr_graph(adj, dtype=dtype, transpose=transpose)
    if route == "ell":
        return as_ell_graph(adj, layout="sigma", transpose=transpose,
                            dtype=dtype)
    return adj


def profile_activities(device: torch.device) -> Optional[list]:
    """The profiler's activities for ``profile_dir`` on ``device``: the
    host and the card on CUDA, None (no trace) elsewhere, as JAX traces
    only on the TPU (``full_batch.py:478-481``)."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity

    return [ProfilerActivity.CPU, ProfilerActivity.CUDA]


class ProfileWindow:
    """A ``torch.profiler`` trace of epochs 2..4 of a training loop, written
    as a Chrome trace to ``<out_dir>/trace_steps_2_4.json``
    (``ggad_tpu/train/full_batch.py:478-510``): it starts at the top of the
    first epoch ≥ ``first`` and stops after the step that reaches an epoch
    ≥ ``last``, once the card has finished it. Each step runs under a
    ``train_step <epoch>`` span, the step's own spans inside it. With no
    activities it traces nothing."""

    first, last = 2, 4

    def __init__(self, out_dir: Optional[str], activities):
        self.out_dir, self.activities = out_dir, activities
        self.prof = None
        self.path: Optional[str] = None

    def before(self, epoch: int) -> None:
        if (self.activities and self.prof is None and self.path is None
                and epoch >= self.first):
            from torch.profiler import profile

            self.prof = profile(activities=self.activities)
            self.prof.start()

    def step(self, epoch: int):
        if self.prof is None:
            return contextlib.nullcontext()
        return span(f"train_step {epoch}")

    def after(self, epoch: int, last_value: torch.Tensor) -> None:
        if self.prof is None or epoch < self.last:
            return
        last_value.cpu()              # the traced steps end on the card
        self.prof.stop()
        os.makedirs(self.out_dir, exist_ok=True)
        self.path = os.path.join(
            self.out_dir, f"trace_steps_{self.first}_{self.last}.json")
        self.prof.export_chrome_trace(self.path)
        self.prof = None


@dataclasses.dataclass
class TrainResult:
    params: dict           # final state_dict
    history: list          # dicts: epoch, losses, (auc, ap) when evaluated
    final_auc: float
    final_ap: float
    wall_time_s: float


def train_with_retries(make_trainer: Callable[[], "FullBatchTrainer"],
                       retries: int = 2, verbose: bool = False
                       ) -> TrainResult:
    """Rebuild the trainer and resume from its checkpoint after a failure
    (``full_batch.py:65-80``). Without ``checkpoint_dir`` a retry starts
    from scratch."""
    for attempt in range(retries + 1):
        trainer = make_trainer()
        try:
            return trainer.train(verbose=verbose)
        except Exception as e:     # noqa: BLE001 — device faults
            if attempt == retries:
                raise
            print(f"[retry] attempt {attempt + 1} failed ({e!r}); "
                  f"rebuilding and resuming from checkpoint")


@dataclasses.dataclass
class FullBatchTrainer:
    """Owns the prepared graph, the model and its optimizer for one
    dataset + config (the single-device fields of
    ``full_batch.py:96-133``)."""

    dataset: GADDataset
    lr: float = 1e-3
    weight_decay: float = 0.0
    num_epoch: Optional[int] = None
    embedding_dim: int = 300
    noise_mean: Optional[float] = None
    noise_std: Optional[float] = None
    confidence_margin: float = 0.7
    pos_weight: float = 1.0        # negsamp_ratio in the reference
    seed: int = 0
    eval_every: int = 10
    log_every: int = 2
    spmm_impl: str = "auto"
    spmm_dtype: str = "float32"    # "bfloat16": bf16 tiles, f32 sums
    logger: Optional[Callable[[dict], None]] = None
    scan_steps: int = 1            # steps between host reads of the loss
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None  # torch.profiler trace of steps 2..4
    train_auc_every: Optional[int] = None
    initial_params: Optional[Any] = None   # flax tree or state_dict
    hoist_ax: bool = True          # precompute Â@x once (Â(xW₁)=(Âx)W₁)
    device: DeviceLike = None
    mesh: Optional[Any] = None     # shard count D or a 1-D parallel.mesh
                                   # communicator → D shards
    dist_impl: str = "halo"        # "halo" or "gspmd" (all-gather layout)
    dist_schedule: str = "dense"   # halo wire: "dense", "ring", "sched"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.scan_steps < 1:
            raise ValueError(f"scan_steps must be ≥ 1, got "
                             f"{self.scan_steps}")
        ds = self.dataset
        preset = preset_for(ds.name)
        if self.num_epoch is None:
            self.num_epoch = preset.num_epoch
        if self.noise_mean is None:
            self.noise_mean = preset.noise_mean
        if self.noise_std is None:
            self.noise_std = preset.noise_std
        self._sharded = None       # the halo or GSPMD setup, with a mesh
        # made at the first step: building a torch optimizer imports
        # torch._dynamo (seconds), which serving never needs
        self.optimizer: Optional[torch.optim.Optimizer] = None
        with span("prepare"):
            if self.mesh is not None:
                self._post_init_sharded()
            else:
                self._prepare()

    def _prepare(self) -> None:
        """The single-device graph preparation."""
        ds = self.dataset
        with span("prepare.normalize"):
            adj, self.raw_adj = normalize_adj_reference(
                from_scipy(ds.adj, device=self.device))
        with span("prepare.route"):
            # decided once: adj and raw_adj share their edges, so their route
            self.route = spmm_route(adj, self.spmm_impl,
                                    dtype=self.spmm_dtype)
        with span("prepare.tables"):
            # the forward tiles or table; prepare_training adds the transposed
            self.adj = maybe_bcsr(adj, self.route, dtype=self.spmm_dtype,
                                  transpose=False)
        self.seed_adj: Optional[Graph] = None
        self.aff_sub = None
        self.features = torch.as_tensor(ds.features, dtype=torch.float32,
                                        device=self.device)
        self.seed_idx = torch.as_tensor(ds.abnormal_label_idx,
                                        dtype=torch.int64, device=self.device)
        self.normal_idx = torch.as_tensor(ds.normal_label_idx,
                                          dtype=torch.int64,
                                          device=self.device)
        # features are constant, so Â@x is computed once, on the gather
        # path as the JAX package does (full_batch.py:234-239)
        with span("prepare.ax"):
            self.ax = (spmm(self.adj, self.features, impl="coo")
                       if self.hoist_ax else None)
        self.model = GGAD(ds.feat_dim, self.embedding_dim).to(self.device)

    def _post_init_sharded(self) -> None:
        """``mesh`` set: the halo-partitioned path
        (``full_batch.py:258-330``) or the GSPMD one
        (``full_batch.py:158-168,221-232``). ``prepare_halo`` /
        ``prepare_gspmd`` build every shard structure, training's
        included, at once, and always hoist Â·x (as JAX's mesh paths do);
        ``route`` is the per-shard product's (the halo's BCSR, or ELL past
        the tile budget; ``"coo"`` on GSPMD)."""
        from ggad_tpu_torch.parallel.full_batch import prepare_gspmd
        from ggad_tpu_torch.parallel.halo_trainer import prepare_halo
        from ggad_tpu_torch.parallel.mesh import make_mesh

        if self.dist_impl not in ("halo", "gspmd"):
            raise ValueError(f"dist_impl must be 'halo' or 'gspmd', got "
                             f"{self.dist_impl!r}")
        if isinstance(self.mesh, int):
            self.mesh = make_mesh(self.mesh, comm="local",
                                  device=self.device)
        self.device = self.mesh.device
        ds = self.dataset
        if self.dist_impl == "gspmd":
            # the all-gather layout carries no tiles: JAX forces its XLA
            # op path here
            self.spmm_impl = "coo"
            self._sharded = prepare_gspmd(ds, self.mesh)
        else:
            self._sharded = prepare_halo(
                ds, self.mesh, spmm_impl=self.spmm_impl,
                spmm_dtype=self.spmm_dtype, schedule=self.dist_schedule)
        self.route = self._sharded.route
        self.adj = self.raw_adj = self.features = self.ax = None
        self.seed_adj = self.aff_sub = None
        self.seed_idx = self._sharded.seed_idx.idx
        self.normal_idx = self._sharded.normal_idx.idx
        self.model = GGAD(ds.feat_dim, self.embedding_dim).to(self.device)

    # ------------------------------------------------------------------
    def prepare_training(self) -> None:
        """Build what only a train step reads, once: the transposed tiles
        or table (gcn2's backward), the seed-row subgraph (the generator
        aggregation in O(E_seed)) and the margin's affinity subset at the
        labeled nodes (``full_batch.py:145-217``). On a tile-dense raw_adj
        the subset is edge-parallel in f32 and K2 on rectangular tiles in
        bf16; on the ELL route it is rectangular sigma tables in both, and
        the seed subgraph gets its own (``[S × N]`` forward, ``[N × S]``
        backward). raw_adj itself needs no tiles or tables. The halo and
        GSPMD paths build all of it at preparation."""
        if self.aff_sub is not None or self._sharded is not None:
            return
        with span("prepare_training"):
            self._prepare_training()

    def _prepare_training(self) -> None:
        ds = self.dataset
        graph = self.adj
        dtype = self.spmm_dtype
        with span("prepare.transpose"):
            if isinstance(graph, (BCSRGraph, ELLGraph)):
                self.adj = graph.with_transpose()
                graph = graph.graph
        with span("prepare.seed_rows"):
            sg = self.seed_adj = rows_subgraph(graph, ds.abnormal_label_idx)
            if self.route == "ell":
                sr, sc, sv = sg.host_coo()
                self.seed_adj = ELLGraph(
                    graph=sg, layout="sigma", tables=ELLPair(
                        fwd=ell_sigma_from_coo(sr, sc, sv, sg.n_nodes,
                                               dtype=dtype,
                                               device=self.device),
                        bwd=ell_sigma_from_coo(sc, sr, sv, ds.n_nodes,
                                               dtype=dtype,
                                               device=self.device),
                        n_nodes=sg.n_nodes))
        with span("prepare.subset"):
            labeled = np.concatenate([
                np.asarray(ds.normal_label_idx, np.int64),
                np.asarray(ds.abnormal_label_idx, np.int64)])
            if self.route == "ell":
                self.aff_sub = ell_affinity_subset(self.raw_adj, labeled,
                                                   dtype=dtype)
            elif self.route == "bcsr" and dtype == "bfloat16":
                self.aff_sub = tile_affinity_subset(self.raw_adj, labeled,
                                                    dtype=dtype)
            else:
                self.aff_sub = affinity_subset(self.raw_adj, labeled)

    def make_optimizer(self) -> torch.optim.Optimizer:
        """Adam, or AdamW when ``weight_decay``; the update formulas of
        ``optax.adam`` / ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8)."""
        params = self.model.parameters()
        if self.weight_decay:
            return torch.optim.AdamW(params, lr=self.lr,
                                     weight_decay=self.weight_decay)
        return torch.optim.Adam(params, lr=self.lr)

    def init(self, generator: Optional[torch.Generator] = None
             ) -> dict[str, torch.Tensor]:
        """Seeded parameters on the trainer's device (``generator``, or
        one seeded with 0, as the JAX serving path inits with
        ``PRNGKey(0)``)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        fresh = GGAD(self.dataset.feat_dim, self.embedding_dim,
                     generator=generator)
        return {k: v.detach().to(self.device)
                for k, v in fresh.state_dict().items()}

    def initial_state(self) -> dict[str, torch.Tensor]:
        """``initial_params`` (a flax tree of arrays or a ``state_dict``)
        on the device, else the port's init seeded with ``seed``."""
        if self.initial_params is None:
            return self.init(torch.Generator().manual_seed(self.seed))
        return as_state_dict(self.initial_params, self.device)

    def params(self) -> dict[str, torch.Tensor]:
        """A copy of the model's current ``state_dict``."""
        return {k: v.detach().clone()
                for k, v in self.model.state_dict().items()}

    # ------------------------------------------------------------------
    def draw_noise(self, generator: torch.Generator) -> torch.Tensor:
        """The seed perturbation ``N(0, 1)·noise_std + noise_mean``,
        ``[S, n_h]``, from ``generator`` (on the trainer's device)."""
        z = torch.randn(self.seed_idx.shape[0], self.embedding_dim,
                        generator=generator, device=self.device)
        return z * self.noise_std + self.noise_mean

    def compute_losses(self, noise: torch.Tensor) -> GGADLosses:
        """Train-branch forward and the three-term loss at the model's
        current parameters, with autograd recording: the forward under
        ``step.forward``, the losses under ``step.loss`` (the sharded
        paths compute both in one call, under ``step.forward``)."""
        if self._sharded is not None:
            with span("step.forward"):
                return self._sharded.losses(
                    dict(self.model.named_parameters()), noise, self.mesh,
                    confidence_margin=self.confidence_margin,
                    pos_weight=self.pos_weight)
        self.prepare_training()
        with span("step.forward"):
            out = self.model(self.adj, self.features, self.seed_idx,
                             self.normal_idx, train=True,
                             seed_adj=self.seed_adj, ax=self.ax, noise=noise)
        with span("step.loss"):
            return ggad_losses(out, self.raw_adj, self.seed_idx,
                               self.normal_idx,
                               confidence_margin=self.confidence_margin,
                               pos_weight=self.pos_weight,
                               aff_sub=self.aff_sub)

    def train_step(self, generator: torch.Generator) -> GGADLosses:
        """One step: noise, forward, loss, backward, optimizer update.
        Returns the losses, detached (on the device, not read)."""
        with span("step"):
            if self.optimizer is None:
                self.optimizer = self.make_optimizer()
            self.optimizer.zero_grad(set_to_none=True)
            with span("step.noise"):
                noise = self.draw_noise(generator)
            losses = self.compute_losses(noise)
            with span("step.backward"):
                losses.total.backward()
            with span("step.optimizer"):
                self.optimizer.step()
            return GGADLosses(*(t.detach() for t in losses))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def logits(self, params: Optional[Mapping[str, torch.Tensor]] = None
               ) -> torch.Tensor:
        """One one-class logit per node on the device. ``params``, when
        given, are loaded into the trainer's model first."""
        if params is not None:
            self.model.load_state_dict(params)
        if self._sharded is not None:
            scores = self._sharded.scores(dict(self.model.named_parameters()),
                                       self.mesh)
            return scores[:self.dataset.n_nodes]
        out = self.model(self.adj, self.features, train=False, ax=self.ax)
        return out.logits[:, 0]

    def eval_scores(self, params: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> np.ndarray:
        """One one-class logit per node (higher = more anomalous), the
        reference's eval-branch semantics (``run.py:230-240``), on the
        host."""
        with span("score"):
            with span("score.forward"):
                logits = self.logits(params)
            with span("score.copy"):
                return logits.cpu().numpy()

    def evaluate(self, params: Optional[Mapping[str, torch.Tensor]] = None,
                 subset: str = "test") -> tuple[float, float]:
        scores = self.eval_scores(params)
        ds = self.dataset
        idx = {"test": ds.idx_test, "val": ds.idx_val,
               "train": ds.idx_train}[subset]
        return (roc_auc(ds.ano_labels[idx], scores[idx]),
                average_precision(ds.ano_labels[idx], scores[idx]))

    def train_auc(self, params: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> float:
        """AUROC over the train split on the device; only the final scalar
        reaches the host (reference ``run.py:217-228``)."""
        if not hasattr(self, "_auc_labels"):
            ds = self.dataset
            self._auc_labels = torch.as_tensor(
                ds.ano_labels, dtype=torch.float32, device=self.device)
            mask = torch.zeros(ds.n_nodes, device=self.device)
            mask[torch.as_tensor(ds.idx_train, dtype=torch.int64)] = 1.0
            self._auc_mask = mask
        return float(roc_auc_torch(self._auc_labels, self.logits(params),
                                   self._auc_mask))

    # ------------------------------------------------------------------
    def train(self, verbose: bool = False) -> TrainResult:
        """Train ``num_epoch`` epochs from ``initial_state()``, or resume
        from the newest checkpoint in ``checkpoint_dir`` (model, optimizer,
        noise generator and epoch)."""
        self.prepare_training()
        self.model.load_state_dict(self.initial_state())
        self.optimizer = self.make_optimizer()
        generator = torch.Generator(self.device).manual_seed(self.seed)

        ckpt = None
        epoch = 0
        if self.checkpoint_dir:
            ckpt = Checkpointer(self.checkpoint_dir)
            restored = ckpt.restore()
            if restored is not None:
                self.model.load_state_dict(restored["params"])
                self.optimizer.load_state_dict(restored["opt_state"])
                generator.set_state(restored["rng"])
                epoch = int(restored["epoch"]) + 1

        history = []
        window = ProfileWindow(self.profile_dir, self.profile_dir
                               and profile_activities(self.device))
        t0 = time.time()
        while epoch < self.num_epoch:
            window.before(epoch)
            # run up to scan_steps steps, stopping at the next log/eval
            # boundary, before reading the loss. JAX fuses them with
            # lax.scan; here they run one after another, but the chunks
            # set which epochs are logged, evaluated and checkpointed, as
            # in JAX (a chunk ending past a boundary skips it)
            boundary = next(e for e in range(epoch + 1, self.num_epoch + 1)
                            if e % self.log_every == 0
                            or e % self.eval_every == 0
                            or e == self.num_epoch)
            chunk = min(max(boundary - epoch, 1), self.scan_steps)
            for i in range(chunk):
                with window.step(epoch + i):
                    losses = self.train_step(generator)
            epoch += chunk - 1
            window.after(epoch, losses.total)

            rec = None
            last = epoch == self.num_epoch - 1
            if epoch % self.log_every == 0 or last:
                rec = {"epoch": epoch,
                       "loss": float(losses.total),
                       "loss_bce": float(losses.bce),
                       "loss_margin": float(losses.margin),
                       "loss_rec": float(losses.rec)}
            if self.train_auc_every and (
                    epoch % self.train_auc_every == 0 or last):
                tauc = self.train_auc()
                rec = rec or {"epoch": epoch}
                rec["train_auc"] = tauc
                if verbose:
                    print(f"epoch {epoch:4d}  train AUROC {tauc:.4f}")
            if epoch % self.eval_every == 0 or last:
                auc, ap = self.evaluate()
                rec = rec or {"epoch": epoch}
                rec.update({"auc": auc, "ap": ap})
                if verbose:
                    print(f"epoch {epoch:4d}  AUROC {auc:.4f}  AP {ap:.4f}  "
                          f"loss {float(losses.total):.4f}")
            if rec is not None:
                history.append(rec)
                if self.logger is not None:
                    self.logger(rec)
            if ckpt is not None and (epoch % self.eval_every == 0 or last):
                # the state is replicated: under the "dist" communicator
                # rank 0 alone writes and prunes the shared directory,
                # and no rank goes on until it has
                if getattr(self.mesh, "rank", 0) == 0:
                    ckpt.save(epoch, {
                        "params": self.params(),
                        "opt_state": self.optimizer.state_dict(),
                        "rng": generator.get_state(), "epoch": epoch})
                if self.mesh is not None:
                    self.mesh.barrier()
            epoch += 1

        wall = time.time() - t0
        final_auc, final_ap = self.evaluate()
        return TrainResult(params=self.params(), history=history,
                           final_auc=final_auc, final_ap=final_ap,
                           wall_time_s=wall)
