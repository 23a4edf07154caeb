"""Full-batch GGAD trainer (counterpart of ``ggad_tpu/train/full_batch.py``),
with the members that serving needs: graph preparation, ``init``,
``eval_scores`` and ``evaluate``. ``train()`` comes with the training
slice.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from ggad_tpu_torch.datasets.core import GADDataset
from ggad_tpu_torch.device import DeviceLike, resolve_device
from ggad_tpu_torch.graph import Graph, from_scipy
from ggad_tpu_torch.models.ggad import GGAD
from ggad_tpu_torch.ops.bcsr_spmm import TILE, as_bcsr_graph
from ggad_tpu_torch.ops.metrics import average_precision, roc_auc
from ggad_tpu_torch.ops.normalize import normalize_adj_reference
from ggad_tpu_torch.ops.spmm import spmm

SPMM_IMPLS = ("auto", "coo", "bcsr", "ell")
# the JAX package's routing constants (full_batch.py:29-30), measured on
# the TPU; re-deriving them on the H100 is open work (ROADMAP)
MIN_EDGES_PER_TILE = 8.0
MEM_BUDGET_BYTES = 4 << 30


def maybe_bcsr(adj: Graph, impl: str, *, dtype="float32"):
    """Swap in the BCSR tiles when they pay off — the routing of
    ``ggad_tpu.train.full_batch.maybe_bcsr``, decided by the graph alone
    and never by the device.

    ``"auto"`` takes BCSR when the occupied 128×128 tiles hold at least
    ``MIN_EDGES_PER_TILE`` edges each and the forward + backward tile
    stores fit ``MEM_BUDGET_BYTES`` (the same count as the JAX package, so
    the same graphs take the same path), and the sparse ELL path
    otherwise. ``"bcsr"`` forces the tiles; ``"coo"`` (JAX's ``"xla"``)
    keeps the gather path. The ELL path is not ported yet and raises.
    """
    if impl not in SPMM_IMPLS:
        raise ValueError(f"spmm_impl must be one of {SPMM_IMPLS}, "
                         f"got {impl!r}")
    if impl == "coo":
        return adj
    ell = NotImplementedError(
        "the ELL (tile-sparse) SpMM path is not ported yet (ROADMAP "
        "Queue 1, ELL slice); use spmm_impl='coo' or 'bcsr'")
    if impl == "ell":
        raise ell
    if impl == "auto":
        row, col, _ = adj.host_coo()
        n_pad_tiles = (adj.n_nodes + TILE - 1) // TILE
        tiles = np.unique(row // TILE * n_pad_tiles + col // TILE).shape[0]
        mem = 2 * tiles * TILE * TILE * 4  # fwd + bwd tile stores
        if dtype == "bfloat16":
            mem //= 2
        if (adj.n_edges / max(tiles, 1) < MIN_EDGES_PER_TILE
                or mem > MEM_BUDGET_BYTES):
            raise ell
    return as_bcsr_graph(adj, dtype=dtype)


@dataclasses.dataclass
class FullBatchTrainer:
    """Owns the prepared graph and the model for one dataset + config.

    Serving members only; the training members of the JAX trainer (its
    optimizer, noise and epoch settings, ``train``) come with the
    training slice.
    """

    dataset: GADDataset
    embedding_dim: int = 300
    spmm_impl: str = "auto"
    spmm_dtype: str = "float32"    # "bfloat16": bf16 tiles, f32 sums
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        ds = self.dataset
        graph = from_scipy(ds.adj, device=self.device)
        adj, _ = normalize_adj_reference(graph)
        self.adj = maybe_bcsr(adj, self.spmm_impl, dtype=self.spmm_dtype)
        self.features = torch.as_tensor(ds.features, dtype=torch.float32,
                                        device=self.device)
        # features are constant, so Â@x is computed once, on the gather
        # path as the JAX package does (full_batch.py:234-239)
        self.ax = spmm(self.adj, self.features, impl="coo")
        self.model = GGAD(ds.feat_dim, self.embedding_dim).to(self.device)

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

    @torch.no_grad()
    def eval_scores(self, params: Mapping[str, torch.Tensor]) -> np.ndarray:
        """One one-class logit per node (higher = more anomalous), the
        reference's eval-branch semantics (``run.py:230-240``)."""
        self.model.load_state_dict(params)
        out = self.model(self.adj, self.features, train=False, ax=self.ax)
        return out.logits[:, 0].cpu().numpy()

    def evaluate(self, params: Mapping[str, torch.Tensor],
                 subset: str = "test") -> tuple[float, float]:
        scores = self.eval_scores(params)
        ds = self.dataset
        idx = {"test": ds.idx_test, "val": ds.idx_val,
               "train": ds.idx_train}[subset]
        return (roc_auc(ds.ano_labels[idx], scores[idx]),
                average_precision(ds.ano_labels[idx], scores[idx]))
