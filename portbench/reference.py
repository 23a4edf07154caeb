"""Plain references of what the timed paths compute: GGAD's training step
and scores, and TAM's ensemble epoch, in float32 with TF32 off.

Written from the published descriptions (GGAD: arXiv:2402.11887 and its
``run.py`` / ``model.py``; TAM: arXiv:2306.00006 and its ``tam.py`` /
``model_tam.py``), in plain PyTorch, numpy and scipy. It imports nothing
of the program: every sparse product is a ``torch.sparse.mm`` on a CSR
matrix that this file builds from the benchmark's host graph, Adam is
written out, and TAM's cuts, symmetrisation and normalisation are worked
out again here from the benchmark's uniform draws.

``precision="tf32"`` is the control: the same computation with every
dense product's operands rounded to TF32 (a 10-bit mantissa, round to
nearest even), the step below float32 that would tempt a later change.
``fault="half_batch"`` leaves half of the batch out of the loss (every
other row of GGAD's BCE; every other labeled normal of TAM's sum), the
fault a test plants in the program.
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.sparse as sp
import torch
import torch.nn.functional as F

BETAS = (0.9, 0.999)
EPS = 1e-8


def set_f32():
    """TF32 off for every product on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest
    even, and kept in float32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class TF32Linear(torch.autograd.Function):
    """``x @ w.T`` as a TF32 product computes it, forward and backward:
    each product's operands rounded to TF32, the sums in float32."""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        return xr @ wr.transpose(-1, -2)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        g = round_tf32(g)
        return g @ wr, g.transpose(-1, -2) @ xr


def linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """``x @ w.T`` in float32, or in TF32 for the control."""
    if precision == "tf32":
        return TF32Linear.apply(x, w)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    return x @ w.transpose(-1, -2)


def csr(m: sp.spmatrix, device) -> torch.Tensor:
    m = sp.csr_matrix(m, dtype=np.float32)
    m.sort_indices()
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", "Sparse CSR tensor support")
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.indptr.astype(np.int64)),
            torch.from_numpy(m.indices.astype(np.int64)),
            torch.from_numpy(m.data), size=m.shape, device=device,
            check_invariants=False)


class SparseMM(torch.autograd.Function):
    """``a @ x`` for a CSR ``a`` and dense ``x``; the gradient in ``x`` is
    ``a_t @ g`` with ``a_t`` the transpose, given as its own CSR."""

    @staticmethod
    def forward(ctx, x, a, a_t):
        ctx.a_t = a_t
        return torch.sparse.mm(a, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.a_t, g.contiguous()), None, None


class Operator:
    """A sparse matrix and its transpose on the device."""

    def __init__(self, m: sp.spmatrix, device):
        m = sp.csr_matrix(m, dtype=np.float32)
        self.a = csr(m, device)
        self.a_t = csr(m.T, device)
        self.nnz = int(m.nnz)

    def __matmul__(self, x: torch.Tensor) -> torch.Tensor:
        return SparseMM.apply(x, self.a, self.a_t)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, alpha * x)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows over their L2 norm; a zero row stays zero, with a zero
    gradient (the guard sits inside the square root)."""
    sq = x.square().sum(-1, keepdim=True)
    pos = sq > 0
    norm = torch.sqrt(torch.where(pos, sq, torch.ones_like(sq)))
    return torch.where(pos, x / norm, torch.zeros_like(x))


def sym_normalize(a: sp.csr_matrix) -> sp.csr_matrix:
    """D^-1/2 A D^-1/2 with D the row sums (0 where a row is empty)."""
    deg = np.asarray(a.sum(1)).ravel()
    inv = np.zeros_like(deg)
    inv[deg > 0] = deg[deg > 0] ** -0.5
    d = sp.diags(inv.astype(np.float32))
    return (d @ a @ d).tocsr()


class Adam:
    """Adam (Kingma & Ba), written out, one state per leaf."""

    def __init__(self, params: dict, lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        b1, b2 = BETAS
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(EPS)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_readings(loss_fn, params: dict, lr: float, steps: int = 3
                   ) -> dict:
    """``steps`` steps of loss, gradient and Adam from ``params``: each
    step's loss (a tensor, one value a member where the loss has a member
    axis), the first step's gradients and the parameters after the last
    step."""
    p = {k: v.detach().clone() for k, v in params.items()}
    opt = Adam(p, lr)
    acc = None
    losses = []
    for t in range(steps):
        leaves = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        loss = loss_fn(leaves)
        grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        grads = dict(zip(leaves, grads))
        if acc is not None and loss_fn.accumulates:
            grads = {k: g + acc[k] for k, g in grads.items()}
        acc = grads
        if t == 0:
            first = {k: g.detach().clone() for k, g in grads.items()}
        losses.append(loss.detach())
        opt.step(p, grads)
    return {"losses": torch.stack(losses), "grads": first, "params": p}


# ---------------------------------------------------------------------------
# GGAD
# ---------------------------------------------------------------------------

class GGAD:
    """GGAD's encoder, outlier generation, head and three-term loss
    (arXiv:2402.11887 §3-4; ``run.py:96-210``, ``model.py:115-182``):

        Â       = D^-1/2 A D^-1/2 + I,  raw = A + I
        h1      = PReLU(Â (x W1ᵀ) + b1),  emb = PReLU(Â (h1 W2ᵀ) + b2)
        emb_con = ReLU((Â emb)[seeds] W4ᵀ)   generated outliers
        logits  = head([emb[normals] ‖ emb_con])
        emb'    = emb with the seed rows replaced by emb_con
        aff[j]  = Σ_i raw_ij cos(emb'_i, emb'_j) / Σ_i raw_ij
        loss    = BCE(logits; normals 0, generated 1)
                  + max(0, margin − (mean aff[normals] − mean aff[seeds]))
                  + mean_h sqrt(Σ_s (emb_con − (emb[seeds] + noise))²)
    """

    def __init__(self, graph, cfg: dict, device):
        a = sp.csr_matrix(graph.adj, dtype=np.float32)
        n = a.shape[0]
        self.device = device
        self.cfg = cfg
        ahat = (sym_normalize(a) + sp.eye(n, dtype=np.float32)).tocsr()
        raw = (a + sp.eye(n, dtype=np.float32)).tocsc()
        self.ahat = Operator(ahat, device)
        seeds = np.asarray(graph.seed_idx, np.int64)
        normals = np.asarray(graph.normal_idx, np.int64)
        self.seed_rows = Operator(ahat[seeds], device) if len(seeds) else None
        labeled = np.concatenate([normals, seeds])
        uniq, pos = np.unique(labeled, return_inverse=True)
        # the labeled columns of raw, as rows: (rawᵀ)[uniq] @ N holds
        # Σ_i raw_iu N_i for each labeled u
        self.raw_cols_t = Operator(raw[:, uniq].T, device)
        den = np.asarray(raw[:, uniq].sum(0)).ravel().astype(np.float32)
        self.inv_den = torch.from_numpy(
            np.where(den != 0, 1.0 / np.maximum(den, 1e-30), 0.0)
            .astype(np.float32)).to(device)
        t = lambda v: torch.from_numpy(np.asarray(v, np.int64)).to(device)
        self.uniq, self.pos = t(uniq), t(pos.ravel())
        self.normals, self.seeds = t(normals), t(seeds)
        self.n_normal = len(normals)
        self.x = torch.from_numpy(graph.features).to(device)

    def encode(self, p: dict, precision: str) -> torch.Tensor:
        h1 = prelu(self.ahat @ linear(self.x, p["gcn1.fc.weight"], precision)
                   + p["gcn1.bias"], p["gcn1.prelu.alpha"])
        return prelu(self.ahat @ linear(h1, p["gcn2.fc.weight"], precision)
                     + p["gcn2.bias"], p["gcn2.prelu.alpha"])

    def head(self, p: dict, z: torch.Tensor, precision: str) -> torch.Tensor:
        z = torch.relu(linear(z, p["head.fc1.weight"], precision))
        z = torch.relu(linear(z, p["head.fc2.weight"], precision))
        return linear(z, p["head.fc3.weight"], precision)

    @torch.no_grad()
    def scores(self, p: dict, precision: str = "f32") -> torch.Tensor:
        return self.head(p, self.encode(p, precision), precision)[:, 0]

    def loss(self, p: dict, noise: torch.Tensor, precision: str = "f32",
             fault: str | None = None) -> torch.Tensor:
        cfg = self.cfg
        emb = self.encode(p, precision)
        emb_abnormal = emb[self.seeds] + noise
        emb_con = torch.relu(linear(self.seed_rows @ emb, p["fc4.weight"],
                                    precision))
        logits = self.head(p, torch.cat([emb[self.normals], emb_con]),
                           precision)
        labels = torch.cat([torch.zeros(self.n_normal, 1, device=emb.device),
                            torch.ones(len(self.seeds), 1,
                                       device=emb.device)])
        if fault == "half_batch":
            logits, labels = logits[::2], labels[::2]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        w = float(cfg["pos_weight"])
        bce = ((1 - labels) * F.softplus(logits)
               + w * labels * F.softplus(-logits)).mean()
        emb = emb.index_copy(0, self.seeds, emb_con)
        n = l2_normalize(emb)
        num = (n[self.uniq] * (self.raw_cols_t @ n)).sum(1)
        aff = (num * self.inv_den)[self.pos]
        margin = torch.clamp(float(cfg["confidence_margin"])
                             - (aff[:self.n_normal].mean()
                                - aff[self.n_normal:].mean()), min=0.0)
        rec = (emb_con - emb_abnormal).square().sum(0).sqrt().mean()
        return margin + bce + rec

    def train(self, p: dict, noises: list, precision: str = "f32",
              fault: str | None = None, steps: int = 3) -> dict:
        it = iter(noises)

        def loss_fn(leaves):
            return self.loss(leaves, next(it), precision, fault)

        loss_fn.accumulates = False
        return train_readings(loss_fn, p, float(self.cfg["lr"]), steps)


# ---------------------------------------------------------------------------
# TAM
# ---------------------------------------------------------------------------

class TAM:
    """TAM's members (arXiv:2306.00006; ``tam.py``, ``model_tam.py``,
    ``utils_tam.py``). Member m is the m-th of ``cutting`` successive NSGT
    cuts of A + I: in each row i, with d_e = ‖x_row − x_col‖ over the live
    edges, mean d̄ over all live edges and u_i the round's uniform draw,
    the edges with d_e > d̄ + (max_i d − d̄)·u_i are cut where max_i d > d̄,
    then the graph is made symmetric by union. Each member is a 2-layer
    GCN (f → 2h → h, PReLU) on its cut graph, normalised D^-1/2 V D^-1/2
    by column sums, trained by Adam on

        loss_m = − Σ_{j ∈ normals} minmax(aff_m)[j],
        aff_m[j] = Σ_i raw_ij cos(emb_i, emb_j) / Σ_i raw_ij,

    with the gradients summed over epochs, never zeroed (``tam.py:180``).
    """

    def __init__(self, graph, cfg: dict, device):
        a = sp.csr_matrix(graph.adj, dtype=np.float32)
        n = a.shape[0]
        raw = (a + sp.eye(n, dtype=np.float32)).tocsr()
        raw.sort_indices()
        self.cfg, self.device, self.n = cfg, device, n
        row = np.repeat(np.arange(n, dtype=np.int64), np.diff(raw.indptr))
        col = raw.indices.astype(np.int64)
        key = row * n + col
        perm = np.searchsorted(key, col * n + row)   # edge (c, r) of (r, c)
        t = lambda v: torch.from_numpy(v).to(device)
        self.row, self.col, self.perm = t(row), t(col), t(perm)
        self.raw = Operator(raw, device)               # symmetric: rawᵀ = raw
        self.inv_den = t((1.0 / np.asarray(raw.sum(0)).ravel())
                         .astype(np.float32))
        self.x = t(graph.features)
        self.normals = t(np.asarray(graph.normal_idx, np.int64))

    @torch.no_grad()
    def cuts(self, draws: torch.Tensor) -> list:
        """Each member's cut edge values (1 kept, 0 cut) in raw's CSR
        order, from the uniform draws ``[members, N]``."""
        row, col = self.row, self.col
        d = (self.x[row] - self.x[col]).square().sum(1).sqrt()
        v = torch.ones_like(d)
        out = []
        for u in draws:
            live = v != 0
            mean = torch.where(live, d, 0.0).sum() / live.sum().clamp_min(1)
            row_max = torch.full((self.n,), -torch.inf, device=d.device)
            row_max = row_max.scatter_reduce(
                0, row, torch.where(live, d, -torch.inf), "amax")
            row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
            thresh = mean + (row_max - mean) * u
            cut = live & (row_max > mean)[row] & (d > thresh[row])
            v = torch.where(cut, 0.0, v)
            v = torch.maximum(v, v[self.perm])
            out.append(v)
        return out

    def member_operator(self, v: torch.Tensor) -> Operator:
        keep = (v != 0).cpu().numpy()
        r = self.row.cpu().numpy()[keep]
        c = self.col.cpu().numpy()[keep]
        m = sp.csr_matrix((v.cpu().numpy()[keep], (r, c)),
                          shape=(self.n, self.n))
        deg = np.asarray(m.sum(0)).ravel()
        inv = np.zeros_like(deg)
        inv[deg > 0] = deg[deg > 0] ** -0.5
        d = sp.diags(inv.astype(np.float32))
        return Operator(d @ m @ d, self.device)

    def member_loss(self, op: Operator, p: dict, precision: str,
                    fault: str | None) -> torch.Tensor:
        h1 = prelu(op @ linear(self.x, p["gcn1.fc.weight"], precision)
                   + p["gcn1.bias"], p["gcn1.prelu.alpha"])
        emb = prelu(op @ linear(h1, p["gcn2.fc.weight"], precision)
                    + p["gcn2.bias"], p["gcn2.prelu.alpha"])
        n = l2_normalize(emb)
        aff = (n * (self.raw @ n)).sum(1) * self.inv_den
        lo, hi = aff.min(), aff.max()
        mm = (aff - lo) / (hi - lo).clamp_min(1e-12)
        normals = self.normals
        if fault == "half_batch":
            normals = normals[::2]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        return -mm[normals].sum()

    def train(self, p: dict, draws: torch.Tensor, precision: str = "f32",
              fault: str | None = None, steps: int = 3) -> dict:
        """Member by member: ``losses [steps, M]``, the first step's
        gradients and the parameters after ``steps``, stacked on the member
        axis as the program stacks them."""
        per = []
        for m, v in enumerate(self.cuts(draws)):
            op = self.member_operator(v)

            def loss_fn(leaves, op=op):
                return self.member_loss(op, leaves, precision, fault)

            loss_fn.accumulates = True
            pm = {k: w[m] for k, w in p.items()}
            per.append(train_readings(loss_fn, pm, float(self.cfg["lr"]),
                                      steps))
        return {"losses": torch.stack([r["losses"] for r in per], 1),
                "grads": {k: torch.stack([r["grads"][k] for r in per])
                          for k in p},
                "params": {k: torch.stack([r["params"][k] for r in per])
                           for k in p}}

    @torch.no_grad()
    def member_nnz(self, draws: torch.Tensor) -> list:
        return [int((v != 0).sum()) for v in self.cuts(draws)]
