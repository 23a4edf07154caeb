"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference computes from the same inputs.

Training (one model, or a stack of members on a leading axis, each
member's slice of a leaf counted as a leaf of its own):

* ``loss_gap``: the largest |L − L_ref| / |L_ref| over the first three
  steps (and members);
* ``grad_gap``: over leaves, the largest gap between the norms of the
  first step's gradient (the program's worked out from its Adam state)
  and the reference's, over the larger of the reference leaf's norm and
  the median leaf's;
* ``change_gap``: the same for the parameters' change over the three
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

Scoring: ``score_gap``, the largest |s − s_ref| over every node of every
request compared, over the largest |s_ref|.
"""

from __future__ import annotations

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64)


def _leaves(tree: dict, members: bool) -> dict:
    out = {}
    for k, v in tree.items():
        v = _np(v)
        if members:
            for m in range(v.shape[0]):
                out[(k, m)] = v[m]
        else:
            out[k] = v
    return out


def _norms(tree: dict) -> dict:
    return {k: float(np.linalg.norm(v.ravel())) for k, v in tree.items()}


def _worst(got: dict, ref: dict, keys) -> float:
    keys = list(keys)
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def train_numbers(prog: dict, ref: dict, p0: dict, *,
                  members: bool = False) -> dict:
    """``prog``/``ref``: ``losses`` ``[steps(, M)]``, ``grads`` (the
    first step's) and ``params`` (after the steps); ``p0`` the weights
    both started from."""
    lp, lr = _np(prog["losses"]), _np(ref["losses"])
    loss_gap = float(np.max(np.abs(lp - lr) / np.maximum(np.abs(lr), 1e-30)))
    gp = _norms(_leaves(prog["grads"], members))
    gr = _norms(_leaves(ref["grads"], members))
    start = _leaves(p0, members)
    dp = _norms({k: v - start[k]
                 for k, v in _leaves(prog["params"], members).items()})
    dr = _norms({k: v - start[k]
                 for k, v in _leaves(ref["params"], members).items()})
    med = float(np.median(list(gr.values())))
    moved = [k for k in gr if gr[k] >= 1e-3 * med]
    return {"loss_gap": loss_gap, "grad_gap": _worst(gp, gr, gr),
            "change_gap": _worst(dp, dr, moved),
            "leaves_left_out": len(gr) - len(moved)}


def score_numbers(requests: list, ref) -> dict:
    r = _np(ref)
    scale = max(float(np.max(np.abs(r))), 1e-30)
    gap = max((float(np.max(np.abs(_np(s) - r))) for s in requests),
              default=float("inf"))
    return {"score_gap": gap / scale}
