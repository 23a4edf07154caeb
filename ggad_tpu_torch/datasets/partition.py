"""Balanced graph partitioning for the halo path (counterpart of
``ggad_tpu/datasets/partition.py``; host-side numpy/scipy).

The halo path gives each shard a contiguous block of rows, so its wire
volume is set by how well the node order follows the graph's locality.
Renumbering the nodes so each part is one block shrinks the boundary:

  1. graph growing: each part grows by BFS from a high-degree free node
     until it holds N/D nodes;
  2. refinement: capacity-bounded asynchronous label propagation, each
     node moving to its neighbours' majority part while the balance
     allows.

:func:`multilevel_partition` coarsens by heavy-edge matching first and
refines at every level on the way back. The two scalar loops (refinement
and matching) run in the port's host library (``csrc/graphbuild.cpp``:
``gg_partition_refine``, ``gg_hem_match``, through ``native``) whenever a
C++ compiler is present. On a host without one they take their Python
copies (:func:`partition_refine_python`, :func:`hem_match_python`), with
the same xorshift generator and float32 sums, so both routes give equal
partitions; the copies take O(E) Python steps a round.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import scipy.sparse as sp

from ggad_tpu_torch import native

_MASK = (1 << 64) - 1


def _xorshift(seed: int):
    """The C++ helpers' generator: xorshift64 (13, 7, 17)."""
    s = seed if seed else 0x9E3779B97F4A7C15

    def nxt() -> int:
        nonlocal s
        s ^= (s << 13) & _MASK
        s ^= s >> 7
        s ^= (s << 17) & _MASK
        return s

    return nxt


def _shuffle(order: list, nxt) -> None:
    for i in range(len(order) - 1, 0, -1):
        j = nxt() % (i + 1)
        order[i], order[j] = order[j], order[i]


def partition_refine(indptr, indices, part, n_parts: int, cap: int,
                     rounds: int = 10, seed: int = 1, weights=None,
                     node_w=None) -> np.ndarray:
    """:func:`partition_refine_python`'s labels, from the host library
    when ``native.available()``."""
    fn = (native.partition_refine if native.available()
          else partition_refine_python)
    return fn(indptr, indices, part, n_parts, cap, rounds=rounds, seed=seed,
              weights=weights, node_w=node_w)


def hem_match(indptr, indices, weights=None, seed: int = 1) -> np.ndarray:
    """:func:`hem_match_python`'s matching, from the host library when
    ``native.available()``."""
    fn = native.hem_match if native.available() else hem_match_python
    return fn(indptr, indices, weights=weights, seed=seed)


def partition_refine_python(indptr, indices, part, n_parts: int, cap: int,
                            rounds: int = 10, seed: int = 1, weights=None,
                            node_w=None) -> np.ndarray:
    """Capacity-bounded asynchronous label propagation
    (``gg_partition_refine``): each round visits the nodes in a fresh
    random order and moves a node to the part its edges weigh most toward
    (ties to the current part, then to the part seen first) while that
    part stays within ``cap`` node weight. Stops after a round with no
    move."""
    part = np.array(part, np.int32)
    n = len(part)
    indptr = np.asarray(indptr, np.int64).tolist()
    indices = np.asarray(indices, np.int64).tolist()
    w = (np.asarray(weights, np.float32).tolist() if weights is not None
         else None)
    nw = (np.asarray(node_w, np.int64).tolist() if node_w is not None
          else [1] * n)
    sizes = [0] * n_parts
    p_list = part.tolist()
    for i in range(n):
        sizes[p_list[i]] += nw[i]
    f32 = np.float32
    nxt = _xorshift(seed)
    order = list(range(n))
    for _ in range(rounds):
        _shuffle(order, nxt)
        moved = 0
        for i in order:
            p = p_list[i]
            counts: dict = {}     # insertion order = first touch
            for e in range(indptr[i], indptr[i + 1]):
                q = p_list[indices[e]]
                # float32 adds, as the C++ accumulates
                counts[q] = float(f32(counts.get(q, 0.0)
                                      + (w[e] if w is not None else 1.0)))
            best, best_c = p, counts.get(p, 0.0)
            for q, c in counts.items():
                if q != p and c > best_c and sizes[q] + nw[i] <= cap:
                    best, best_c = q, c
            if best != p:
                p_list[i] = best
                sizes[p] -= nw[i]
                sizes[best] += nw[i]
                moved += 1
        if moved == 0:
            break
    return np.asarray(p_list, np.int32)


def hem_match_python(indptr, indices, weights=None,
                     seed: int = 1) -> np.ndarray:
    """Heavy-edge matching (``gg_hem_match``): in a random order, each
    unmatched node is matched with its heaviest-edge unmatched neighbour
    (the first among equals); ``partner[i]`` is i itself when none is
    left."""
    indptr = np.asarray(indptr, np.int64).tolist()
    indices = np.asarray(indices, np.int64).tolist()
    w = (np.asarray(weights, np.float32).tolist() if weights is not None
         else None)
    n = len(indptr) - 1
    partner = [-1] * n
    order = list(range(n))
    _shuffle(order, _xorshift(seed))
    for i in order:
        if partner[i] != -1:
            continue
        best, best_w = -1, -1.0
        for e in range(indptr[i], indptr[i + 1]):
            j = indices[e]
            if j == i or partner[j] != -1:
                continue
            wj = w[e] if w is not None else 1.0
            if wj > best_w:
                best, best_w = j, wj
        if best != -1:
            partner[i], partner[best] = best, i
        else:
            partner[i] = i
    return np.asarray(partner, np.int32)


def _ggp_init(indptr: np.ndarray, indices: np.ndarray,
              n_parts: int, seed: int = 0,
              node_w: np.ndarray | None = None) -> np.ndarray:
    """Graph-growing initial partition: BFS over unassigned nodes until
    each part reaches its share of the total node weight."""
    n = len(indptr) - 1
    if node_w is None:
        node_w = np.ones(n, np.int64)
    target = -(-int(node_w.sum()) // n_parts)
    part = np.full(n, -1, np.int32)
    deg = np.diff(indptr)
    rng = np.random.default_rng(seed)

    for p in range(n_parts - 1):
        free = np.flatnonzero(part == -1)
        if len(free) == 0:
            break
        # seed at a high-degree unassigned node (community cores first)
        seed_node = free[int(np.argmax(deg[free]))]
        q = deque([seed_node])
        part[seed_node] = p
        filled = int(node_w[seed_node])
        while q and filled < target:
            u = q.popleft()
            for v in indices[indptr[u]:indptr[u + 1]]:
                if part[v] == -1:
                    part[v] = p
                    filled += int(node_w[v])
                    q.append(v)
                    if filled >= target:
                        break
        # disconnected graph or exhausted frontier: top up at random
        if filled < target:
            free = np.flatnonzero(part == -1)
            for v in free[rng.permutation(len(free))]:
                part[v] = p
                filled += int(node_w[v])
                if filled >= target:
                    break
    part[part == -1] = n_parts - 1
    return part


def _exact_balance(a: sp.csr_matrix, part: np.ndarray, n_parts: int,
                   block: int) -> np.ndarray:
    """Force the part sizes to exactly ``block`` (the last part takes the
    remainder) by moving the surplus nodes with the fewest edges inside
    their part to parts with room, so the fixed ceil(N/D) row blocks of
    ``partition_edges`` align with the parts."""
    n = a.shape[0]
    part = part.copy()
    want = np.full(n_parts, block, np.int64)
    want[-1] = n - block * (n_parts - 1)
    onehot = sp.csr_matrix((np.ones(n, np.float32), (np.arange(n), part)),
                           shape=(n, n_parts))
    votes = np.asarray((a @ onehot).todense())

    sizes = np.bincount(part, minlength=n_parts)
    for p in range(n_parts):
        surplus = sizes[p] - want[p]
        if surplus <= 0:
            continue
        members = np.flatnonzero(part == p)
        movers = members[np.argsort(votes[members, p])[:surplus]]
        for m in movers:
            order = np.argsort(-votes[m])
            dest = next((q for q in order
                         if q != p and sizes[q] < want[q]),
                        int(np.argmin(sizes - want)))
            part[m] = dest
            sizes[dest] += 1
            sizes[p] -= 1
    return part


def lp_partition(adj: sp.spmatrix, n_parts: int, *, rounds: int = 10,
                 slack: float = 1.02, seed: int = 0,
                 exact_block: int | None = None) -> np.ndarray:
    """Balanced partition labels ``[N]`` in ``[0, n_parts)``: graph
    growing, then capacity-bounded refinement (cap = slack · N/D).
    ``exact_block`` forces every part to exactly that size."""
    a = adj.tocsr()
    n = a.shape[0]
    part = _ggp_init(a.indptr.astype(np.int32),
                     a.indices.astype(np.int32), n_parts, seed)
    cap = int(np.ceil(slack * n / n_parts))
    part = partition_refine(a.indptr, a.indices, part, n_parts, cap,
                            rounds=rounds, seed=seed + 1)
    if exact_block is not None:
        part = _exact_balance(a, part, n_parts, exact_block)
    return part


def _spectral_init(g: sp.csr_matrix, n_parts: int,
                   node_w: np.ndarray) -> np.ndarray:
    """Recursive weight-balanced bisection by the Fiedler vector of the
    normalized Laplacian (dense, on the coarsest graph only)."""
    n = g.shape[0]
    part = np.zeros(n, np.int32)
    next_id = [0]

    def bisect(nodes: np.ndarray, k: int):
        if k == 1 or len(nodes) <= 1:
            part[nodes] = next_id[0]
            next_id[0] += 1
            return
        sub = np.asarray(g[nodes][:, nodes].todense(), np.float64)
        d = sub.sum(axis=1)
        dinv = 1.0 / np.sqrt(np.maximum(d, 1e-12))
        lap = np.eye(len(nodes)) - dinv[:, None] * sub * dinv[None, :]
        _, vecs = np.linalg.eigh(lap)
        order = np.argsort(vecs[:, 1])
        k1 = k // 2
        cum = np.cumsum(node_w[nodes][order])
        cut = int(np.searchsorted(cum, cum[-1] * k1 / k)) + 1
        cut = min(max(cut, 1), len(nodes) - 1)
        bisect(nodes[order[:cut]], k1)
        bisect(nodes[order[cut:]], k - k1)

    bisect(np.arange(n), n_parts)
    return part


def multilevel_partition(adj: sp.spmatrix, n_parts: int, *,
                         rounds: int = 10, slack: float = 1.02,
                         seed: int = 0,
                         exact_block: int | None = None) -> np.ndarray:
    """Multilevel partition: heavy-edge-matching coarsening, spectral
    bisection and weighted refinement on the coarsest graph, then
    weighted refinement at every level on the way back."""
    a = adj.tocsr().astype(np.float32)
    n0 = a.shape[0]
    min_coarse = max(40 * n_parts, 512)
    graphs = [a]
    node_ws = [np.ones(n0, np.int32)]
    maps: list[np.ndarray] = []

    while graphs[-1].shape[0] > min_coarse:
        g = graphs[-1]
        n = g.shape[0]
        partner = hem_match(g.indptr, g.indices, g.data,
                            seed=seed + 7 * len(maps) + 1)
        rep = np.minimum(np.arange(n), partner)
        uniq, cid = np.unique(rep, return_inverse=True)
        nc = len(uniq)
        if nc > 0.95 * n:          # matching stalled
            break
        coo = g.tocoo()
        cg = sp.csr_matrix((coo.data, (cid[coo.row], cid[coo.col])),
                           shape=(nc, nc))
        cg.sum_duplicates()
        cg.setdiag(0)
        cg.eliminate_zeros()
        node_ws.append(np.bincount(cid, weights=node_ws[-1],
                                   minlength=nc).astype(np.int32))
        graphs.append(cg.tocsr())
        maps.append(cid.astype(np.int64))

    cap = int(np.ceil(slack * n0 / n_parts))
    gl = graphs[-1]
    part = _spectral_init(gl, n_parts, node_ws[-1])
    part = partition_refine(gl.indptr, gl.indices, part, n_parts, cap,
                            rounds=2 * rounds, seed=seed + 101,
                            weights=gl.data, node_w=node_ws[-1])

    for lvl in range(len(maps) - 1, -1, -1):
        part = part[maps[lvl]]
        g = graphs[lvl]
        part = partition_refine(g.indptr, g.indices, part, n_parts, cap,
                                rounds=rounds, seed=seed + lvl,
                                weights=g.data, node_w=node_ws[lvl])

    if exact_block is not None:
        part = _exact_balance(a, part, n_parts, exact_block)
    return part.astype(np.int32)


def cut_fraction(adj: sp.spmatrix, part: np.ndarray) -> float:
    """Fraction of edges crossing parts (the wire-volume proxy)."""
    coo = adj.tocoo()
    return float((part[coo.row] != part[coo.col]).mean())


def partition_order(part_labels: np.ndarray) -> np.ndarray:
    """perm (new → old) placing each part's nodes contiguously."""
    return np.argsort(part_labels, kind="stable")


def reorder_lp(ds, n_parts: int, *, rounds: int = 10, seed: int = 0,
               multilevel: bool = True):
    """The dataset renumbered so the parts are contiguous row blocks of
    ``partition_edges``'s ceil(N/D) rows (part p is row block p)."""
    from ggad_tpu_torch.datasets.reorder import apply_permutation

    block = -(-ds.adj.shape[0] // n_parts)
    fn = multilevel_partition if multilevel else lp_partition
    labels = fn(ds.adj, n_parts, rounds=rounds, seed=seed,
                exact_block=block)
    return apply_permutation(ds, partition_order(labels))
