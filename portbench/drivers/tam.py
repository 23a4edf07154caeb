"""TAM through the program's ``models/tam.py``: the set-up ``run_tam``
makes for one member chunk (the cuts from the benchmark's uniform draws,
``sym_normalize_vals``, the raw graph's flat ELL tables, the route, and
on the BCSR route the block-diagonal tile pair), then the ``train`` loop:
``TAMEnsemble.step()`` over every member, back to back, as ``run_tam``
runs its epochs."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, graphgen, reference, roofline, weights
from portbench.drivers import Window, adam_grads, clone, sync

FIRST_STEPS = 3


class Cell:
    def __init__(self, cfg: dict, traffic: dict, device, spans):
        if traffic["loop"] != "train":
            raise ValueError(f"TAM has no {traffic['loop']!r} loop")
        self.cfg, self.traffic, self.device, self.spans = (
            cfg, traffic, torch.device(device), spans)
        self.members = int(cfg["cutting"]) * int(cfg["n_tree"])
        with spans("graph"):
            self.graph = graphgen.load(cfg)

    def _prepare(self) -> None:
        from ggad_tpu_torch.graph import add_self_loops, from_scipy
        from ggad_tpu_torch.models import tam
        from ggad_tpu_torch.ops.bcsr_spmm import pick_tile_rows
        from ggad_tpu_torch.ops.ell_spmm import as_ell_graph

        cfg, g, dev = self.cfg, self.graph, self.device
        raw_adj = add_self_loops(from_scipy(g.adj, device=dev))
        x = torch.as_tensor(g.features, dtype=torch.float32, device=dev)
        nidx = torch.as_tensor(g.normal_idx, dtype=torch.int64, device=dev)
        val_stack = tam.cut_stack(raw_adj, x, int(cfg["cutting"]),
                                  int(cfg["n_tree"]), self.draws)
        norm_stack = tam.sym_normalize_vals(val_stack, raw_adj)
        raw_ell = as_ell_graph(raw_adj)
        self.route = tam.tam_route(raw_adj, cfg["impl"])
        h = int(cfg["embedding_dim"])
        if self.route == "bcsr":
            row, col, _ = raw_adj.host_coo()
            tile_rows = pick_tile_rows(row, col, raw_adj.n_nodes)
            chunk = tam.member_chunk_for(raw_adj, self.route, self.members,
                                         h, tile_rows=tile_rows)
            aggregate = tam.blockdiag_aggregate(
                tam.blockdiag_pair(raw_adj, norm_stack, tile_rows),
                raw_adj.n_nodes)
        else:
            maps = tam.ell_value_map_pair(raw_ell)
            chunk = tam.member_chunk_for(raw_adj, self.route, self.members,
                                         h, ell_k=raw_ell.tables.fwd.k)
            aggregate = tam.tables_aggregate(
                tam.member_tables(raw_ell, maps, norm_stack))
        if chunk < self.members:
            raise RuntimeError(f"the program trains {chunk} of the "
                               f"{self.members} members at once; this cell "
                               f"times one chunk of all of them")
        self.ens = tam.TAMEnsemble(aggregate, x, raw_ell, nidx, self.weights,
                                   float(cfg["lr"]))

    def start(self, seed: int) -> None:
        """The seed's weights and cut draws, the set-up up to the first
        epoch, then the first three epochs, which warm every shape."""
        cfg, dev = self.cfg, self.device
        self.seed = seed
        self.weights = weights.make(
            weights.tam_leaves(self.members, self.graph.features.shape[1],
                               int(cfg["embedding_dim"])), seed, dev)
        self.draws = torch.rand(self.members, self.graph.n_nodes,
                                generator=weights.generator(seed, 2, dev),
                                device=dev)
        with self.spans("prepare"):
            self._prepare()
            sync(dev)
        ens = self.ens
        losses = []
        for t in range(FIRST_STEPS):
            with self.spans("step"):
                losses.append(ens.step()[0])
            if t == 0:
                grads = adam_grads(ens.optimizer, ens.params)
        with self.spans("sync"):
            sync(dev)
        self.first = {"losses": torch.stack(losses).cpu(),
                      "grads": {k: v.cpu() for k, v in grads.items()},
                      "params": {k: v.cpu()
                                 for k, v in clone(ens.params).items()}}

    def window(self, seconds: float) -> Window:
        from ggad_tpu_torch.ops.bcsr_spmm import bcsr_spmm

        ens, spans = self.ens, self.spans
        epochs = 0
        launches = bcsr_spmm.launches
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with spans("step"):
                loss_m, _ = ens.step()
            epochs += 1
        with spans("sync"):
            last = loss_m.cpu().numpy()
        seconds = time.perf_counter() - t0
        # the program's own count of K1 launches in the window
        self.k1_launches = bcsr_spmm.launches - launches
        failed = 0 if np.all(np.isfinite(last)) else 1
        return Window(units=epochs, seconds=seconds, failed=failed)

    # -- what the metrics read -------------------------------------------
    def member_nnz(self) -> list:
        """Each member's stored entries, from the reference's own cuts of
        the seed's draws."""
        if not hasattr(self, "_member_nnz"):
            self._member_nnz = self.reference().member_nnz(self.draws)
        return self._member_nnz

    def work(self) -> dict:
        g, h = self.graph, int(self.cfg["embedding_dim"])
        n = g.n_nodes
        nnz_raw = int(g.adj.nnz) + n
        member_nnz = self.member_nnz()
        return {"flops_per_unit": roofline.tam_epoch_flops(
                    n=n, f=g.features.shape[1], h=h, member_nnz=member_nnz,
                    nnz_raw=nnz_raw),
                "n": n, "d": h, "member_nnz": member_nnz}

    def k1_least_s(self) -> float:
        """The least time of one epoch's four K1 launches on the
        block-diagonal pair: the forward and the transposed product at
        gcn1's width 2h and gcn2's h, over the members' stored entries."""
        w = self.work()
        n, h, m = w["n"], w["d"], self.members
        nnz = sum(w["member_nnz"])
        return 2 * sum(roofline.spmm_least_s(nnz, m * n, m * n, d)
                       for d in (2 * h, h))

    # -- the check ---------------------------------------------------------
    def free(self) -> None:
        del self.ens

    def reference(self) -> reference.TAM:
        return reference.TAM(self.graph, self.cfg, self.device)

    def readings(self, ref, precision: str = "f32", fault=None) -> dict:
        return ref.train(self.weights, self.draws, precision, fault,
                         FIRST_STEPS)

    def gaps(self, got, ref_out) -> dict:
        return compare.train_numbers(got, ref_out, self.weights,
                                     members=True)

    def produced(self) -> dict:
        return self.first
