"""Full-batch GGAD through the program's ``FullBatchTrainer``: the
``train`` loop (``train_step`` back to back, the loss read on the host
every ``log_every`` steps, as ``train()`` reads it) and the ``score``
loop (one client's back-to-back ``eval_scores()`` requests)."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import compare, graphgen, reference, roofline, weights
from portbench.drivers import Window, adam_grads, clone, sync

FIRST_STEPS = 3


class Cell:
    def __init__(self, cfg: dict, traffic: dict, device, spans):
        from ggad_tpu_torch.datasets.core import GADDataset
        from ggad_tpu_torch.train.full_batch import FullBatchTrainer

        self.cfg, self.traffic, self.device, self.spans = (
            cfg, traffic, torch.device(device), spans)
        self.loop = traffic["loop"]
        if self.loop not in ("train", "score"):
            raise ValueError(f"GGAD has no {self.loop!r} loop")
        with spans("graph"):
            self.graph = g = graphgen.load(cfg)
        empty = np.zeros(0, np.int64)
        ds = GADDataset(name=cfg["name"], adj=g.adj, features=g.features,
                        ano_labels=g.labels, idx_train=empty, idx_val=empty,
                        idx_test=empty, normal_label_idx=g.normal_idx,
                        abnormal_label_idx=g.seed_idx)
        with spans("prepare"):
            self.trainer = FullBatchTrainer(
                ds, lr=cfg["lr"], embedding_dim=cfg["embedding_dim"],
                noise_mean=cfg["noise_mean"], noise_std=cfg["noise_std"],
                confidence_margin=cfg["confidence_margin"],
                pos_weight=cfg["pos_weight"], spmm_impl=cfg["spmm_impl"],
                spmm_dtype=cfg["dtype"],
                log_every=int(traffic.get("log_every", 2)),
                device=self.device)
            if self.loop == "train":
                self.trainer.prepare_training()
            sync(self.device)

    def start(self, seed: int) -> None:
        """The seed's weights in the trainer; then the first three steps
        (training) or two requests (scoring), which warm every shape."""
        cfg, tr = self.cfg, self.trainer
        self.seed = seed
        self.weights = weights.make(
            weights.ggad_leaves(self.graph.features.shape[1],
                                cfg["embedding_dim"]), seed, self.device)
        tr.model.load_state_dict(self.weights)
        tr.optimizer = None
        if self.loop == "score":
            for _ in range(2):
                with self.spans("request"):
                    tr.eval_scores()
            return
        self.noise_gen = weights.generator(seed, 1, self.device)
        named = dict(tr.model.named_parameters())
        losses = []
        for t in range(FIRST_STEPS):
            with self.spans("step"):
                losses.append(tr.train_step(self.noise_gen).total)
            if t == 0:
                grads = adam_grads(tr.optimizer, named)
        with self.spans("loss_read"):
            float(losses[-1])
        self.first = {"losses": torch.stack(losses).cpu(),
                      "grads": {k: g.cpu() for k, g in grads.items()},
                      "params": {k: v.cpu() for k, v in clone(named).items()}}

    def window(self, seconds: float) -> Window:
        if self.loop == "score":
            return self._score_window(seconds)
        tr, spans = self.trainer, self.spans
        every = max(int(self.traffic.get("log_every", 2)), 1)
        steps = failed = 0
        t0 = time.perf_counter()
        while True:
            for _ in range(every):
                with spans("step"):
                    losses = tr.train_step(self.noise_gen)
            steps += every
            with spans("loss_read"):
                if not np.isfinite(float(losses.total)):
                    failed += every
            if time.perf_counter() - t0 >= seconds:
                break
        return Window(units=steps, seconds=time.perf_counter() - t0,
                      failed=failed)

    def _score_window(self, seconds: float) -> Window:
        tr, spans = self.trainer, self.spans
        lat, self.served = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            with spans("request"):
                s = tr.eval_scores()
            lat.append(time.perf_counter() - t)
            self.served.append(s)
        failed = sum(not np.all(np.isfinite(s)) for s in self.served)
        return Window(units=len(lat), seconds=time.perf_counter() - t0,
                      failed=failed, latencies_s=lat)

    # -- what the metrics read -------------------------------------------
    def work(self) -> dict:
        """Shapes and counts of one step or request, from the benchmark's
        own graph."""
        g, h = self.graph, int(self.cfg["embedding_dim"])
        n, f = g.n_nodes, g.features.shape[1]
        deg = np.diff(g.adj.indptr)
        nnz = int(g.adj.nnz) + n                       # Â = norm(A) + I
        if self.loop == "score":
            flops = roofline.ggad_score_flops(n=n, f=f, h=h, nnz=nnz)
        else:
            labeled = np.unique(np.concatenate([g.normal_idx, g.seed_idx]))
            flops = roofline.ggad_train_flops(
                n=n, f=f, h=h, nnz=nnz,
                nnz_seed=int((deg[g.seed_idx] + 1).sum()),
                n_normal=len(g.normal_idx), n_seed=len(g.seed_idx),
                nnz_sub=int((deg[labeled] + 1).sum()))
        return {"flops_per_unit": flops, "n": n, "d": h, "nnz": nnz}

    def spmm_call(self, h_cols: torch.Tensor):
        """The program's product on the cell's graph, as its step calls
        it (``ops.spmm.spmm(trainer.adj, H)``)."""
        from ggad_tpu_torch.ops.spmm import spmm

        adj = self.trainer.adj
        return lambda: spmm(adj, h_cols)

    # -- the check ---------------------------------------------------------
    def free(self) -> None:
        del self.trainer

    def reference(self) -> reference.GGAD:
        return reference.GGAD(self.graph, self.cfg, self.device)

    def readings(self, ref, precision: str = "f32", fault=None):
        """What the reference computes from this seed's inputs: the first
        steps' readings, or the scores."""
        if self.loop == "score":
            return ref.scores(self.weights, precision)
        return ref.train(self.weights, self.noises(), precision, fault,
                         FIRST_STEPS)

    def gaps(self, got, ref_out) -> dict:
        if self.loop == "score":
            return compare.score_numbers(got, ref_out)
        return compare.train_numbers(got, ref_out, self.weights)

    def produced(self):
        """What the timed path produced: the first steps' readings, or
        every request the window served."""
        return self.served if self.loop == "score" else self.first

    def noises(self) -> list:
        """The draws the first steps took: ``N(0, 1)·std + mean`` of
        ``[seeds, h]`` a step, from the noise stream the benchmark handed
        the trainer."""
        gen = weights.generator(self.seed, 1, self.device)
        cfg = self.cfg
        return [torch.randn(len(self.graph.seed_idx), cfg["embedding_dim"],
                            generator=gen, device=self.device)
                * cfg["noise_std"] + cfg["noise_mean"]
                for _ in range(FIRST_STEPS)]
