"""Command-line entry point of the port: ``python -m ggad_tpu_torch.cli``.

The routes of ``ggad_tpu.cli`` that the port has (``cli.py:97-235``):
full-batch GGAD training (the default; per-dataset defaults from the
preset registry, reference ``run.py:38-66``), ``--score_only``, which
restores ``--checkpoint_dir`` and scores the dataset, minibatch GGAD
(``--model ggad-minibatch``, the DGraph path) and its baselines
(``--model sage|pcgnn|dominant-minibatch|anomalydae-minibatch|
aegis-minibatch``), the full-batch baseline
zoo (``--model dominant|anomalydae|ocgnn|aegis|gaan``, with
``--aegis_faithful``), TAM (``--model tam``, with ``--tam_split`` /
``--no-tam_split``) and ``--config``, a YAML
config whose list-valued keys expand to a grid (``--multi_run`` runs all
of it and aggregates). All run on the card unless ``--device cpu`` is
given. ``--spmm_impl`` picks the full-batch sparse route (``auto``: BCSR
tiles on a tile-dense graph, ELL tables on a tile-sparse one) and
``--reorder`` RCM-renumbers the nodes first; JAX's names ``xla`` and
``pallas`` are taken as ``coo`` and ``bcsr``. ``--mesh_devices D`` trains
full-batch GGAD over D shards, on the halo exchange (``--dist_impl
halo``, ``--dist_schedule`` picks its wire) or the all-gather layout
(``--dist_impl gspmd``); ``--dp_devices D`` trains minibatch GGAD with
its batch axis over D shards. Either runs in one process, D shards on one
device, or under ``torchrun`` (``WORLD_SIZE`` set) one shard a rank, on
``cuda:LOCAL_RANK`` over NCCL (gloo with ``--device cpu``). The last line
of the output is one JSON record (rank 0's under ``torchrun``).
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ggad_tpu_torch training and "
                                            "scoring")
    p.add_argument("--dataset", type=str, default="synthetic",
                   help="photo|reddit|Amazon|t_finance|elliptic|dgraphfin|"
                        "synthetic|synthetic_<name>")
    p.add_argument("--model", type=str, default="ggad",
                   choices=["ggad", "ggad-minibatch", "dominant",
                            "anomalydae", "ocgnn", "aegis", "gaan", "tam",
                            "sage", "pcgnn", "dominant-minibatch",
                            "anomalydae-minibatch", "aegis-minibatch"])
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--embedding_dim", type=int, default=300)
    p.add_argument("--num_epoch", type=int, default=None)
    p.add_argument("--mean", type=float, default=None)
    p.add_argument("--var", type=float, default=None)
    p.add_argument("--negsamp_ratio", type=int, default=1)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--synthetic_scale", type=float, default=1.0,
                   help="scale factor when falling back to synthetic data")
    p.add_argument("--eval_every", type=int, default=10)
    p.add_argument("--train_auc_every", type=int, default=None,
                   help="print train-split AUROC every k epochs "
                        "(reference run.py:217-228 cadence: 2)")
    p.add_argument("--spmm_impl", type=str, default="auto",
                   choices=["auto", "coo", "bcsr", "ell", "xla", "pallas"],
                   help="xla and pallas are JAX's names of coo and bcsr")
    p.add_argument("--spmm_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--reorder", action="store_true",
                   help="RCM-reorder nodes for tile locality (it can move "
                        "a graph from the ELL route to the BCSR one)")
    p.add_argument("--log_jsonl", type=str, default=None,
                   help="write per-epoch metric records to this jsonl file")
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--config", type=str, default=None,
                   help="YAML config (list-valued keys expand to a grid)")
    p.add_argument("--multi_run", action="store_true",
                   help="run the full config grid, aggregate mean±std")
    p.add_argument("--scan_steps", type=int, default=1,
                   help="steps between host reads of the loss")
    p.add_argument("--retries", type=int, default=0,
                   help="rebuild + resume from checkpoint after a failure "
                        "(needs --checkpoint_dir)")
    p.add_argument("--score_only", action="store_true",
                   help="restore --checkpoint_dir and score the dataset")
    p.add_argument("--score_out", type=str, default=None,
                   help="write per-node scores to this .npz")
    p.add_argument("--aegis_faithful", action="store_true",
                   help="reproduce the reference AEGIS script's effective "
                        "behavior, bugs included (model_AEGIS.py:240)")
    p.add_argument("--tam_split", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="use TAM's own split protocol (80%% labeled "
                        "normals + active contamination, "
                        "utils_tam.py:159-178); --no-tam_split keeps the "
                        "GGAD split the dataset ships with")
    p.add_argument("--dp_devices", type=int, default=None,
                   help="data-parallel shard count for ggad-minibatch "
                        "(the batch axis shards; under torchrun: the world "
                        "size)")
    p.add_argument("--mesh_devices", type=int, default=None,
                   help="shard count for distributed full-batch ggad "
                        "(under torchrun: the world size)")
    p.add_argument("--dist_impl", type=str, default="halo",
                   choices=["halo", "gspmd"],
                   help="multi-device schedule for --mesh_devices: the "
                        "halo exchange or the all-gather (gspmd) layout")
    p.add_argument("--dist_schedule", type=str, default="dense",
                   choices=["dense", "ring", "sched"],
                   help="halo wire schedule: dense = one all-to-all "
                        "(global-max padding), ring = per-distance-padded "
                        "permutation rounds, sched = matched rounds "
                        "(max-weight matchings; ring pairing when they "
                        "ship no fewer rows)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the "
                        "host)")
    return p


SPMM_ALIASES = {"xla": "coo", "pallas": "bcsr"}   # ggad_tpu/cli.py:40-41


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.spmm_impl = SPMM_ALIASES.get(args.spmm_impl, args.spmm_impl)
    if args.config:
        return run_from_config(args)
    if args.score_only and args.model != "ggad":
        raise SystemExit("--score_only serves --model ggad only")
    if args.score_only and not args.checkpoint_dir:
        raise SystemExit("--score_only requires --checkpoint_dir")
    if args.dist_schedule != "dense" and args.dist_impl == "gspmd":
        # the wire schedule applies to the halo path only
        raise SystemExit(
            f"--dist_schedule {args.dist_schedule} only applies to "
            f"--dist_impl halo (gspmd lets XLA choose the collectives)")

    from ggad_tpu_torch.datasets.loaders import load_dataset

    ds = load_dataset(args.dataset, data_dir=args.data_dir, seed=args.seed,
                      synthetic_scale=args.synthetic_scale)
    if args.reorder:
        from ggad_tpu_torch.datasets.reorder import reorder_rcm
        ds = reorder_rcm(ds)
    print(f"dataset={ds.name} nodes={ds.n_nodes} edges={ds.n_edges} "
          f"feats={ds.feat_dim} anomalies={int(ds.ano_labels.sum())} "
          f"labeled_normals={len(ds.normal_label_idx)} "
          f"seeds={len(ds.abnormal_label_idx)}")
    if args.score_only:
        return score(args, ds)
    if args.model != "ggad":
        return baseline(args, ds)
    return train(args, ds)


def baseline(args, ds) -> int:
    """Any ``--model`` but ggad; ``--dp_devices`` (ggad-minibatch only)
    shards the batch axis, under ``torchrun`` over the ranks."""
    from ggad_tpu_torch.train.baselines import run_baseline

    rank = 0
    if args.dp_devices is not None:
        if args.model != "ggad-minibatch":
            raise SystemExit("--dp_devices applies to --model "
                             "ggad-minibatch only")
        args.dp_devices, args.device, rank = dist_mesh(args,
                                                       args.dp_devices)
    try:
        rec = run_baseline(args.model, ds, args)
    finally:
        close_dist(args.dp_devices)
    if rank == 0:
        print(json.dumps(rec))
    return 0


def close_dist(mesh) -> None:
    """Leave the process group that :func:`dist_mesh` joined."""
    if mesh is not None and not isinstance(mesh, int):
        import torch.distributed as dist
        dist.destroy_process_group()


def score(args, ds) -> int:
    import numpy as np

    from ggad_tpu_torch.serve import Scorer

    scorer = Scorer(args.checkpoint_dir, ds,
                    embedding_dim=args.embedding_dim,
                    spmm_impl=args.spmm_impl, spmm_dtype=args.spmm_dtype,
                    device=args.device)
    res = scorer.score()
    if args.score_out:
        np.savez(args.score_out, scores=res.scores, labels=ds.ano_labels)
    print(json.dumps({"dataset": ds.name, "model": "ggad",
                      "mode": "score_only", "ckpt_step": res.step,
                      "spmm_route": scorer.trainer.route,
                      "auc": res.auc, "ap": res.ap}))
    return 0


def train(args, ds) -> int:
    from ggad_tpu_torch.datasets.registry import preset_for
    from ggad_tpu_torch.train.full_batch import (
        FullBatchTrainer,
        train_with_retries,
    )
    from ggad_tpu_torch.utils.logging import JsonlLogger

    preset = preset_for(args.dataset)
    mesh, device, rank = dist_mesh(args, args.mesh_devices)
    logger = (JsonlLogger(args.log_jsonl) if args.log_jsonl and rank == 0
              else None)
    built = []

    def make_trainer():
        built.append(FullBatchTrainer(
            ds,
            lr=args.lr if args.lr is not None else preset.lr,
            weight_decay=args.weight_decay,
            num_epoch=args.num_epoch,
            embedding_dim=args.embedding_dim,
            noise_mean=args.mean,
            noise_std=args.var,
            pos_weight=float(args.negsamp_ratio),
            seed=args.seed,
            eval_every=args.eval_every,
            train_auc_every=args.train_auc_every,
            spmm_impl=args.spmm_impl,
            spmm_dtype=args.spmm_dtype,
            scan_steps=args.scan_steps,
            checkpoint_dir=args.checkpoint_dir,
            logger=logger.log if logger else None,
            device=device,
            mesh=mesh,
            dist_impl=args.dist_impl,
            dist_schedule=args.dist_schedule,
        ))
        return built[-1]

    try:
        res = train_with_retries(make_trainer, retries=args.retries,
                                 verbose=rank == 0)
    finally:
        if logger is not None:
            logger.close()
        close_dist(mesh)
    if rank == 0:
        print(json.dumps({"dataset": ds.name, "model": "ggad",
                          "spmm_route": built[-1].route,
                          "n_shards": args.mesh_devices or 1,
                          "auc": res.final_auc, "ap": res.final_ap,
                          "wall_time_s": res.wall_time_s}))
    return 0


def dist_mesh(args, n_shards):
    """(mesh, device, rank) of a run over ``n_shards`` (``--mesh_devices``
    or ``--dp_devices``): the shard count in one process, or, under
    ``torchrun``, the ``"dist"`` communicator of this rank (NCCL on
    ``cuda:LOCAL_RANK``, gloo with ``--device cpu``)."""
    import os

    if "WORLD_SIZE" not in os.environ or n_shards is None:
        return n_shards, args.device, 0
    import torch
    import torch.distributed as dist

    from ggad_tpu_torch.parallel.mesh import make_mesh

    world = int(os.environ["WORLD_SIZE"])
    if args.retries:
        # a retry would rebuild one rank's trainer while the others wait
        # in a collective: restart the whole job, which resumes from
        # --checkpoint_dir
        raise SystemExit("--retries is not supported under torchrun: "
                         "restart the job to resume from --checkpoint_dir")
    if n_shards != world:
        raise SystemExit(f"{n_shards} shards under torchrun need "
                         f"{n_shards} ranks, not {world}")
    if args.device == "cpu":
        device, backend = torch.device("cpu"), "gloo"
    else:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        backend = "nccl"
    dist.init_process_group(backend)
    return (make_mesh(world, comm="dist", device=device), device,
            dist.get_rank())


def run_from_config(args) -> int:
    """The YAML config route (reference ``src/main.py``): one minibatch
    GGAD run of the grid's first combination, or, with ``--multi_run``,
    every combination and their mean ± std."""
    from ggad_tpu_torch.datasets.loaders import load_dataset
    from ggad_tpu_torch.train.baselines import minibatch_trainer
    from ggad_tpu_torch.train.config import grid, load_config, multi_run

    cfg = load_config(args.config)

    def run_one(cnf: dict) -> dict:
        ds = load_dataset(cnf["data_name"], data_dir=cnf.get("data_dir"),
                          seed=cnf.get("seed", 72),
                          synthetic_scale=args.synthetic_scale)
        tr = minibatch_trainer(
            ds, split_seed=cnf.get("seed", 72),
            test_ratio=cnf.get("test_ratio", 0.67),
            emb_dim=cnf.get("emb_size", 64),
            lr=cnf.get("lr", 1e-3),
            weight_decay=cnf.get("weight_decay", 0.007),
            batch_size=cnf.get("batch_size", 150),
            num_epochs=args.num_epoch or cnf.get("num_epochs", 100),
            valid_epochs=cnf.get("valid_epochs", 5),
            thres=cnf.get("thres", 0.4),
            seed=cnf.get("seed", 72),
            device=args.device,
        )
        res = tr.train(verbose=True)
        out = dict(res.test_metrics)
        out["best_val_auc"] = res.best_val_auc
        return out

    if args.multi_run:
        agg = multi_run(cfg, run_one)
        print(json.dumps({k: v for k, v in agg.items() if k != "runs"}))
    else:
        print(json.dumps(run_one(grid(cfg)[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
