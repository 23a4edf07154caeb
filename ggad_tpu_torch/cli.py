"""Command-line entry point of the port: ``python -m ggad_tpu_torch.cli``.

This slice carries the GGAD ``--score_only`` route of ``ggad_tpu.cli``
(``cli.py:79-86,120-135``): restore ``--checkpoint_dir`` and score the
dataset. It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ggad_tpu_torch scoring")
    p.add_argument("--dataset", type=str, default="synthetic",
                   help="photo|reddit|Amazon|t_finance|elliptic|dgraphfin|"
                        "synthetic|synthetic_<name>")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--embedding_dim", type=int, default=300)
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--synthetic_scale", type=float, default=1.0,
                   help="scale factor when falling back to synthetic data")
    p.add_argument("--spmm_impl", type=str, default="auto",
                   choices=["auto", "coo", "bcsr", "ell"])
    p.add_argument("--spmm_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--checkpoint_dir", type=str, default=None)
    p.add_argument("--score_only", action="store_true",
                   help="restore --checkpoint_dir and score the dataset")
    p.add_argument("--score_out", type=str, default=None,
                   help="write per-node scores to this .npz")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; 'cpu' runs on the "
                        "host)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.score_only:
        raise SystemExit("this port serves only (--score_only); training "
                         "comes with the training slice")
    if not args.checkpoint_dir:
        raise SystemExit("--score_only requires --checkpoint_dir")

    import numpy as np

    from ggad_tpu_torch.datasets.loaders import load_dataset
    from ggad_tpu_torch.serve import score_dataset

    ds = load_dataset(args.dataset, data_dir=args.data_dir, seed=args.seed,
                      synthetic_scale=args.synthetic_scale)
    print(f"dataset={ds.name} nodes={ds.n_nodes} edges={ds.n_edges} "
          f"feats={ds.feat_dim} anomalies={int(ds.ano_labels.sum())} "
          f"labeled_normals={len(ds.normal_label_idx)} "
          f"seeds={len(ds.abnormal_label_idx)}")
    res = score_dataset(args.checkpoint_dir, ds,
                        embedding_dim=args.embedding_dim,
                        spmm_impl=args.spmm_impl,
                        spmm_dtype=args.spmm_dtype, device=args.device)
    if args.score_out:
        np.savez(args.score_out, scores=res.scores, labels=ds.ano_labels)
    print(json.dumps({"dataset": ds.name, "model": "ggad",
                      "mode": "score_only", "ckpt_step": res.step,
                      "auc": res.auc, "ap": res.ap}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
