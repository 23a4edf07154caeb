"""YAML config system with grid search and multi-run aggregation
(counterpart of ``ggad_tpu/train/config.py``).

It re-designs the reference's ``src/main.py:35-148`` and
``src/dgraph.yml``: any list-valued key expands into a hyperparameter
meshgrid; ``multi_run`` runs every combination and reports mean ± std
(ddof=1) of F1-macro / F1-pos / F1-neg / AUROC / G-mean, the reference's
aggregate set. PyYAML is imported by :func:`load_config` alone, so nothing
else of the port needs it.
"""

from __future__ import annotations

import itertools
from typing import Callable

import numpy as np

DEFAULT_CONFIG = {
    # the keys of the reference's src/dgraph.yml
    "data_name": "dgraphfin",
    "data_dir": "./dataset/",
    "test_ratio": 0.67,
    "save_dir": "./checkpoints/",
    "model": "GCN",          # GCN | SAGE | PCGNN
    "emb_size": 64,
    "thres": 0.4,
    "rho": 0.5,
    "seed": 72,
    "lr": 1e-3,
    "weight_decay": 0.007,
    "batch_size": 150,
    "num_epochs": 1500,
    "valid_epochs": 5,
    "alpha": 2,
}


def load_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    out = dict(DEFAULT_CONFIG)
    out.update(cfg or {})
    return out


def grid(config: dict) -> list[dict]:
    """Expand list-valued keys into a full meshgrid of configs
    (reference ``grid``, ``src/main.py:111-148``)."""
    listy = {k: v for k, v in config.items() if isinstance(v, list)}
    fixed = {k: v for k, v in config.items() if not isinstance(v, list)}
    if not listy:
        return [dict(config)]
    keys = list(listy)
    out = []
    for combo in itertools.product(*(listy[k] for k in keys)):
        c = dict(fixed)
        c.update(dict(zip(keys, combo)))
        out.append(c)
    return out


def run_name(config: dict, varied_keys) -> str:
    return "_".join(f"{k}_{config[k]}" for k in varied_keys) or "single"


METRIC_KEYS = ("f1_macro", "f1_pos", "f1_neg", "auc", "gmean")


def multi_run(config: dict, run_fn: Callable[[dict], dict],
              verbose: bool = True) -> dict:
    """Run every grid combo through ``run_fn`` (which returns a metric
    dict) and aggregate mean ± std (ddof=1 like the reference,
    ``src/main.py:64-68``)."""
    combos = grid(config)
    varied = [k for k, v in config.items() if isinstance(v, list)]
    results = []
    for i, cnf in enumerate(combos):
        name = run_name(cnf, varied)
        if verbose:
            print(f"[multi_run {i + 1}/{len(combos)}] {name}")
        metrics = run_fn(cnf)
        metrics["run"] = name
        results.append(metrics)

    agg = {"runs": results, "n": len(results)}
    for key in METRIC_KEYS:
        vals = [r[key] for r in results if key in r]
        if vals:
            agg[f"{key}_mean"] = float(np.mean(vals))
            agg[f"{key}_std"] = float(np.std(vals, ddof=1)) \
                if len(vals) > 1 else 0.0
    if verbose:
        for key in METRIC_KEYS:
            if f"{key}_mean" in agg:
                print(f"{key}: {agg[f'{key}_mean']:.4f}"
                      f" ± {agg[f'{key}_std']:.4f}")
    return agg
