"""Drivers: one module a model family (``configs/*.json``'s ``model``),
each a ``Cell`` that sets the program up, starts it from a seed, runs the
traffic's loop for a window and checks what the window's path produced
against the plain reference.

A ``Cell`` has ``start(seed)``, ``window(seconds) -> Window``,
``work() -> dict`` (``flops_per_unit`` and the shapes the metric readers
count with), ``produced()`` (what the timed path produced, on the host),
``free()``, ``reference()`` (the plain reference of the cell's graph),
``readings(ref, precision, fault)`` (what it computes from the seed's
inputs) and ``gaps(got, ref_out) -> dict``, the numbers that
``checks/<workload>.json`` limits.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Window:
    units: int                     # steps, requests or epochs completed
    seconds: float                 # host clock, the last unit's end synced
    failed: int = 0
    latencies_s: list | None = None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def clone(named: dict) -> dict:
    return {k: v.detach().clone() for k, v in named.items()}


def adam_grads(opt, named: dict) -> dict:
    """The gradient each leaf gave the optimizer at its first step, from
    Adam's first moment: exp_avg = (1 − β1)·g after one step. A leaf with
    no state (the step never ran) reads a zero gradient."""
    beta1 = opt.defaults["betas"][0] if opt is not None else 0.9
    out = {}
    for k, p in named.items():
        st = opt.state.get(p, {}) if opt is not None else {}
        out[k] = (st["exp_avg"] / (1 - beta1) if "exp_avg" in st
                  else torch.zeros_like(p)).detach().clone()
    return out
