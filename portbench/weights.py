"""Seeded weights, made on the device in one draw.

Each leaf is named as the program's ``state_dict`` names it and is one of
three kinds: ``xavier`` (Xavier-uniform over its last two axes, the
init of the papers' linear layers), ``zeros`` (biases) or ``prelu``
(PReLU's slope, 0.25). A leading axis, where given, stacks members.
"""

from __future__ import annotations

import math

import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one stream of the run's draws
    (0 weights, 1 noise, 2 cuts)."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 4 + stream) & SEED_MASK)


def make(leaves: list, seed: int, device) -> dict[str, torch.Tensor]:
    """``leaves``: ``(name, shape, kind)``; float32 tensors on ``device``
    from one uniform draw for every Xavier leaf."""
    sizes = [math.prod(shape) for _, shape, kind in leaves
             if kind == "xavier"]
    u = torch.rand(sum(sizes), generator=generator(seed, 0, device),
                   device=device)
    out, pos = {}, 0
    for name, shape, kind in leaves:
        if kind == "xavier":
            n = math.prod(shape)
            bound = math.sqrt(6.0 / (shape[-1] + shape[-2]))
            out[name] = (u[pos:pos + n].view(shape) * 2 - 1) * bound
            pos += n
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "prelu":
            out[name] = torch.full(shape, 0.25, device=device)
        else:
            raise ValueError(f"unknown leaf kind {kind!r}")
    return out


def ggad_leaves(f: int, h: int) -> list:
    """GGAD's parameters (``models/ggad.py``: gcn1, gcn2, the head
    h → h/2 → h/4 → 1, fc4)."""
    return [("gcn1.fc.weight", (h, f), "xavier"), ("gcn1.bias", (h,), "zeros"),
            ("gcn1.prelu.alpha", (), "prelu"),
            ("gcn2.fc.weight", (h, h), "xavier"), ("gcn2.bias", (h,), "zeros"),
            ("gcn2.prelu.alpha", (), "prelu"),
            ("head.fc1.weight", (h // 2, h), "xavier"),
            ("head.fc2.weight", (h // 4, h // 2), "xavier"),
            ("head.fc3.weight", (1, h // 4), "xavier"),
            ("fc4.weight", (h, h), "xavier")]


def tam_leaves(members: int, f: int, h: int) -> list:
    """TAM's stacked member parameters (``models/tam.py``: gcn1 f → 2h,
    gcn2 2h → h, a member axis first)."""
    m = members
    return [("gcn1.fc.weight", (m, 2 * h, f), "xavier"),
            ("gcn1.bias", (m, 2 * h), "zeros"),
            ("gcn1.prelu.alpha", (m,), "prelu"),
            ("gcn2.fc.weight", (m, h, 2 * h), "xavier"),
            ("gcn2.bias", (m, h), "zeros"),
            ("gcn2.prelu.alpha", (m,), "prelu")]
