"""Weights across the two packages: a flax parameter tree ⇄ the port's
``state_dict``.

The tree is a nested dict of numpy arrays, the ``params`` collection of
``ggad_tpu.models.ggad.GGAD.init`` (names as in
``tests/test_ggad_fullbatch.py:27-47``), with or without the outer
``{"params": ...}``. Flax's dense ``kernel`` is ``[in, out]``; the port's
``weight`` is ``[out, in]``. Every other leaf (``bias``, ``alpha``) keeps
its name and shape.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a flax ``params`` tree into a float32 CPU ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        for key, child in node.items():
            if isinstance(child, Mapping):
                walk(child, prefix + [key])
                continue
            arr = np.asarray(child, dtype=np.float32)
            if key == "kernel":
                key, arr = "weight", arr.T
            out[".".join(prefix + [key])] = torch.from_numpy(
                np.array(arr, order="C"))

    walk(tree, [])
    return out


def params_to_flax(state: Mapping[str, torch.Tensor]) -> dict:
    """The reverse of :func:`params_from_flax`: ``{"params": tree}`` of
    numpy arrays."""
    tree: dict = {}
    for name, tensor in state.items():
        *path, key = name.split(".")
        arr = tensor.detach().cpu().numpy()
        if key == "weight":
            key, arr = "kernel", np.array(arr.T, order="C")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[key] = arr
    return {"params": tree}
