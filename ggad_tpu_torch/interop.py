"""Weights across the two packages: a flax parameter tree ⇄ the port's
``state_dict``.

The tree is a nested dict of numpy arrays, the ``params`` collection of
``ggad_tpu.models.ggad.GGAD.init`` (names as in
``tests/test_ggad_fullbatch.py:27-47``), of
``ggad_tpu.models.sage.MiniBatchGGAD.init``, of a baseline of the zoo
(``Dominant``, ``AnomalyDAE``, ``OCGNNEncoder``, ``AEGIS``, ``GAAN``) or
of a minibatch baseline (``GraphSAGEClassifier``, ``PCGNN``,
``MiniBatchRecon``, ``MiniBatchAEGIS``), with or without the outer
``{"params": ...}``. Flax's ``kernel`` (a dense
layer's, a GAT's, a bilinear critic's) is ``[in, out]``; the port's
``weight`` is ``[out, in]``. Only the last two axes swap, so a stacked
tree (TAM's ensemble: ``[M, in, out]`` kernels, ``[M, out]`` biases,
``[M]`` alphas, one leading member axis on every leaf) maps to stacked
``[M, out, in]`` weights. Every other leaf (``bias``, ``alpha``, a
GAT's ``att_src``/``att_dst``, a PyG MLP's ``bn_scale``/``bn_bias``, and
the minibatch models' ``w_*`` matrices (``w_enc``, ``w_score``,
``w_cls``, ``w_inter``, PC-GNN's ``w_r0``…), which the port keeps
``[in, out]``) keeps its name and shape.
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
                key, arr = "weight", np.swapaxes(arr, -1, -2)
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
            key, arr = "kernel", np.array(np.swapaxes(arr, -1, -2),
                                          order="C")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[key] = arr
    return {"params": tree}


def as_state_dict(params: Mapping, device) -> dict[str, torch.Tensor]:
    """``params`` (a flax tree of arrays or a ``state_dict``) as float32
    tensors on ``device``."""
    if any(isinstance(v, Mapping) for v in params.values()):
        params = params_from_flax(params)
    return {k: torch.as_tensor(v, dtype=torch.float32).to(device)
            for k, v in params.items()}
