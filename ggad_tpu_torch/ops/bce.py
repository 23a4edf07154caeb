"""torch-faithful binary cross-entropy on probabilities (counterpart of
``ggad_tpu/ops/bce.py``).

The reference's adversarial baselines (``model_gaan.py:263-270``,
``model_AEGIS.py:223-225``) call ``torch.nn.functional.binary_cross_entropy``
itself, so the port calls it too: the elementwise log is clamped at -100
(no probability clip),

    loss_i = -[ y_i · max(log p_i, -100) + (1-y_i) · max(log(1-p_i), -100) ]

and the backward is ``(p - y) / max(p(1-p), 1e-12)``, finite at p = 0 and
p = 1 exactly. The JAX package rebuilds both with a custom VJP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bce_probs(p: torch.Tensor, y) -> torch.Tensor:
    """Elementwise BCE on probabilities (no reduction); ``y`` is a constant
    target (a number or a tensor broadcastable to ``p``) and takes no
    gradient."""
    target = torch.broadcast_to(torch.as_tensor(y, dtype=p.dtype,
                                                device=p.device), p.shape)
    return F.binary_cross_entropy(p, target, reduction="none")
