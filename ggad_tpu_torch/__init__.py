"""ggad_tpu_torch — the PyTorch/CUDA port of ``ggad_tpu`` for NVIDIA Hopper.

The package mirrors ``ggad_tpu``'s layout and names so that each module has
an obvious counterpart. It imports ``torch`` and never ``jax`` nor anything
of ``ggad_tpu``. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without an explicit device it raises.

This slice carries the serving path: dataset, graph preparation, the GGAD
eval forward (gcn1 on the hoisted Â·x, gcn2 through the hand-written BCSR
SpMM kernel, the MLP head), checkpoints, ``serve.score_dataset`` and the
``--score_only`` CLI.
"""

__version__ = "0.1.0"

from ggad_tpu_torch.device import resolve_device
from ggad_tpu_torch.graph import Graph, add_self_loops, from_coo, from_scipy

__all__ = ["Graph", "add_self_loops", "from_coo", "from_scipy",
           "resolve_device"]
