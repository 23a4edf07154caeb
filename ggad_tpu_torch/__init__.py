"""ggad_tpu_torch — the PyTorch/CUDA port of ``ggad_tpu`` for NVIDIA Hopper.

The package mirrors ``ggad_tpu``'s layout and names so that each module has
an obvious counterpart. It imports ``torch`` and never ``jax`` nor anything
of ``ggad_tpu``. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card and without an explicit device it raises.

It carries single-device full-batch GGAD: dataset, graph preparation
(with RCM reordering), the model (gcn2 through the hand-written BCSR SpMM
kernel, forward and backward, on a tile-dense graph, and through the ELL
sigma tables on a tile-sparse one), the three-term loss (in bf16 mode on
tiles the affinity through the hand-written SDDMM kernel),
``train.full_batch.FullBatchTrainer.train``, checkpoints,
``serve.score_dataset``; single-device minibatch GGAD (the DGraph path:
``sampler``, ``models.sage``, ``train.minibatch.MiniBatchTrainer``,
``train.config``); the full-batch baseline zoo (``models.dominant``,
``anomaly_dae``, ``ocgnn``, ``aegis``, ``gaan``, run by
``train.baselines``; OCGNN's and AEGIS's GCN layers through the BCSR
kernel on a tile-dense graph); TAM (``models.tam``, run by
``train.baselines.run_tam_baseline``: the ensemble's GCN layers through
the BCSR kernel on the block-diagonal tile pair of its members, or on
shared ELL tables); and the CLI (training, ``--score_only``,
``--model ggad-minibatch``, the baselines' ``--model`` and TAM's
``--tam_split``, ``--config``).
"""

__version__ = "0.1.0"

from ggad_tpu_torch.device import resolve_device
from ggad_tpu_torch.graph import Graph, add_self_loops, from_coo, from_scipy

__all__ = ["Graph", "add_self_loops", "from_coo", "from_scipy",
           "resolve_device"]
