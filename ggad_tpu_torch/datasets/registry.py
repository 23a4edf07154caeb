"""Per-dataset hyperparameter presets (counterpart of
``ggad_tpu/datasets/registry.py``).

The reference hardcodes per-dataset defaults across its run scripts
(``run.py:38-66``), including two quirks reproduced deliberately:

  * the outlier-seed fraction is 0.05 for Amazon and 0.15 for every other
    dataset (``utils.py:137-140``);
  * feature row-normalization is applied to
    ``['Amazon', 'tf_finace', 'reddit', 'elliptic']`` (``run.py:87``) — the
    ``tf_finace`` misspelling means t_finance features are NOT
    row-normalized.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DatasetPreset:
    name: str
    lr: float = 1e-3
    num_epoch: int = 300
    noise_mean: float = 0.0
    noise_std: float = 0.0      # "var" in the reference CLI (run.py:61-66)
    seed_frac: float = 0.15     # outlier-seed fraction of labeled normals
    row_normalize: bool = False
    weight_decay: float = 0.0
    embedding_dim: int = 300


DATASET_PRESETS = {
    # reference run.py:38-66 + utils.py:137-140
    "photo": DatasetPreset("photo", num_epoch=100, noise_mean=0.02,
                           noise_std=0.01),
    "reddit": DatasetPreset("reddit", num_epoch=300, noise_mean=0.02,
                            noise_std=0.01, row_normalize=True),
    "elliptic": DatasetPreset("elliptic", num_epoch=150, row_normalize=True),
    "t_finance": DatasetPreset("t_finance", num_epoch=500,
                               row_normalize=False),  # tf_finace typo quirk
    "Amazon": DatasetPreset("Amazon", num_epoch=800, seed_frac=0.05,
                            row_normalize=True),
}

_DEFAULT = DatasetPreset("default", num_epoch=100)


def preset_for(name: str) -> DatasetPreset:
    if name in DATASET_PRESETS:
        return DATASET_PRESETS[name]
    if name.startswith("synthetic_"):
        base = name[len("synthetic_"):]
        if base in DATASET_PRESETS:
            return DATASET_PRESETS[base]
    return dataclasses.replace(_DEFAULT, name=name)
