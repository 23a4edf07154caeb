from ggad_tpu_torch.datasets.core import GADDataset
from ggad_tpu_torch.datasets.loaders import load_dataset, load_mat
from ggad_tpu_torch.datasets.registry import DATASET_PRESETS, preset_for
from ggad_tpu_torch.datasets.splits import SplitResult, reference_split
from ggad_tpu_torch.datasets.synthetic import (
    photo_bench,
    synthetic_gad,
    synthetic_like,
)

__all__ = [
    "GADDataset",
    "load_dataset",
    "load_mat",
    "DATASET_PRESETS",
    "preset_for",
    "SplitResult",
    "reference_split",
    "photo_bench",
    "synthetic_gad",
    "synthetic_like",
]
