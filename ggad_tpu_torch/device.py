"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card: raise when there is none, never fall back
    to the CPU quietly. Pass ``device="cpu"`` to run on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the host")
        return torch.device("cuda")
    return torch.device(device)
