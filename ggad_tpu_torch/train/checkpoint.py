"""Checkpoints as ``torch.save`` files (counterpart of
``ggad_tpu/train/checkpoint.py``; orbax's format is not read).

One file per step, ``ckpt_<step>.pt``, holding a dict of tensors and
plain values. The trainer writes ``{"params": state_dict, "opt_state":
optimizer.state_dict(), "rng": generator.get_state(), "epoch": step}``;
serving reads ``"params"``.
Files are written to a temporary name and renamed, so a reader never
sees a half-written checkpoint; the newest ``MAX_TO_KEEP`` are kept, as
the JAX package's orbax manager keeps them.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")
MAX_TO_KEEP = 3


class Checkpointer:
    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any) -> None:
        tmp = self._path(step) + f".{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-MAX_TO_KEEP]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None,
                map_location: Any = "cpu") -> Optional[Any]:
        """The state saved at ``step`` (default: the latest), or None when
        the directory holds no checkpoint. Only tensors and plain
        containers are unpickled (``weights_only``)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        return torch.load(self._path(step), map_location=map_location,
                          weights_only=True)
