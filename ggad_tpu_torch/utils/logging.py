"""Structured jsonl metric logging (counterpart of
``ggad_tpu/utils/logging.py``): each record is one json line with a
wall-clock timestamp, for ``cli.py --log_jsonl``. JAX's ``StepTimer`` has
no counterpart: ``utils.tracing`` times the port's stages."""

from __future__ import annotations

import json
import os
import time


class JsonlLogger:
    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a", buffering=1)

    def log(self, record: dict) -> None:
        rec = dict(record)
        rec.setdefault("ts", time.time())
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._fh.close()
