"""Structured jsonl metric logging and a step timer (counterpart of
``ggad_tpu/utils/logging.py``): each record is one json line with a
wall-clock timestamp, for ``cli.py --log_jsonl``."""

from __future__ import annotations

import json
import os
import time
from typing import Optional


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


class StepTimer:
    """Accumulating wall-clock timer (``ggad_tpu/utils/logging.py:33-52``,
    the reference's ``total_time`` pattern): each ``with`` block adds its
    seconds to ``total`` and one to ``count``. It reads the host clock: a
    block that only enqueues work on the card must synchronize inside to
    time it."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)
