"""Training history (mirror of ``train/callbacks.py``).

The reference persists the Keras history dict every epoch; ``HistoryLogger``
writes the same per-epoch JSON as the JAX package's, so either package
reads the other's ``history.json``.
"""

from __future__ import annotations

import json
import os

__all__ = ["HistoryLogger"]


class HistoryLogger:
    """Per-epoch metrics, rewritten to ``path`` after every epoch when ``write``
    (a job of several processes writes from rank 0 alone)."""

    def __init__(self, path: str, write: bool = True):
        self.path = path
        self.write = write
        self.history: dict[str, list] = {}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    self.history = json.load(f)
            except (json.JSONDecodeError, OSError):
                self.history = {}

    def log_epoch(self, epoch: int, metrics: dict[str, float]) -> None:
        self.history.setdefault("epoch", []).append(epoch)
        for k, v in metrics.items():
            self.history.setdefault(k, []).append(v)
        if not self.write:
            return
        with open(self.path, "w") as f:
            json.dump(self.history, f, indent=2)

    def as_dict(self) -> dict:
        return dict(self.history)
