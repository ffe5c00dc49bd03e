"""Structured logging for the port (mirror of ``utils/logging.py``)."""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "image_enhance_keras_tpu_torch"


def get_logger(name: str = _ROOT) -> logging.Logger:
    """Logger under the package root; the root handler is attached once."""
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        level = os.environ.get("IEK_TPU_LOGLEVEL", "INFO").upper()
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s", "%H:%M:%S")
        )
        root.setLevel(level)
        root.addHandler(handler)
        root.propagate = False
    return logging.getLogger(name)
