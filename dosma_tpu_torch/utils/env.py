"""Package directories (counterpart of the directory helpers of
``dosma_tpu/utils/env.py``)."""

from __future__ import annotations

import os

__all__ = ["temp_dir"]

_DOSMA_DIR = os.path.expanduser("~/.dosma_tpu_torch")


def temp_dir() -> str:
    """Scratch directory: ``$DOSMA_TEMP_DIR``, else ``~/.dosma_tpu_torch/temp``."""
    path = os.environ.get("DOSMA_TEMP_DIR", os.path.join(_DOSMA_DIR, "temp"))
    os.makedirs(path, exist_ok=True)
    return path
