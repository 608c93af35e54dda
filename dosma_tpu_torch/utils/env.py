"""Package directories and the debug flag (counterpart of the matching
helpers of ``dosma_tpu/utils/env.py``)."""

from __future__ import annotations

import os
from typing import Optional

__all__ = ["debug", "temp_dir", "log_file_path"]

_DOSMA_DIR = os.path.expanduser("~/.dosma_tpu_torch")


def debug(value: Optional[bool] = None) -> bool:
    """Get, or set and get, debug mode (``$DOSMA_DEBUG``).

    Setting it re-levels the package logger's console handler: DEBUG when
    on, INFO when off.
    """
    if value is not None:
        if not isinstance(value, bool):
            raise ValueError("value must be a bool")
        import logging

        from dosma_tpu_torch.utils import logger as _logger

        os.environ["DOSMA_DEBUG"] = str(value)
        _logger.setup_logger.cache_clear()
        pkg_logger = _logger.setup_logger()
        # setup_logger keeps existing handlers, so re-level them here.
        lvl = logging.DEBUG if value else logging.INFO
        for h in pkg_logger.handlers:
            if isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler):
                h.setLevel(lvl)
    return os.environ.get("DOSMA_DEBUG", "").lower() in ("true", "1")


def temp_dir() -> str:
    """Scratch directory: ``$DOSMA_TEMP_DIR``, else ``~/.dosma_tpu_torch/temp``."""
    path = os.environ.get("DOSMA_TEMP_DIR", os.path.join(_DOSMA_DIR, "temp"))
    os.makedirs(path, exist_ok=True)
    return path


def log_file_path() -> str:
    """The log file of :func:`dosma_tpu_torch.utils.logger.setup_logger`."""
    return os.path.join(_DOSMA_DIR, "dosma.log")
