"""Logging setup (counterpart of ``dosma_tpu/utils/logger.py``; a re-design
of DOSMA's ``dosma/utils/logger.py:45-150``).

Colored stream handler + file handler at ``~/.dosma_tpu_torch/dosma.log``;
``functools.lru_cache`` prevents duplicate handler registration.
"""

from __future__ import annotations

import functools
import logging
import os
import sys
from typing import Optional

__all__ = ["setup_logger"]

_COLORS = {
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",  # red
    logging.CRITICAL: "\x1b[31;1m",
}
_RESET = "\x1b[0m"


class _ColorfulFormatter(logging.Formatter):
    """Prefixes WARNING/ERROR records with ANSI colors when attached to a tty."""

    def __init__(self, *args, use_color: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self._use_color = use_color

    def format(self, record):
        msg = super().format(record)
        color = _COLORS.get(record.levelno)
        if color and self._use_color:
            return f"{color}{msg}{_RESET}"
        return msg


@functools.lru_cache()
def setup_logger(
    output: Optional[str] = None,
    name: str = "dosma_tpu_torch",
    abbrev_name: Optional[str] = None,
    stream_lvl: Optional[int] = None,
    overwrite_handlers: bool = False,
) -> logging.Logger:
    """Initialize the package logger.

    Args:
        output: log file path (default ``~/.dosma_tpu_torch/dosma.log``). Pass ``""``
            to skip the file handler.
        name: logger name.
        stream_lvl: console log level. Defaults to DEBUG when ``DOSMA_DEBUG``
            is set, else WARNING (same policy as the reference).
    """
    from dosma_tpu_torch.utils import env

    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    if overwrite_handlers:
        logger.handlers.clear()

    if stream_lvl is None:
        # INFO default like the reference — CLI progress messages must show.
        stream_lvl = logging.DEBUG if env.debug() else logging.INFO

    has_stream = any(isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler) for h in logger.handlers)
    if not has_stream:
        ch = logging.StreamHandler(stream=sys.stdout)
        ch.setLevel(stream_lvl)
        ch.setFormatter(
            _ColorfulFormatter(
                "%(asctime)s %(name)s %(levelname)s: %(message)s",
                datefmt="%m/%d %H:%M:%S",
                use_color=sys.stdout.isatty(),
            )
        )
        logger.addHandler(ch)

    if output is None:
        output = env.log_file_path()
    if output:
        has_file = any(isinstance(h, logging.FileHandler) for h in logger.handlers)
        if not has_file:
            try:
                os.makedirs(os.path.dirname(output), exist_ok=True)
                fh = logging.FileHandler(output)
                fh.setLevel(logging.DEBUG)
                fh.setFormatter(
                    logging.Formatter(
                        "%(asctime)s %(name)s %(levelname)s: %(message)s",
                        datefmt="%m/%d %H:%M:%S",
                    )
                )
                logger.addHandler(fh)
            except OSError:
                pass

    return logger
