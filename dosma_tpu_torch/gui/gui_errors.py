"""GUI error surface: every user-facing failure goes through one place
(counterpart of ``dosma_tpu/gui/gui_errors.py``).

- :func:`show_error`: an error dialog when a Tk app is running, a logged
  error otherwise (so headless runs and tests never fail on a missing
  DISPLAY);
- :func:`gui_error_handler`: a decorator for Tk callbacks that turns an
  uncaught exception into :func:`show_error`, instead of a dead callback
  with a traceback on stderr.
"""

from __future__ import annotations

import functools
import logging
from typing import Callable, Optional

__all__ = ["show_error", "gui_error_handler", "GuiError"]

_logger = logging.getLogger(__name__)


class GuiError(RuntimeError):
    """An error with a user-presentable message (shown verbatim)."""


def _display_available() -> bool:
    try:
        import tkinter as tk

        root = tk._default_root  # only attach to an EXISTING Tk app
        return root is not None
    except Exception:  # pragma: no cover - tkinter absent
        return False


def show_error(title: str, message: str, parent=None) -> bool:
    """Show an error dialog; fall back to logging when headless.

    Returns ``True`` if a dialog was shown, ``False`` if the error was
    logged instead (no display / no running Tk app).
    """
    if _display_available():  # pragma: no cover - needs a DISPLAY
        try:
            from tkinter import messagebox

            messagebox.showerror(title, message, parent=parent)
            return True
        except Exception:
            pass
    _logger.error("%s: %s", title, message)
    return False


def gui_error_handler(
    func: Optional[Callable] = None, *, title: str = None, status_var=None
):
    """Decorator: route exceptions from a Tk callback to :func:`show_error`.

    ``status_var``: optional ``tk.StringVar`` (or any object with ``set``)
    additionally updated with a short error line — the status-bar pattern
    the viewer uses.
    """

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except Exception as e:
                _logger.exception("GUI action %r failed", fn.__name__)
                show_error(title or type(e).__name__, str(e))
                if status_var is not None:
                    try:
                        status_var.set(f"error: {e}")
                    except Exception:
                        pass
                return None

        return wrapper

    if func is not None:
        return decorate(func)
    return decorate
