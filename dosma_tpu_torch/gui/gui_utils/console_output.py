"""Logging → text-widget bridge (counterpart of
``dosma_tpu/gui/gui_utils/console_output.py``).

Works with any object exposing the tiny widget protocol
(``configure(state=...)``, ``insert(index, text)``, ``see(index)``) so it
is testable without a display.
"""

from __future__ import annotations

import logging

__all__ = ["WidgetLogger"]


class WidgetLogger(logging.Handler):
    """Appends log records to a (tk) text widget, keeping it read-only
    between writes and scrolled to the newest line."""

    def __init__(self, widget, level=logging.INFO):
        super().__init__(level=level)
        self.setFormatter(logging.Formatter("%(levelname)s: %(message)s"))
        self.widget = widget
        self.widget.configure(state="disabled")

    def emit(self, record):
        # Log records arrive from worker threads; hop to the Tk main
        # thread before touching the widget.
        try:
            self.widget.after(0, self._append, self.format(record))
        except Exception:  # widget destroyed
            pass

    def _append(self, text):
        self.widget.configure(state="normal")
        self.widget.insert("end", text + "\n")
        self.widget.see("end")
        self.widget.configure(state="disabled")
