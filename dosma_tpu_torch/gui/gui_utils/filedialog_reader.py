"""File-dialog wrappers for loading volumes (counterpart of
``dosma_tpu/gui/gui_utils/filedialog_reader.py``).

Dialog functions are injected so paths are testable headless: pass
``ask_open=...``/``ask_dir=...`` callables (defaults resolve to
``tkinter.filedialog`` lazily, only when a dialog is actually opened).
"""

from __future__ import annotations

import os

__all__ = ["FileDialogReader"]


class FileDialogReader:
    """Remembers the last-visited directory across dialogs, mirrors the
    chosen path into an optional StringVar, and loads volumes through the
    standard I/O dispatch (`fio_utils.generic_load`)."""

    def __init__(self, string_var=None, ask_open=None, ask_dir=None):
        self.string_var = string_var
        self._last_dir = os.path.expanduser("~")
        self._ask_open = ask_open
        self._ask_dir = ask_dir

    # -- dialog plumbing ------------------------------------------------
    def _open(self, **kwargs):
        if self._ask_open is not None:
            return self._ask_open(**kwargs)
        from tkinter import filedialog  # pragma: no cover - needs display

        return filedialog.askopenfilenames(**kwargs)  # pragma: no cover

    def _dir(self, **kwargs):
        if self._ask_dir is not None:
            return self._ask_dir(**kwargs)
        from tkinter import filedialog  # pragma: no cover - needs display

        return filedialog.askdirectory(**kwargs)  # pragma: no cover

    def _remember(self, path):
        self._last_dir = os.path.dirname(path) or self._last_dir
        if self.string_var is not None:
            self.string_var.set(path)
        return path

    # -- public surface --------------------------------------------------
    def load_volume(self, title="Select volume file(s)"):
        """Pick a file and load it as a MedicalVolume (DICOM picks load
        the containing series directory)."""
        from dosma_tpu_torch.core.io import format_io_utils as fio_utils

        path = self.get_volume_filepath(title)
        if not path:
            return None
        return fio_utils.generic_load(path, expected_num_volumes=1)

    def get_volume_filepath(self, title="Select path", im_type=None):
        # Omit the kwarg entirely when unrestricted — tkinter applies
        # tuple(filetypes), and tuple(None) raises before the dialog opens.
        kwargs = {}
        if im_type is not None and getattr(im_type, "name", "") == "dicom":
            kwargs["filetypes"] = (("dicom files", "*.dcm"),)
        files = self._open(initialdir=self._last_dir, title=title, **kwargs)
        if not files:
            return None
        path = files[0] if isinstance(files, (list, tuple)) else files
        if path.endswith(".dcm"):
            path = os.path.dirname(path)
        return self._remember(path)

    def get_filepath(self, title="Select file"):
        files = self._open(initialdir=self._last_dir, title=title)
        if not files:
            return None
        path = files[0] if isinstance(files, (list, tuple)) else files
        return self._remember(path)

    def get_dirpath(self, title="Select directory"):
        path = self._dir(initialdir=self._last_dir, title=title)
        return self._remember(path) if path else None

    def get_save_dirpath(self, title="Select save directory"):
        path = self._dir(initialdir=self._last_dir, title=title, mustexist=False)
        return self._remember(path) if path else None
