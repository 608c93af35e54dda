"""Preferences editor tab (counterpart of
``dosma_tpu/gui/preferences_viewer.py``: typed widgets with
validation per flag type, apply/save/restore-defaults, and a CLI-flag
string mirror of the current state).
"""

from __future__ import annotations

__all__ = ["PreferencesViewer"]


class PreferencesViewer:
    """Editable typed form over all preference leaves."""

    def __init__(self, parent):
        import tkinter as tk

        from dosma_tpu_torch.defaults import preferences

        self.parent = parent
        # path -> (tk var, spec)
        self._vars = {}
        self._defaults = {
            path: spec["default"] for path, spec in preferences.cmd_line_flags().items()
        }

        flags = preferences.cmd_line_flags()
        row = 0
        for path, spec in sorted(flags.items()):
            tk.Label(parent, text=path).grid(row=row, column=0, sticky="w", padx=4, pady=2)
            current = preferences.get(path)
            if spec["type"] is bool:
                var = tk.BooleanVar(value=bool(current))
                tk.Checkbutton(parent, variable=var).grid(row=row, column=1, sticky="w")
            elif "choices" in spec:
                var = tk.StringVar(value=str(current))
                tk.OptionMenu(parent, var, *[str(c) for c in spec["choices"]]).grid(
                    row=row, column=1, sticky="ew"
                )
            elif spec["type"] in (int, float):
                var = tk.StringVar(value=str(current))
                vcmd = (parent.register(self._make_number_validator(spec["type"])), "%P")
                tk.Entry(parent, textvariable=var, validate="key", validatecommand=vcmd).grid(
                    row=row, column=1, sticky="ew"
                )
            else:
                var = tk.StringVar(value=str(current))
                tk.Entry(parent, textvariable=var).grid(row=row, column=1, sticky="ew")
            if spec.get("help"):
                tk.Label(parent, text=spec["help"], fg="gray").grid(row=row, column=2, sticky="w")
            self._vars[path] = (var, spec)
            row += 1

        tk.Button(parent, text="Apply", command=self.apply).grid(row=row, column=0, pady=6)
        tk.Button(parent, text="Apply & Save", command=self.apply_and_save).grid(
            row=row, column=1, pady=6
        )
        tk.Button(parent, text="Restore defaults", command=self.restore_defaults).grid(
            row=row, column=2, pady=6
        )

    @staticmethod
    def _make_number_validator(typ):
        """Keystroke validator: allow prefixes of a valid int/float literal."""

        def validate(proposed: str) -> bool:
            if proposed in ("", "-", "+", ".", "-.", "+."):
                return True
            try:
                typ(proposed)
                return True
            except ValueError:
                return False

        return validate

    def apply(self):
        from dosma_tpu_torch.defaults import preferences

        for path, (var, _spec) in self._vars.items():
            try:
                preferences.set(path, var.get())
            except (ValueError, KeyError, TypeError):
                pass  # invalid entry: keep the previous value

    def apply_and_save(self):
        from dosma_tpu_torch.defaults import preferences

        self.apply()
        preferences.save()

    def restore_defaults(self):
        from dosma_tpu_torch.defaults import preferences

        for path, (var, _spec) in self._vars.items():
            default = self._defaults[path]
            preferences.set(path, default)
            try:
                var.set(default if isinstance(default, bool) else str(default))
            except Exception:
                pass

    def get_cmd_line_str(self) -> str:
        """The ``--flag value`` string reproducing the current form state."""
        parts = []
        for path, (var, spec) in sorted(self._vars.items()):
            flag = spec["aliases"][0]
            parts += [flag, str(var.get())]
        return " ".join(parts)
