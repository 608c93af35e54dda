"""FieldSpec → tk widget rendering (counterpart of
``dosma_tpu/gui/gui_utils/widgets.py``).

Kept deliberately thin: all decisions (kind, default, choices, flags) are
made headless in :mod:`dosma_tpu_torch.gui.gui_utils.forms`; this module only
instantiates the matching widget.
"""

from __future__ import annotations

from typing import Dict, Tuple

from dosma_tpu_torch.gui.gui_utils.forms import FieldSpec

__all__ = ["render_field", "render_fields"]


def render_field(parent, spec: FieldSpec, row: int, filedialog_reader=None):
    """Create label + input widget for one field at grid ``row``.

    Returns the tk variable holding the field's (string) value.
    """
    import tkinter as tk
    from tkinter import ttk

    label = spec.name + (" *" if spec.required else "")
    tk.Label(parent, text=label).grid(row=row, column=0, sticky="w", padx=4, pady=2)

    default = "" if spec.default is None else str(spec.default)
    var = tk.StringVar(value=default)

    if spec.kind == "bool":
        widget = tk.Checkbutton(parent, variable=var, onvalue="True", offvalue="False")
        var.set(default or "False")
    elif spec.kind == "choice":
        widget = ttk.Combobox(parent, textvariable=var, values=list(spec.choices), state="readonly")
    elif spec.kind == "filepath":
        widget = tk.Entry(parent, textvariable=var, width=40)
        reader = filedialog_reader
        if reader is None:
            from dosma_tpu_torch.gui.gui_utils.filedialog_reader import FileDialogReader

            reader = FileDialogReader(string_var=var)
        else:
            reader.string_var = var
        tk.Button(parent, text="Browse", command=reader.get_dirpath).grid(
            row=row, column=2, padx=2
        )
    else:  # str / int / float / list
        widget = tk.Entry(parent, textvariable=var, width=24)

    widget.grid(row=row, column=1, sticky="ew")
    if spec.help:
        tk.Label(parent, text=spec.help, fg="gray").grid(row=row, column=3, sticky="w")
    return var


def render_fields(parent, specs, filedialog_reader=None) -> Dict[str, Tuple[object, FieldSpec]]:
    """Render a field list; returns name -> (tk var, spec) for readback."""
    out = {}
    for i, spec in enumerate(specs):
        var = render_field(parent, spec, row=i, filedialog_reader=filedialog_reader)
        out[spec.name] = (var, spec)
    return out
