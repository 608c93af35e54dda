"""Per-scan action form (counterpart of ``dosma_tpu/gui/dosma_gui.py``).

``ScanReader`` renders the parameter form for one scan action from the
same reflection the CLI uses (``forms.action_fields``), tracks tissue
checkbox state, and can reproduce the equivalent command-line string so
every GUI run is scriptable afterwards.
"""

from __future__ import annotations

from typing import Dict, Tuple

from dosma_tpu_torch.gui.gui_utils import forms
from dosma_tpu_torch.gui.gui_utils.widgets import render_fields

__all__ = ["ScanReader"]


class ScanReader:
    """Form state + rendering for one (scan type, action) pair."""

    def __init__(self, parent):
        self.parent = parent
        self.scan_type = None
        self.action_name = None
        self.wrapper = None
        # name -> (tk StringVar, FieldSpec)
        self.param_vars: Dict[str, Tuple[object, forms.FieldSpec]] = {}

    def show_action_params(self, scan_type, action_name: str):
        """(Re)build the form for ``scan_type.action_name``."""
        for child in self.parent.winfo_children():
            child.destroy()
        self.scan_type, self.action_name = scan_type, action_name
        self.wrapper, specs = forms.action_fields(scan_type, action_name)
        self.param_vars = render_fields(self.parent, specs)

    def get_kwargs(self) -> dict:
        """Typed kwargs for the scan action from current widget state.

        Segmentation fields (weights_dir/model/batch_size) are returned
        under their own names; the caller assembles the SegModel the same
        way the CLI's ``handle_segmentation`` does.
        """
        out = {}
        for name, (var, spec) in self.param_vars.items():
            val = forms.parse_value(var.get(), spec)
            if val is None:
                if spec.required:
                    raise ValueError(f"Missing required parameter: {name}")
                continue
            out[name] = val
        return out

    def get_cmd_line_str(
        self, dicom_path=None, load_path=None, save_path=None, tissues=()
    ) -> str:
        """The CLI command equivalent to the current form."""
        values = {name: (var.get(), spec) for name, (var, spec) in self.param_vars.items()}
        return forms.build_cli_string(
            self.scan_type.NAME,
            self.action_name,
            dicom_path=dicom_path,
            load_path=load_path,
            save_path=save_path,
            tissues=tissues,
            values=values,
        )
