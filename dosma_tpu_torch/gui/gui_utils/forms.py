"""Headless form models for the GUI (counterpart of
``dosma_tpu/gui/gui_utils/forms.py``).

The reflection of a scan action's signature lives in plain data
(:class:`FieldSpec`), the same reflection the port's command line runs, so
the form logic is testable without a display;
``dosma_tpu_torch.gui.gui_utils.widgets`` renders specs into tk widgets.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "FieldSpec",
    "is_filepath_param",
    "action_fields",
    "segmentation_fields",
    "parse_value",
    "build_cli_string",
]

# Parameter-name fragments that mark a string parameter as a filesystem
# path (gets a Browse button instead of a plain entry).
_FILEPATH_KEYWORDS = ("path", "dir", "directory", "file", "folder", "root", "dest")

_KINDS = ("str", "bool", "int", "float", "list", "filepath", "choice")


@dataclass
class FieldSpec:
    """One form field: everything a widget needs, no tk objects."""

    name: str
    kind: str  # one of _KINDS
    default: Any = None
    required: bool = False
    help: str = ""
    choices: Optional[Sequence[str]] = None
    # CLI flag this field maps to when building a command string
    # (defaults to --<name>).
    flag: Optional[str] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"Unknown field kind {self.kind!r}")
        if self.kind == "choice" and not self.choices:
            raise ValueError(f"Field {self.name!r}: 'choice' needs choices")


def is_filepath_param(name: str, ptype: type = str) -> bool:
    """A ``str`` parameter whose name carries
    a path-like keyword gets a file/dir chooser."""
    if ptype is not str:
        return False
    low = name.lower()
    return any(kw in low for kw in _FILEPATH_KEYWORDS)


def _kind_for(name: str, ptype: type) -> Optional[str]:
    if ptype is bool:
        return "bool"
    if ptype is int:
        return "int"
    if ptype is float:
        return "float"
    if ptype in (list, tuple):
        return "list"
    if ptype is str:
        return "filepath" if is_filepath_param(name, ptype) else "str"
    return None


def segmentation_fields() -> List[FieldSpec]:
    """Fields a ``SegModel`` parameter expands into: weights directory,
    model choice, batch size."""
    from dosma_tpu_torch.defaults import preferences
    from dosma_tpu_torch.models.util import SUPPORTED_MODELS

    aliases = list(SUPPORTED_MODELS)  # alias strings, CLI registry order
    return [
        FieldSpec(
            "weights_dir", "filepath", required=True,
            help="path to directory with weight files", flag="--weights_dir",
        ),
        FieldSpec(
            "model", "choice", default=aliases[0], choices=aliases,
            help="segmentation model", flag="--model",
        ),
        FieldSpec(
            "batch_size", "int", default=preferences.segmentation_batch_size,
            help="inference batch size", flag="--batch_size",
        ),
    ]


def action_fields(scan_type, action_name: str) -> Tuple[Any, List[FieldSpec]]:
    """Reflect a scan action into form fields — the same reflection the CLI
    subparser builder runs (``dosma_tpu/cli.py::add_scans``).

    ``Tissue`` parameters are handled by the scan-level tissue checkboxes and
    skipped here; ``SegModel`` expands into :func:`segmentation_fields`.
    Returns ``(ActionWrapper, fields)``.
    """
    from dosma_tpu_torch.cli import _is_tissue_annotation, _signature
    from dosma_tpu_torch.models.seg_model import SegModel

    action, wrapper = next(
        (a, w)
        for a, w in scan_type.cmd_line_actions()
        if w.name == action_name or action_name in w.aliases
    )

    fields: List[FieldSpec] = []
    for name, param in _signature(action).parameters.items():
        if name == "self" or _is_tissue_annotation(param.annotation):
            continue
        if param.annotation is SegModel:
            fields.extend(segmentation_fields())
            continue
        kind = _kind_for(name, param.annotation)
        if kind is None:
            continue
        default = None if param.default is inspect._empty else param.default
        fields.append(
            FieldSpec(
                name,
                kind,
                default=default,
                required=param.default is inspect._empty,
                help=wrapper.get_param_help(name) or "",
            )
        )
    return wrapper, fields


def parse_value(raw: str, spec: FieldSpec):
    """Convert a widget's string value to the field's python type.

    Empty strings (and literal "None") mean "use the default" and return
    ``None`` so callers can skip the kwarg.
    """
    raw = raw.strip()
    if raw in ("", "None"):
        return None
    if spec.kind == "bool":
        return raw.lower() in ("1", "true", "yes", "on")
    if spec.kind == "int":
        return int(raw)
    if spec.kind == "float":
        return float(raw)
    if spec.kind == "list":
        import ast

        val = ast.literal_eval(raw)
        if not isinstance(val, (list, tuple)):
            raise ValueError(f"{spec.name}: expected a list literal, got {raw!r}")
        return val
    return raw  # str / filepath / choice


def build_cli_string(
    scan_name: str,
    action_name: str,
    *,
    dicom_path: str = None,
    load_path: str = None,
    save_path: str = None,
    tissues: Sequence[str] = (),
    values: Dict[str, Tuple[str, FieldSpec]] = None,
) -> str:
    """Reconstruct the equivalent ``dosma`` command line from form state
    (the GUI shows users the CLI command it is about to run, so flows are
    scriptable afterwards).

    ``values`` maps field name -> (raw widget string, FieldSpec).
    """
    parts: List[str] = []
    if dicom_path:
        parts += ["--d", dicom_path]
    if load_path:
        parts += ["--l", load_path]
    if save_path:
        parts += ["--s", save_path]
    parts.append(scan_name)
    for t in tissues:
        parts.append(f"--{t}")
    parts.append(action_name)
    for name, (raw, spec) in (values or {}).items():
        val = parse_value(raw, spec)
        if val is None:
            continue
        flag = spec.flag or f"--{name}"
        if spec.kind == "bool":
            if val:
                parts.append(flag)
        else:
            parts += [flag, str(val)]
    return " ".join(parts)
