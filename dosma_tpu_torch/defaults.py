"""Preferences for the PyTorch port (counterpart of ``dosma_tpu/defaults.py``).

A nested config: each leaf is a dict with ``value``, ``type`` and ``help``
(and optionally ``choices``), as in
``dosma_tpu/resources/templates/.preferences.yml``. The template is held
here as a Python dict, so that importing the port needs no yaml. Leaves are
read and written by slash-separated paths
(``preferences.get("fitting/r2.threshold")``), generate command-line flags
(:meth:`_Preferences.cmd_line_flags`) and can be saved to, and are loaded
from, a user file (``~/.dosma_tpu_torch/preferences.yml``); only saving and
loading that file import yaml.
"""

from __future__ import annotations

import copy
import os
import warnings
from typing import Any, Dict

__all__ = ["preferences", "AFFINE_DECIMAL_PRECISION", "SCANNER_ORIGIN_DECIMAL_PRECISION"]

# Affine matrices are rounded to this decimal precision on NIfTI read.
AFFINE_DECIMAL_PRECISION = 4
SCANNER_ORIGIN_DECIMAL_PRECISION = 4

_TYPES = {"str": str, "int": int, "float": float, "bool": bool}


def _leaf(value, typ, help, choices=None) -> Dict[str, Any]:
    leaf = {"value": value, "type": typ, "help": help}
    if choices is not None:
        leaf["choices"] = list(choices)
    return leaf


_TEMPLATE: Dict[str, Any] = {
    "data": {
        "format": _leaf("nifti", "str", "default save format for image data",
                        choices=("nifti", "dicom")),
    },
    "fitting": {
        "r2.threshold": _leaf(0.9, "float", "minimum r^2 for a fit to be kept (else NaN)"),
    },
    "logging": {
        "nipype": _leaf("file_stderr", "str",
                        "registration subprocess logging mode (reference-compat key)"),
    },
    "registration": {
        "mask": {
            "dilation.rate": _leaf(
                9.0, "float", "gaussian blur sigma used to dilate masks prior to registration"),
            "dilation.threshold": _leaf(0.0001, "float", "threshold applied to blurred mask"),
        },
    },
    "segmentation": {
        # float32 is the default; bfloat16 trades accuracy for speed (PERF.md).
        "precision": _leaf("float32", "str",
                           "numeric precision for segmentation inference (float32 | bfloat16)"),
        "batch.size": _leaf(64, "int", "batch size for segmentation model inference"),
    },
    "visualization": {
        "matplotlib": {
            "rcParams": {
                "savefig.dpi": _leaf(400.0, "float", "figure dpi"),
                "savefig.format": _leaf("png", "str", "figure format"),
            },
        },
        "use.vmax": _leaf(False, "bool", "use per-qv vmax bounds in figures"),
    },
}


def _is_leaf(node: Any) -> bool:
    return isinstance(node, dict) and "value" in node and "type" in node


def _walk_leaves(node: Dict, prefix: str = ""):
    for k, v in node.items():
        path = f"{prefix}/{k}" if prefix else k
        if _is_leaf(v):
            yield path, v
        elif isinstance(v, dict):
            yield from _walk_leaves(v, path)


class _Preferences:
    """Preferences keyed by slash-separated paths (``"fitting/r2.threshold"``).

    Args:
        user_path: the user file merged over the template when it exists,
            and written by :meth:`save`.
    """

    def __init__(self, user_path: str = "~/.dosma_tpu_torch/preferences.yml"):
        self._config = copy.deepcopy(_TEMPLATE)
        self._user_path = os.path.expanduser(user_path)
        if os.path.isfile(self._user_path):
            self.load(self._user_path)

    def _find(self, path: str):
        node = self._config
        for part in path.split("/"):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(f"Preference '{path}' not found")
            node = node[part]
        if not _is_leaf(node):
            raise KeyError(f"Preference '{path}' is not a leaf key")
        return node

    def get(self, path: str) -> Any:
        return self._find(path)["value"]

    def set(self, path: str, value: Any, prefix: str = ""):
        """Set a leaf, coerced to its type; a value outside its ``choices``
        raises ``ValueError``."""
        if prefix:
            path = f"{prefix}/{path}"
        leaf = self._find(path)
        typ = _TYPES[leaf["type"]]
        if isinstance(value, str) and typ is bool:
            value = value.lower() in ("1", "true", "yes")
        value = typ(value)
        if "choices" in leaf and value not in leaf["choices"]:
            raise ValueError(f"Invalid value {value!r} for '{path}'; choices: {leaf['choices']}")
        leaf["value"] = value

    def keys(self):
        return tuple(path for path, _ in _walk_leaves(self._config))

    def load(self, path: str):
        """Merge a flat ``{path: value}`` yaml file over the current values.

        Keys the template no longer has, and values its types or choices
        refuse, are skipped with a warning.
        """
        import yaml

        with open(path) as f:
            user = yaml.safe_load(f) or {}
        if not isinstance(user, dict):
            raise ValueError(f"{path}: expected a mapping of preference paths to values")
        for key, value in user.items():
            try:
                self.set(key, value)
            except (KeyError, ValueError, TypeError) as e:
                warnings.warn(f"{path}: preference {key!r} skipped: {e}", stacklevel=2)

    def save(self):
        """Write every leaf's value to the user file as flat yaml."""
        import yaml

        os.makedirs(os.path.dirname(self._user_path), exist_ok=True)
        flat = {path: leaf["value"] for path, leaf in _walk_leaves(self._config)}
        with open(self._user_path, "w") as f:
            yaml.safe_dump(flat, f)

    # ------------------------------------------------------------------
    # Named accessors (those of ``dosma_tpu.defaults``).
    # ------------------------------------------------------------------
    @property
    def image_data_format(self):
        from dosma_tpu_torch.core.io.format_io import ImageDataFormat

        return ImageDataFormat[self.get("data/format")]

    @property
    def fitting_r2_threshold(self) -> float:
        return self.get("fitting/r2.threshold")

    @property
    def mask_dilation_rate(self) -> float:
        return self.get("registration/mask/dilation.rate")

    @property
    def mask_dilation_threshold(self) -> float:
        return self.get("registration/mask/dilation.threshold")

    @property
    def segmentation_batch_size(self) -> int:
        return self.get("segmentation/batch.size")

    @property
    def segmentation_precision(self) -> str:
        return self.get("segmentation/precision")

    @property
    def visualization_use_vmax(self) -> bool:
        return self.get("visualization/use.vmax")

    @property
    def nipype_logging(self) -> str:
        return self.get("logging/nipype")

    def cmd_line_flags(self) -> Dict[str, Dict]:
        """Leaf preferences as argparse keyword dicts keyed by path.

        Each value carries ``aliases`` (the ``--flag`` strings) and ``name``,
        which a command line pops before ``add_argument``.
        """
        flags = {}
        for path, leaf in _walk_leaves(self._config):
            flag = "--" + path.replace("/", ".").replace("..", ".")
            spec = {
                "aliases": [flag],
                "name": path,
                "default": leaf["value"],
                "type": _TYPES[leaf["type"]],
                "help": leaf.get("help", ""),
                "nargs": "?",
            }
            if "choices" in leaf:
                spec["choices"] = leaf["choices"]
            flags[path] = spec
        return flags

    def __repr__(self):
        flat = {path: leaf["value"] for path, leaf in _walk_leaves(self._config)}
        return "Preferences(" + ", ".join(f"{k}={v!r}" for k, v in flat.items()) + ")"


preferences = _Preferences()
