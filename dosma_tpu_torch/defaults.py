"""Preferences for the PyTorch port (counterpart of ``dosma_tpu/defaults.py``).

The defaults are held as a Python dict with the values of
``dosma_tpu/resources/templates/.preferences.yml``, so that importing the
port needs no yaml. Loading a user preferences file is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

__all__ = ["preferences", "AFFINE_DECIMAL_PRECISION", "SCANNER_ORIGIN_DECIMAL_PRECISION"]

# Affine matrices are rounded to this decimal precision on NIfTI read.
AFFINE_DECIMAL_PRECISION = 4
SCANNER_ORIGIN_DECIMAL_PRECISION = 4

# Slash-separated preference path -> default value.
_DEFAULTS: Dict[str, Any] = {
    "data/format": "nifti",
    "fitting/r2.threshold": 0.9,
    "logging/nipype": "file_stderr",
    "registration/mask/dilation.rate": 9.0,
    "registration/mask/dilation.threshold": 0.0001,
    "segmentation/precision": "float32",
    "segmentation/batch.size": 64,
    "visualization/matplotlib/rcParams/savefig.dpi": 400.0,
    "visualization/matplotlib/rcParams/savefig.format": "png",
    "visualization/use.vmax": False,
}


class _Preferences:
    """Preferences keyed by slash-separated paths (``"fitting/r2.threshold"``)."""

    def __init__(self, values: Dict[str, Any]):
        self._values = dict(values)

    def get(self, path: str) -> Any:
        if path not in self._values:
            raise KeyError(f"Preference '{path}' not found")
        return self._values[path]

    @property
    def fitting_r2_threshold(self) -> float:
        return self.get("fitting/r2.threshold")

    def keys(self):
        return tuple(self._values)

    def __repr__(self):
        return "Preferences(" + ", ".join(f"{k}={v!r}" for k, v in self._values.items()) + ")"


preferences = _Preferences(_DEFAULTS)
