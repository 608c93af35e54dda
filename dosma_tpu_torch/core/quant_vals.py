"""Quantitative value wrappers: T1ρ / T2 / T2* maps + regional metrics.

Counterpart of ``dosma_tpu/core/quant_vals.py``. The regional reductions
(finite and bounds mask, per-label Mean / Std / Median / # Voxels) run in
torch on the map's own device and come back as plain rows;
:meth:`QuantitativeValue.to_metrics` wraps those rows in a pandas DataFrame
(pandas is imported there only). Saving and loading maps waits for the
port's NIfTI I/O.
"""

from __future__ import annotations

from enum import Enum
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dosma_tpu_torch.core.med_volume import MedicalVolume

__all__ = ["QuantitativeValueType", "QuantitativeValue", "T1Rho", "T2", "T2Star", "get_qv"]


class QuantitativeValueType(Enum):
    T1_RHO = 1
    T2 = 2
    T2_STAR = 3


def _as_tensor(vol, device: torch.device) -> torch.Tensor:
    if not isinstance(vol, torch.Tensor):
        vol = torch.from_numpy(np.ascontiguousarray(vol))
    return vol.to(device)


def _summary(values: torch.Tensor) -> Tuple[float, float, float]:
    """Mean, population std and median (the mean of the two middle values
    for an even count, as ``np.nanmedian``) of a 1-D tensor of finite values."""
    n = values.numel()
    if n == 0:
        return np.nan, np.nan, np.nan
    v = values.to(torch.float64)
    mean = v.mean()
    std = torch.sqrt(((v - mean) ** 2).mean())
    ordered = torch.sort(values).values
    k = n // 2
    median = ordered[k] if n % 2 else (ordered[k - 1] + ordered[k]) / 2
    return float(mean), float(std), float(median)


class QuantitativeValue:
    """A volumetric quantitative parameter map.

    Concrete subclasses (``T1Rho``, ``T2``, ``T2Star``) define ``ID``/``NAME``
    and are collected automatically into :attr:`_registry` for lookup.
    """

    ID = 0
    NAME = ""
    _registry: Dict[str, type] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if cls.NAME:
            QuantitativeValue._registry[cls.NAME] = cls

    def __init__(self, volumetric_map: Optional[MedicalVolume] = None):
        if self.ID <= 0 or not self.NAME:
            raise TypeError(f"{type(self).__name__} must define `ID` and `NAME`")
        if volumetric_map is not None and not isinstance(volumetric_map, MedicalVolume):
            raise TypeError("`volumetric_map` must be of type MedicalVolume")
        self.volumetric_map = volumetric_map

    # ------------------------------------------------------------------
    def metric_rows(
        self,
        mask: Optional[MedicalVolume] = None,
        labels: Optional[Dict[int, str]] = None,
        bounds: Optional[Tuple[float, float]] = None,
        closed: str = "right",
    ) -> List[dict]:
        """Per-region summary statistics as plain rows, reduced on the map's device.

        One row per mask label plus a ``total`` row (without a mask, only
        ``total`` over every valid voxel). Valid voxels are finite and
        inside ``bounds`` (``closed`` picks the inclusive ends). Each row
        holds Category / Mean / Std / Median / # Voxels.
        """
        vol = self.volumetric_map.volume
        device = vol.device if isinstance(vol, torch.Tensor) else torch.device("cpu")
        volume = _as_tensor(vol, device)
        valid = torch.isfinite(volume) & self._bounds_mask(volume, bounds, closed)

        if mask is None:
            regions = [("total", valid)]
        else:
            mask_arr = _as_tensor(mask.reformat(self.volumetric_map.orientation).volume, device)
            if labels is None:
                labels = {int(v): f"label_{int(v)}" for v in torch.unique(mask_arr).tolist() if v > 0}
            # Invalid voxels leave every region, as the JAX package zeroes them.
            mask_arr = torch.where(valid, mask_arr, torch.zeros_like(mask_arr))
            regions = [(name, mask_arr == label) for label, name in labels.items()]
            regions.append(("total", mask_arr > 0))

        rows = []
        for name, selected in regions:
            values = volume[selected]
            mean, std, median = _summary(values)
            rows.append({"Category": name, "Mean": mean, "Std": std, "Median": median,
                         "# Voxels": int(values.numel())})
        return rows

    def to_metrics(
        self,
        mask: Optional[MedicalVolume] = None,
        labels: Optional[Dict[int, str]] = None,
        bounds: Optional[Tuple[float, float]] = None,
        closed: str = "right",
    ):
        """:meth:`metric_rows` as a pandas DataFrame."""
        import pandas as pd

        return pd.DataFrame(self.metric_rows(mask, labels, bounds, closed))

    @staticmethod
    def _bounds_mask(volume: torch.Tensor, bounds, closed: str) -> torch.Tensor:
        if not bounds:
            return torch.ones(volume.shape, dtype=torch.bool, device=volume.device)
        if len(bounds) != 2:
            raise ValueError(f"`bounds` must be (lower, upper), got {bounds}")
        lb, ub = bounds
        if lb > ub:
            raise ValueError(f"lower:{lb}, upper: {ub}")
        if closed not in ("right", "left", "both", "neither"):
            raise ValueError(f"Invalid `closed`={closed!r}")
        above = volume >= lb if closed in ("left", "both") else volume > lb
        below = volume <= ub if closed in ("right", "both") else volume < ub
        return above & below

    # ------------------------------------------------------------------
    @staticmethod
    def get_qv(qv_id: Union[int, str]) -> "QuantitativeValue":
        """Instantiate a registered QV by name (case-insensitive) or integer ID."""
        for cls in QuantitativeValue._registry.values():
            if qv_id in (cls.NAME, cls.NAME.lower(), cls.ID):
                return cls()
        raise ValueError(f"Quantitative Value with name or id {qv_id} not found")

    @property
    def qv_type(self) -> QuantitativeValueType:
        raise NotImplementedError(f"Quantitative value type not implemented for {type(self)}")


class T1Rho(QuantitativeValue):
    """Spin-lattice relaxation in the rotating frame (T1ρ)."""

    ID = 1
    NAME = "t1_rho"

    @property
    def qv_type(self):
        return QuantitativeValueType.T1_RHO


class T2(QuantitativeValue):
    """Spin-spin (transverse) relaxation time."""

    ID = 2
    NAME = "t2"

    @property
    def qv_type(self):
        return QuantitativeValueType.T2


class T2Star(QuantitativeValue):
    """Effective transverse relaxation time (T2*)."""

    ID = 3
    NAME = "t2_star"

    @property
    def qv_type(self):
        return QuantitativeValueType.T2_STAR


get_qv = QuantitativeValue.get_qv
