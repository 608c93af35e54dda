"""Quantitative value wrappers: T1ρ / T2 / T2* maps + regional metrics.

Counterpart of ``dosma_tpu/core/quant_vals.py``. A ``QuantitativeValue``
holds a parameter map and named companion volumes (e.g. r²), and saves
and loads them as NIfTI under ``dir/NAME/NAME.nii.gz``.

Regional metrics (finite and bounds mask, per-label Mean / Std / Median /
# Voxels, and any reduction a caller passes in ``fns``) come back as plain
rows from :meth:`QuantitativeValue.metric_rows`;
:meth:`QuantitativeValue.to_metrics` wraps them in a pandas DataFrame
(pandas is imported there only). The statistics are torch float64
reductions on the device the rows are computed on: a tensor map's own, a
host map's the default device (:mod:`dosma_tpu_torch.core.device`), to
which it crosses once with its mask. Every region's are computed at once
(:func:`dosma_tpu_torch.ops.analytics.region_stats`: a kernel chain on a
card, its plain version on the CPU), and only the statistics cross back to
the host, in one read, unless ``fns`` need each region's values.
"""

from __future__ import annotations

import os
import warnings
from enum import Enum
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from dosma_tpu_torch.core.device import as_tensor, compute_device
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.utils.profiling import annotate, count

__all__ = ["QuantitativeValueType", "QuantitativeValue", "T1Rho", "T2", "T2Star", "get_qv"]


class QuantitativeValueType(Enum):
    T1_RHO = 1
    T2 = 2
    T2_STAR = 3


class QuantitativeValue:
    """A volumetric quantitative parameter map plus companion volumes.

    Concrete subclasses (``T1Rho``, ``T2``, ``T2Star``) define ``ID``/``NAME``
    and are collected automatically into :attr:`_registry` for lookup and
    directory-scan loading.
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
        self.additional_volumes: Dict[str, MedicalVolume] = {}

    # ------------------------------------------------------------------
    def _map_path(self, dir_path: str, suffix: str = "") -> str:
        stem = f"{self.NAME}-{suffix}" if suffix else self.NAME
        return os.path.join(dir_path, self.NAME, f"{stem}.nii.gz")

    def save_data(self, dir_path: str, data_format=None):
        """Write the map and companion volumes under ``dir_path/NAME/``.

        Always NIfTI: DICOM's integer pixel storage would truncate the
        floating-point parameter values (another ``data_format`` warns).
        """
        from dosma_tpu_torch.core.io.format_io import ImageDataFormat

        if data_format is not None and data_format != ImageDataFormat.nifti:
            warnings.warn(
                "Due to bit depth issues, only nifti format is supported for quantitative "
                "values. Writing as nifti file..."
            )
        data_format = ImageDataFormat.nifti
        if self.volumetric_map is not None:
            self.volumetric_map.save_volume(self._map_path(dir_path), data_format=data_format)
        for name, vol in self.additional_volumes.items():
            vol.save_volume(self._map_path(dir_path, suffix=name), data_format=data_format)

    def load_data(self, dir_path: str):
        from dosma_tpu_torch.core.io import format_io_utils as fio_utils

        self.volumetric_map = fio_utils.generic_load(
            self._map_path(dir_path), expected_num_volumes=1
        )

    def add_additional_volume(self, name: str, volume: MedicalVolume):
        if not isinstance(volume, MedicalVolume):
            raise TypeError("`volume` must be of type MedicalVolume")
        self.additional_volumes[name] = volume

    def to(self, device):
        self.volumetric_map = self.volumetric_map.to(device)
        self.additional_volumes = {k: v.to(device) for k, v in self.additional_volumes.items()}
        return self

    # ------------------------------------------------------------------
    def metric_rows(
        self,
        mask: Optional[MedicalVolume] = None,
        labels: Optional[Dict[int, str]] = None,
        bounds: Optional[Tuple[float, float]] = None,
        closed: str = "right",
        fns: Optional[Dict[str, Callable]] = None,
    ) -> List[dict]:
        """Per-region summary statistics as plain rows.

        One row per mask label plus a ``total`` row (without a mask, only
        ``total`` over every valid voxel). Valid voxels are finite and
        inside ``bounds`` (``closed`` picks the inclusive ends). Each row
        holds Category / Mean / Std / Median / # Voxels and one entry per
        reduction of ``fns``, which receives the region's values as a host
        array.

        The rows are computed where the map lies, and a host (numpy) map
        on the default device, as every entry point computes host data: on
        the first CUDA card unless the CPU was asked for
        (``default_device("cpu")``). A host map and its mask then cross to
        the card once; with no card and no request for the CPU this raises.
        """
        from dosma_tpu_torch.ops.analytics import region_stats, region_values

        with annotate("dosma.rows"):
            with annotate("dosma.rows.gather"):
                pixels = self.volumetric_map.volume
                volume = as_tensor(pixels, compute_device(pixels))
                if volume.device.type != "cpu" and not isinstance(pixels, torch.Tensor):
                    count("region_stats.host_maps")
                mask_t = None
                if mask is None:
                    labels = {}
                else:
                    mask_t = as_tensor(mask.reformat(self.volumetric_map.orientation).volume,
                                       volume.device)
                    if labels is None:
                        labels = {int(v): f"label_{int(v)}"
                                  for v in torch.unique(mask_t[mask_t > 0]).tolist()}
                stats = region_stats(volume, mask_t, list(labels), bounds, closed)
                values = region_values(volume, mask_t, list(labels), bounds, closed) if fns else ()
            with annotate("dosma.rows.summary"):
                rows = [{"Category": name, "Mean": mean, "Std": std, "Median": median,
                         "# Voxels": int(n)}
                        for name, (n, mean, std, median) in zip([*labels.values(), "total"],
                                                                stats.tolist())]
                for row, region in zip(rows, values):
                    host = region.cpu().numpy()
                    row.update({fname: fn(host) for fname, fn in fns.items()})
                return rows

    def to_metrics(
        self,
        mask: Optional[MedicalVolume] = None,
        labels: Optional[Dict[int, str]] = None,
        bounds: Optional[Tuple[float, float]] = None,
        closed: str = "right",
        fns: Optional[Dict[str, Callable]] = None,
    ):
        """:meth:`metric_rows` as a pandas DataFrame."""
        import pandas as pd

        return pd.DataFrame(self.metric_rows(mask, labels, bounds, closed, fns))

    # ------------------------------------------------------------------
    @staticmethod
    def get_qv(qv_id: Union[int, str]) -> "QuantitativeValue":
        """Instantiate a registered QV by name (case-insensitive) or integer ID."""
        for cls in QuantitativeValue._registry.values():
            if qv_id in (cls.NAME, cls.NAME.lower(), cls.ID):
                return cls()
        raise ValueError(f"Quantitative Value with name or id {qv_id} not found")

    @staticmethod
    def save_qvs(dir_path: str, qvs):
        for qv in qvs:
            if not isinstance(qv, QuantitativeValue):
                raise TypeError("All members of `qvs` must be instances of QuantitativeValue")
            qv.save_data(dir_path)

    @staticmethod
    def load_qvs(dir_path: str):
        """Load every registered QV that has a saved map under ``dir_path``."""
        found = []
        for cls in QuantitativeValue._registry.values():
            qv = cls()
            if os.path.isfile(qv._map_path(dir_path)):
                qv.load_data(dir_path)
                found.append(qv)
        return found

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
