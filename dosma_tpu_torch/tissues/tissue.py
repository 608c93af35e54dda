"""Anatomical-tissue base class (counterpart of ``dosma_tpu/tissues/tissue.py``).

A tissue keeps its segmentation mask on the host, in the SAGITTAL frame,
its registered quantitative values, and the per-region analytics of each:
``quant_vals[name] = (unrolled maps, DataFrame)``. Each subclass computes
its analytics as plain rows in :meth:`Tissue.quant_rows` (no pandas), and
``__calc_quant_vals__`` wraps them in a DataFrame; pandas is imported only
there, and matplotlib only where a figure is drawn.

Masks, ``largest_cc`` and the region geometry stay in numpy on the host, so
that the region bits match ``dosma_tpu`` exactly. A quantitative map stays
on its device: tissues whose analytics read the whole map start its copy
to the host when the value is registered (``_PREFETCH_FULL_MAP``); the
others gather the masked voxels where the map lies.
"""

from __future__ import annotations

import glob
import os
from abc import ABC, abstractmethod
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from dosma_tpu_torch.core.io import format_io_utils as fio_utils
from dosma_tpu_torch.core.io.format_io import ImageDataFormat
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.core.orientation import SAGITTAL
from dosma_tpu_torch.core.quant_vals import QuantitativeValue, QuantitativeValueType
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.utils import io_utils

WEIGHTS_FILE_EXT = "h5"

__all__ = ["Tissue", "column_means", "largest_cc", "unrolled_maps"]


class Tissue(ABC):
    """Base class for anatomical structures (cartilage, meniscus, bone, ...).

    Subclasses declare class-level identity constants and implement the
    region splitting and the analytics:

    - ``ID`` / ``STR_ID`` / ``FULL_NAME``: integer id, short slug (e.g.
      ``"fc"``), and display name.
    - ``T1_EXPECTED``: nominal T1 (ms) used to pick spin-lock/echo defaults.
    - :meth:`split_regions`, :meth:`quant_rows` and ``__save_quant_data__``.

    The segmentation mask is always stored in the SAGITTAL frame; setting a
    mask in any other orientation reformats it on assignment.
    """

    ID: int = -1
    STR_ID: str = ""
    FULL_NAME: str = ""
    T1_EXPECTED: Optional[float] = None
    #: Whether this tissue's analytics read the whole quantitative map on the
    #: host. Tissues whose analytics gather the masked voxels set it False,
    #: so a map on a card is never copied whole.
    _PREFETCH_FULL_MAP: bool = True

    def __init__(self, weights_dir: str = None, medial_to_lateral: bool = None):
        self.pid: Optional[str] = None
        self.medial_to_lateral = medial_to_lateral
        self.quantitative_values: List[QuantitativeValue] = []
        #: name -> (unrolled map(s), DataFrame of per-region metrics)
        self.quant_vals = {}
        self.__mask__: Optional[MedicalVolume] = None
        self.weights_file_path = self.find_weights(weights_dir) if weights_dir else None

    # ------------------------------------------------------------------ mask

    @property
    def mask(self) -> Optional[MedicalVolume]:
        """Binary segmentation mask (SAGITTAL frame), or ``None`` if unset."""
        return self.__mask__

    @mask.setter
    def mask(self, value: MedicalVolume):
        if type(value) is not MedicalVolume:
            raise AssertionError("mask for tissue must be of type MedicalVolume")
        self.__mask__ = value.reformat(SAGITTAL)

    def set_mask(self, mask: MedicalVolume):
        """Alias of ``self.mask = mask``; subclasses add their region split."""
        assert type(mask) is MedicalVolume, "mask for tissue must be of type MedicalVolume"
        self.mask = mask

    def get_mask(self) -> Optional[MedicalVolume]:
        """Alias of :attr:`mask`."""
        return self.mask

    # -------------------------------------------------------- quantitation

    @abstractmethod
    def split_regions(self, base_map: Union[np.ndarray, MedicalVolume]):
        """Partition ``base_map`` into this tissue's anatomical regions."""
        raise NotImplementedError  # pragma: no cover

    def calc_quant_vals(self):
        """Run per-region analytics for every registered quantitative value."""
        for qv in self.quantitative_values:
            self.__calc_quant_vals__(qv.volumetric_map, qv.qv_type)

    @abstractmethod
    def quant_rows(
        self, quant_map: MedicalVolume, map_type: QuantitativeValueType
    ) -> Tuple[List[str], List[list], List[dict]]:
        """This tissue's analytics of ``quant_map``, without pandas:
        ``(header, rows, maps)``, the table's column names, its rows, and the
        unrolled maps (``{"title", "data", ...}`` dicts)."""
        raise NotImplementedError  # pragma: no cover

    def __calc_quant_vals__(self, quant_map: MedicalVolume, map_type: QuantitativeValueType):
        """:meth:`quant_rows` as a DataFrame, stored in ``quant_vals``."""
        import pandas as pd

        header, rows, maps = self.quant_rows(quant_map, map_type)
        self.__store_quant_vals__(maps, pd.DataFrame(rows, columns=header), map_type)

    def _check_quant_map(self, quant_map: MedicalVolume, map_type: QuantitativeValueType):
        """Validate the inputs of :meth:`quant_rows` and reformat ``quant_map``
        in place to the mask's orientation (on its device); a sharded map is
        gathered whole first, in place."""
        if not isinstance(quant_map, MedicalVolume):
            raise TypeError("quant_map must be a MedicalVolume")
        if not isinstance(map_type, QuantitativeValueType):
            raise TypeError("map_type must be a QuantitativeValueType")
        if self.__mask__ is None:
            raise ValueError(f"Please initialize mask for {self.FULL_NAME}")
        if hasattr(quant_map.volume, "full_tensor"):
            # A map sharded over ranks (a DTensor) is all-gathered first, in
            # place like the reformat: each rank then reduces the whole map.
            quant_map.volume = quant_map.volume.full_tensor()
        quant_map.reformat(self.__mask__.orientation, inplace=True)
        # A gather at the mask's indices would read a map of another shape
        # with the wrong strides instead of failing, so the shapes are
        # checked here.
        if tuple(quant_map.shape[:3]) != tuple(self.__mask__.shape[:3]):
            raise ValueError(
                f"quant_map shape {tuple(quant_map.shape[:3])} does not match "
                f"mask shape {tuple(self.__mask__.shape[:3])} for {self.FULL_NAME}"
            )

    def _masked_values(self, quant_map: MedicalVolume):
        """``(nz, codes, values)``: the mask's nonzero indices (host), the
        region volume at them (one row per channel, int8, on the map's
        device) and ``mask * map`` at them (float64, on the map's device).
        The map is gathered where it lies; nothing crosses to the host."""
        from dosma_tpu_torch.ops.analytics import flat_indices, gather_voxels, volume_tensor

        mask = np.asarray(self.__mask__.volume)
        nz = np.nonzero(mask)
        volume = volume_tensor(quant_map.volume)
        device = volume.device
        values = gather_voxels(volume, flat_indices(nz, mask.shape)).to(torch.float64)
        values = torch.from_numpy(mask[nz]).to(device).to(torch.float64) * values
        regions = self.regions_mask
        codes = np.stack([regions[..., k][nz] for k in range(regions.shape[-1])])
        return nz, torch.from_numpy(codes.astype(np.int8)).to(device), values

    def __store_quant_vals__(self, quant_map, quant_df, map_type):
        self.quant_vals[map_type.name] = (quant_map, quant_df)

    def add_quantitative_value(self, qv_new: QuantitativeValue):
        """Register a quantitative value (T2, T1ρ, ...) with the tissue.

        For tissues whose analytics read the whole map on the host, a map on
        a card starts its copy to the host now
        (:meth:`MedicalVolume.copy_to_host_async`), so the transfer overlaps
        the host work that comes first.
        """
        vm = qv_new.volumetric_map
        if self._PREFETCH_FULL_MAP and isinstance(vm, MedicalVolume):
            vm.copy_to_host_async()
        self.quantitative_values.append(qv_new)

    # ---------------------------------------------------------------- weights

    def find_weights(self, weights_dir: str) -> str:
        """The one regular file in ``weights_dir`` whose name contains
        :attr:`STR_ID` and ends in ``h5`` (so ``.hdf5`` does not match)."""
        candidates = [
            p
            for p in glob.glob(os.path.join(weights_dir, "*"))
            if os.path.isfile(p)
            and self.STR_ID in os.path.basename(p)
            and p.endswith(WEIGHTS_FILE_EXT)
        ]
        if not candidates:
            raise ValueError(
                f"No file found that contains '{self.STR_ID}' and ends in '{WEIGHTS_FILE_EXT}'"
            )
        if len(candidates) > 1:
            raise ValueError("There are multiple weights files, please remove duplicates")
        self.weights_file_path = candidates[0]
        return self.weights_file_path

    # ---------------------------------------------------------------- disk IO

    def __save_dirpath__(self, dirpath: str) -> str:
        """``dirpath/STR_ID``, created on demand — this tissue's data root."""
        return io_utils.mkdirs(os.path.join(dirpath, self.STR_ID))

    def _mask_filepath(self, root: str) -> str:
        return os.path.join(root, f"{self.STR_ID}.nii.gz")

    def save_data(self, save_dirpath: str, data_format: ImageDataFormat = None):
        """Write the mask, the quantitative values and the analytics.

        Layout: ``save_dirpath/STR_ID/{STR_ID}.nii.gz`` for the mask, one
        subdirectory per quantitative value, plus whatever
        ``__save_quant_data__`` writes (figures and ``data.xlsx``).
        """
        if data_format is None:
            data_format = preferences.image_data_format
        root = self.__save_dirpath__(save_dirpath)

        if self.__mask__ is not None:
            path = fio_utils.convert_image_data_format(self._mask_filepath(root), data_format)
            self.__mask__.save_volume(path, data_format=data_format)

        for qv in self.quantitative_values:
            qv.save_data(root, data_format)

        self.__save_quant_data__(root)

    @abstractmethod
    def __save_quant_data__(self, dirpath: str):
        """Write tissue-specific analytics (figures, spreadsheets) to ``dirpath``."""
        raise NotImplementedError  # pragma: no cover

    def save_quant_data(self, dirpath: str):
        """Public wrapper over ``__save_quant_data__`` (no mask/map output)."""
        return self.__save_quant_data__(dirpath)

    def load_data(self, load_dir_path: str):
        """Restore the mask and quantitative values written by :meth:`save_data`.

        A missing mask file is not an error. The mask goes through
        :meth:`set_mask`, so a subclass splits its regions.
        """
        root = self.__save_dirpath__(load_dir_path)
        try:
            msk = fio_utils.generic_load(self._mask_filepath(root), expected_num_volumes=1)
        except FileNotFoundError:
            msk = None
        if msk is not None:
            self.set_mask(msk)
        self.quantitative_values = QuantitativeValue.load_qvs(root)

    # ---------------------------------------------------------------- plotting

    def __get_axis_bounds__(self, im: np.ndarray, ignore_nan=True, leave_buffer=False):
        """Per-axis (min, max) index bounds of the nonzero support of ``im``;
        ``leave_buffer`` widens each bound by 5 px."""
        arr = np.nan_to_num(im) if ignore_nan else im
        pad = 5 if leave_buffer else 0
        return [(idx.min() - pad, idx.max() + pad) for idx in np.nonzero(arr)]


def unrolled_maps(map_type: QuantitativeValueType, layers, ylabel: str) -> List[dict]:
    """The ``maps`` entry of ``quant_vals``: one dict per ``(layer, data)``."""
    qv_name = map_type.name
    return [
        {
            "title": f"{qv_name} {layer}",
            "data": data,
            "xlabel": "Slice",
            "ylabel": ylabel,
            "filename": f"{qv_name}_{layer}",
            "raw_data_filename": f"{qv_name}_{layer}.data",
        }
        for layer, data in layers
    ]


def column_means(values: torch.Tensor, nz, axes, shape, lanes) -> List[np.ndarray]:
    """Project the mask's voxels onto the plane of ``axes``: the mean of the
    nonzero, non-NaN ``values`` (a tensor on any device, one per voxel of
    ``nz``) in each column along the other axis, a float64 host table of
    ``shape[axes]`` per lane of ``lanes`` (a bool tensor, or ``None`` for
    every voxel). The dense ``nanmean(where(sel * mask * map == 0, nan,
    ...), axis)``: empty columns are NaN. Summed on the values' device."""
    from dosma_tpu_torch.ops.analytics import scatter_mean

    a, b = axes
    keys = torch.from_numpy(nz[a].astype(np.int64) * shape[b] + nz[b]).to(values.device)
    good = (values != 0) & ~torch.isnan(values)
    tables = []
    for lane in lanes:
        sel = good if lane is None else good & lane
        mean = scatter_mean(keys[sel], values[sel], shape[a] * shape[b])
        tables.append(mean.reshape(shape[a], shape[b]))
    return tables


def largest_cc(mask: np.ndarray, num: int = 1) -> np.ndarray:
    """Keep only the ``num`` largest connected component(s) of a host mask.

    Args:
        mask: Boolean/integer nD mask.
        num: Number of components to retain, by descending voxel count.

    Returns:
        Boolean mask covering the retained components.

    Raises:
        ValueError: If the mask has no nonzero voxels.
    """
    import scipy.ndimage as sni

    labels, n_components = sni.label(np.asarray(mask))
    if n_components == 0:
        raise ValueError("No non-zero values: no connected components")
    if n_components == 1:
        return labels.astype(bool)
    # Voxel count per label; label 0 (background) never competes.
    counts = np.bincount(labels.ravel())
    counts[0] = 0
    if num == 1:
        return labels == counts.argmax()
    keep = np.argsort(counts)[::-1][:num]
    return np.isin(labels, keep[counts[keep] > 0])
