"""Scan save/load: a pickle of the scan's state, with its volumes written
as image files (counterpart of ``dosma_tpu/scan_sequences/scan_io.py``).

``save`` writes ``<save_dir>/<NAME>.data``; with ``save_custom`` each
MedicalVolume-valued attribute becomes an image file and a
``{"__dtype__": MedicalVolume, "__value__": <path>}`` placeholder. ``load``
resolves the placeholders and, when that fails, re-reads the DICOM files
that ``from_dicom`` recorded. One container walker (:func:`_walk`) serves
both directions. ``from_dicom(to_device=...)`` reads the series straight
onto a card (:func:`dosma_tpu_torch.core.io.prefetch.load_to_device`).
"""

from __future__ import annotations

import inspect
import os
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Set, Union

from dosma_tpu_torch.core.io.dicom_io import DicomReader
from dosma_tpu_torch.core.io.format_io import ImageDataFormat
from dosma_tpu_torch.core.io import format_io_utils as fio_utils
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.utils import io_utils

__all__ = ["ScanIOMixin"]

_PATHLIKE = (str, Path, os.PathLike)


def _is_container(value) -> bool:
    return not isinstance(value, str) and isinstance(value, (list, tuple, set))


def _walk(value, leaf_fn: Callable[[Any, str], Any], path: str = ""):
    """Apply ``leaf_fn(leaf, path)`` to every non-container element,
    rebuilding dicts/lists/tuples/sets around the results. Mapping keys
    extend ``path`` by name, sequence elements by zero-padded index —
    producing the per-element file paths of the save format."""
    if isinstance(value, Mapping):
        return {k: _walk(v, leaf_fn, os.path.join(path, str(k))) for k, v in value.items()}
    if _is_container(value):
        items = list(value)
        walked = (
            _walk(v, leaf_fn, os.path.join(path, f"{i:03d}")) for i, v in enumerate(items)
        )
        return type(value)(walked)
    return leaf_fn(value, path)


def _contains_type(value, types) -> bool:
    """True if ``value`` is or recursively contains an instance of ``types``."""
    import numpy as np

    if isinstance(value, types):
        return True
    if isinstance(value, Mapping):
        return any(_contains_type(x, types) for pair in value.items() for x in pair)
    if _is_container(value):
        return any(_contains_type(v, types) for v in value)
    if isinstance(value, np.ndarray) and value.dtype == object:
        return any(_contains_type(v, types) for v in value.flatten())
    return False


class ScanIOMixin:
    """Mixin providing from_dicom / from_dict / save / load for scans."""

    NAME: str = ""
    __DEFAULT_SPLIT_BY__ = "EchoNumbers"

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    @classmethod
    def from_dicom(
        cls,
        dir_or_files,
        group_by=None,
        ignore_ext: bool = False,
        num_workers: int = 0,
        verbose: bool = False,
        to_device=None,
        **kwargs,
    ):
        """Load a scan from DICOM files, recording the absolute source paths
        so that a partial save can be reloaded later.

        ``to_device``: a device (or ``True`` for the default device, the
        first CUDA card) to read each grouped volume onto; the copy of echo
        *k* runs while echo *k+1* is parsed
        (:func:`dosma_tpu_torch.core.io.prefetch.load_to_device`), so the
        segmentation and the maps start with the pixels on the card.
        """
        effective_group = cls.__DEFAULT_SPLIT_BY__ if group_by is None else group_by
        if to_device is not None and to_device is not False:
            from dosma_tpu_torch.core.io.prefetch import load_to_device

            volumes = load_to_device(
                dir_or_files,
                group_by=effective_group,
                device=None if to_device is True else to_device,
                num_workers=max(num_workers, 1),
                ignore_ext=ignore_ext,
            )
        else:
            reader = DicomReader(num_workers, verbose)
            volumes = reader.load(
                dir_or_files,
                effective_group,
                ignore_ext=ignore_ext,
            )

        if isinstance(dir_or_files, _PATHLIKE):
            source = os.path.abspath(dir_or_files)
        else:
            source = type(dir_or_files)(os.path.abspath(x) for x in dir_or_files)

        scan = cls(volumes, **kwargs)
        scan._from_file_args = {
            "dir_or_files": source,
            "ignore_ext": ignore_ext,
            "group_by": group_by if group_by is not None else cls.__DEFAULT_SPLIT_BY__,
            "_type": "dicom",
        }
        return scan

    @classmethod
    def from_dict(cls, data: Dict[str, Any], force: bool = False):
        """Reconstruct a scan: constructor params are pulled from ``data``
        by signature introspection, the rest become attributes
        (ref ``scan_io.py:82-120``)."""
        data = cls.load_custom_data(cls._convert_attr_name(data))

        ctor_params = set(inspect.signature(cls).parameters)
        scan = cls(**{k: v for k, v in data.items() if k in ctor_params})
        cls._assign_attrs(scan, {k: v for k, v in data.items() if k not in ctor_params}, force)
        return scan

    @classmethod
    def _assign_attrs(cls, scan, attrs: Dict[str, Any], force: bool = False):
        for name, value in attrs.items():
            if force or hasattr(scan, name):
                setattr(scan, name, value)
            else:
                warnings.warn(f"{cls.__name__} does not have attribute {name}. Skipping...")

    # ------------------------------------------------------------------
    # Save
    # ------------------------------------------------------------------
    def save(
        self,
        path: str,
        save_custom: bool = False,
        image_data_format: ImageDataFormat = None,
        num_workers: int = 0,
    ) -> str:
        """Pickle serializable attrs to ``path/NAME.data``; with
        ``save_custom``, MedicalVolume attrs are written as image files and
        replaced by path placeholders (ref ``scan_io.py:122-180``)."""
        if image_data_format is None:
            image_data_format = preferences.image_data_format

        os.makedirs(path, exist_ok=True)
        state = {attr: getattr(self, attr) for attr in self.__serializable_variables__()}
        # Snapshot the reference header (sans pixel bytes) so header-derived
        # metadata survives reload even when volumes are externalized to a
        # header-less image format. ``ScanSequence.ref_dicom`` falls back to
        # this when the reloaded volumes carry no headers.
        ref = getattr(self, "ref_dicom", None)
        if ref is not None:
            ref = ref.copy()
            if "PixelData" in ref:
                del ref["PixelData"]
            state["_ref_dicom_state"] = ref
        if save_custom:
            state = self._save(
                state, path, image_data_format=image_data_format, num_workers=num_workers
            )

        out_file = os.path.join(path, f"{self.NAME}.data")
        io_utils.save_pik(out_file, state)
        return out_file

    def _save(self, metadata: Dict[str, Any], save_dir: str, fname_fmt: Dict = None, **kwargs):
        """Externalize each top-level attr under ``save_dir/<attr>/...``.
        ``fname_fmt`` maps types to basename templates (default:
        MedicalVolume -> ``image-{}``)."""
        fname_fmt = {MedicalVolume: "image-{}", **(fname_fmt or {})}

        # Start the copy to the host of every card volume up front, so the
        # transfers overlap the encoding of earlier volumes in the loop.
        def _prefetch(value, _path):
            if isinstance(value, MedicalVolume):
                value.copy_to_host_async()
            return value

        _walk(metadata, _prefetch)

        out = {}
        for attr, value in metadata.items():
            root = os.path.abspath(os.path.join(save_dir, attr))
            try:
                out[attr] = self.save_custom_data(value, root, fname_fmt, **kwargs)
            except Exception as e:
                raise RuntimeError(f"Failed to save metadata {attr} - {e}")
        return out

    def save_custom_data(self, metadata, paths, fname_fmt: Dict = None, **kwargs):
        """Recursively externalize savable leaves inside containers
        (ref ``scan_io.py:290-330``)."""
        fname_fmt = fname_fmt or {}

        def leaf(value, rel_path):
            full = os.path.join(paths, rel_path) if rel_path else paths
            template = next(
                (fname_fmt[t] for t in type(value).__mro__ if t in fname_fmt), None
            )
            return self._save_custom_data_base(value, full, template, **kwargs)

        return _walk(metadata, leaf)

    def _save_custom_data_base(self, metadata, path, formatter: str = None, **kwargs):
        if formatter:
            path = os.path.join(os.path.dirname(path), formatter.format(os.path.basename(path)))
        if isinstance(metadata, MedicalVolume):
            fmt = kwargs.get("image_data_format", preferences.image_data_format)
            path = fio_utils.convert_image_data_format(path, fmt)
            metadata.save_volume(path, data_format=fmt)
            return {"__dtype__": MedicalVolume, "__value__": path}
        return metadata

    # ------------------------------------------------------------------
    # Load
    # ------------------------------------------------------------------
    @classmethod
    def load(cls, path_or_data: Union[str, Dict], num_workers: int = 0):
        """Load a saved scan. If reconstruction from the pickle fails (e.g.
        volumes were not saved), re-read the original dicoms recorded by
        ``from_dicom`` (ref ``scan_io.py:182-245``)."""
        if isinstance(path_or_data, _PATHLIKE):
            data_file = path_or_data
            if os.path.isdir(data_file):
                data_file = os.path.join(data_file, f"{cls.NAME}.data")
            if not os.path.isfile(data_file):
                raise FileNotFoundError(f"File {data_file} does not exist")
            data = io_utils.load_pik(data_file)
        else:
            data = path_or_data

        try:
            return cls.from_dict(data)
        except Exception:
            warnings.warn(
                f"Failed to load {cls.__name__} from data. Trying to load from dicom file."
            )

        data = cls.load_custom_data(cls._convert_attr_name(data), num_workers=num_workers)
        scan = cls._reload_from_source(data, num_workers)
        if scan is None:
            raise ValueError(f"Data is insufficient to construct {cls.__name__}")
        cls._assign_attrs(scan, data)
        return scan

    @classmethod
    def _reload_from_source(cls, data: Dict, num_workers: int):
        """Re-read dicoms from either the modern ``_from_file_args`` record
        or the legacy ``dicom_path``/``split_by`` keys."""
        if "_from_file_args" in data:
            dicom_args = dict(data.pop("_from_file_args"))
            assert dicom_args.pop("_type") == "dicom"
            return cls.from_dicom(**dicom_args, num_workers=num_workers)
        if "dicom_path" in data:
            return cls.from_dicom(
                data.pop("dicom_path"),
                ignore_ext=data.pop("ignore_ext", False),
                group_by=data.pop("split_by", cls.__DEFAULT_SPLIT_BY__),
                num_workers=num_workers,
            )
        return None

    @classmethod
    def _convert_attr_name(cls, data: Dict[str, Any]):
        return data

    @classmethod
    def load_custom_data(cls, data: Any, **kwargs):
        """Recursively resolve ``{__dtype__, __value__}`` placeholders
        (ref ``scan_io.py:358-418``)."""

        def leaf(value, _path):
            dtype = type(value)
            if isinstance(value, Mapping) and "__value__" in value:
                dtype, value = value["__dtype__"], value["__value__"]
                if isinstance(value, (Mapping,)) or _is_container(value):
                    # Placeholder wrapped a container: recurse through
                    # load_custom_data (NOT _walk) so placeholders nested
                    # inside the container are themselves intercepted.
                    return cls.load_custom_data(value, **kwargs)
            return cls._load_custom_data_base(value, dtype, **kwargs)

        # Placeholder dicts are themselves Mappings, so intercept them
        # before the generic walker descends into their keys.
        if isinstance(data, Mapping) and "__value__" in data:
            return leaf(data, "")
        if isinstance(data, Mapping):
            return {k: cls.load_custom_data(v, **kwargs) for k, v in data.items()}
        if _is_container(data):
            return type(data)(cls.load_custom_data(v, **kwargs) for v in data)
        return cls._load_custom_data_base(data, type(data), **kwargs)

    @classmethod
    def _load_custom_data_base(cls, data, dtype=None, **kwargs):
        if dtype is None:
            dtype = type(data)
        if isinstance(data, str) and isinstance(dtype, type) and issubclass(dtype, MedicalVolume):
            return fio_utils.generic_load(data, expected_num_volumes=1)
        return data

    # ------------------------------------------------------------------
    def __serializable_variables__(self, ignore_types=None, ignore_attrs=()) -> Set:
        """All instance attrs except headers/MedicalVolumes/Tissues, temp
        paths, dunder/CAPS names, and callables (ref ``scan_io.py:420-447``)."""
        from dosma_tpu_torch.core.io.dicom import Dataset
        from dosma_tpu_torch.tissues.tissue import Tissue

        if ignore_types is None:
            ignore_types = (Dataset, Tissue)

        def keep(attr: str, value) -> bool:
            if attr in ignore_attrs or attr.startswith(("temp", "_temp")):
                return False
            if attr.upper() == attr or (attr.startswith("__") and attr.endswith("__")):
                return False
            if callable(value) or isinstance(value, property):
                return False
            return not _contains_type(value, ignore_types)

        return {a for a, v in self.__dict__.items() if keep(a, v)}
