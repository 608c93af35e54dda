"""DICOM reader/writer with tag-based volume grouping.

Counterpart of ``dosma_tpu/core/io/dicom_io.py`` (a copy, re-pointed at the
port's modules): a behavior-parity re-design of DOSMA's
``dosma/core/io/dicom_io.py`` on top of the from-scratch
:mod:`dosma_tpu_torch.core.io.dicom` codec. Volumes come out on the host
(numpy); :func:`dosma_tpu_torch.core.io.prefetch.load_to_device` puts them
on a card.

  - ``DicomReader.load``: dir/file(s)/bytes → list of ``MedicalVolume``
    grouped by DICOM tag(s) (default ``"EchoNumbers"``), natural-sorted
    filenames then optional ``sort_by`` tags (ref ``dicom_io.py:202-316``).
  - LPS→RAS affine construction from ImageOrientationPatient / PixelSpacing /
    ImagePositionPatient with the k-vector from consecutive slice positions
    (ref ``to_RAS_affine``, ``dicom_io.py:495-568``).
  - ``DicomWriter.save``: one file per slice, header-orientation reformat,
    bit-depth coercion, ``I%04d.dcm`` naming (ref ``dicom_io.py:324-487``).
"""

from __future__ import annotations

import copy
import itertools
import os
import re
from concurrent.futures import ThreadPoolExecutor
from math import ceil, log10
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from dosma_tpu_torch.core import orientation as stdo
from dosma_tpu_torch.core.io.dicom import Dataset, read_dicom, read_dicom_bytes, write_dicom
from dosma_tpu_torch.core.io.format_io import DataReader, DataWriter, ImageDataFormat
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.defaults import AFFINE_DECIMAL_PRECISION, SCANNER_ORIGIN_DECIMAL_PRECISION
from dosma_tpu_torch.utils.natsort import index_natsorted, natsorted

__all__ = ["DicomReader", "DicomWriter", "to_RAS_affine"]

_NoValue = object()
PATH_LIKE = (str, os.PathLike)


def _wrap_as_tuple(x, default=None):
    if default is not None and not x:
        return default
    if isinstance(x, str) or not isinstance(x, Sequence):
        return (x,)
    return tuple(x)


def _unpack_dicom_attr(header: Dataset, attr, required: bool = False):
    if not required:
        return header.get(attr)
    try:
        return header[attr].value
    except KeyError:
        raise KeyError(f"Tag {attr} missing from dicom")


class DicomReader(DataReader):
    """Read DICOM files into MedicalVolumes grouped by tag value(s).

    Args:
        num_workers: worker threads for file parsing (0 = serial).
        verbose: show progress bar.
        group_by: tag keyword(s)/number(s) used to split slices into volumes.
        sort_by: tag keyword(s)/number(s) used to sort slices within groups.
        ignore_ext: accept files regardless of extension.
        default_ornt: fallback in-plane orientation if undeterminable.
    """

    data_format_code = ImageDataFormat.dicom

    def __init__(
        self,
        num_workers: int = 0,
        verbose: bool = False,
        group_by: Union[str, int, Sequence[Union[str, int]]] = "EchoNumbers",
        sort_by: Union[str, int, Sequence[Union[str, int]]] = None,
        ignore_ext: bool = False,
        default_ornt: Tuple[str, str] = None,
    ):
        self.num_workers = num_workers
        self.verbose = verbose
        self.group_by = group_by
        self.sort_by = sort_by
        self.ignore_ext = ignore_ext
        self.default_ornt = default_ornt

    def get_files(self, path, ignore_ext: bool = None) -> List[str]:
        """List dicom files in a directory (hidden files skipped, natural order)."""
        ignore_ext = self.ignore_ext if ignore_ext is None else ignore_ext
        if os.path.isdir(path):
            candidates = [
                os.path.join(path, f)
                for f in os.listdir(path)
                if not f.startswith(".") and os.path.isfile(os.path.join(path, f))
            ]
            if not ignore_ext:
                candidates = [f for f in candidates if self.data_format_code.is_filetype(f)]
            return natsorted(candidates)
        raise NotADirectoryError(f"{path} is not a directory")

    def _handle_files(self, path_or_files, ignore_ext: bool) -> List[str]:
        if isinstance(path_or_files, PATH_LIKE):
            path = str(path_or_files)
            if os.path.isdir(path):
                files = self.get_files(path, ignore_ext=ignore_ext)
            elif os.path.isfile(path):
                files = [path]
            else:
                raise FileNotFoundError(f"{path} not found")
        else:
            files = [str(p) for p in path_or_files]
            missing = [f for f in files if not os.path.isfile(f)]
            if missing:
                raise FileNotFoundError(f"Files not found: {missing}")
            files = natsorted(files)
        if not files:
            raise FileNotFoundError(f"No valid dicom files found in {path_or_files}")
        return files

    def load(
        self,
        path_or_bytes,
        group_by=_NoValue,
        sort_by=_NoValue,
        ignore_ext=_NoValue,
        default_ornt=_NoValue,
    ) -> List[MedicalVolume]:
        group_by = self.group_by if group_by is _NoValue else group_by
        sort_by = self.sort_by if sort_by is _NoValue else sort_by
        ignore_ext = self.ignore_ext if ignore_ext is _NoValue else ignore_ext
        default_ornt = self.default_ornt if default_ornt is _NoValue else default_ornt

        group_by = _wrap_as_tuple(group_by, default=())
        sort_by = _wrap_as_tuple(sort_by, default=())

        if isinstance(path_or_bytes, PATH_LIKE) or (
            isinstance(path_or_bytes, (list, tuple))
            and path_or_bytes
            and isinstance(path_or_bytes[0], PATH_LIKE)
        ):
            files = self._handle_files(path_or_bytes, ignore_ext)
            if self.num_workers:
                # The C++ batch reader (built at first use; a failed build raises).
                from dosma_tpu_torch.core.io import _native

                dicom_slices = _native.read_dicom_files(files)
            else:
                dicom_slices = [read_dicom(f) for f in files]
        else:
            blobs = path_or_bytes if isinstance(path_or_bytes, (list, tuple)) else [path_or_bytes]
            dicom_slices = [read_dicom_bytes(b) for b in blobs]

        dicom_slices = _expand_multiframe(dicom_slices)
        return list(self._group_parsed(dicom_slices, group_by, sort_by, default_ornt))

    def _group_parsed(self, dicom_slices, group_by, sort_by, default_ornt):
        """Sort, group, and yield fully-parsed slices as MedicalVolumes.

        The single grouping implementation behind both :meth:`load` and
        :meth:`iter_groups` (the two previously carried drifting copies)."""
        for _group in group_by:
            if _group not in dicom_slices[0]:
                raise KeyError(f"Tag {_group} does not exist in dicom")
        if sort_by:
            try:
                idxs = index_natsorted(
                    dicom_slices,
                    key=lambda x: tuple(
                        _unpack_dicom_attr(x, attr, required=True) for attr in sort_by
                    ),
                )
                dicom_slices = [dicom_slices[i] for i in idxs]
            except KeyError as e:
                raise KeyError(f"Tag not found in dicom - {e}")
        grouped: Dict[tuple, List[Dataset]] = {}
        for ds in dicom_slices:
            key = tuple(_unpack_dicom_attr(ds, attr, required=True) for attr in group_by)
            grouped.setdefault(key, []).append(ds)
        for key in sorted(grouped.keys()):
            headers = grouped[key]
            arrs = []
            for ds in headers:
                arr2d = ds.pixel_array
                if arr2d.ndim != 2:
                    raise ValueError(
                        f"Expected one 2D frame per (expanded) dataset, got shape {arr2d.shape}"
                    )
                arrs.append(arr2d)
            arr = np.stack(arrs, axis=-1)
            affine = to_RAS_affine(headers, default_ornt=default_ornt)
            yield MedicalVolume(arr, affine, headers=headers)

    def iter_groups(
        self,
        path_or_bytes,
        group_by=_NoValue,
        sort_by=_NoValue,
        ignore_ext=_NoValue,
        default_ornt=_NoValue,
    ):
        """Yield one grouped :class:`MedicalVolume` at a time, lazily.

        Pipelined counterpart of :meth:`load`: a cheap metadata-only pass
        (``stop_before_pixels``) groups and orders the files, then each
        group's slices are fully parsed ON DEMAND as the generator is
        advanced. A consumer that issues an async ``jax.device_put`` per
        yielded group therefore overlaps the H2D transfer of group *k* with
        the pixel parsing of group *k+1* (see
        :func:`dosma_tpu_torch.core.io.prefetch.load_to_device`).

        Groups are yielded in sorted group-key order, matching :meth:`load`.
        """
        group_by = self.group_by if group_by is _NoValue else group_by
        sort_by = self.sort_by if sort_by is _NoValue else sort_by
        ignore_ext = self.ignore_ext if ignore_ext is _NoValue else ignore_ext
        default_ornt = self.default_ornt if default_ornt is _NoValue else default_ornt
        group_by = _wrap_as_tuple(group_by, default=())
        sort_by = _wrap_as_tuple(sort_by, default=())

        # Gather raw bytes (one disk read; reused by both parse passes).
        if isinstance(path_or_bytes, PATH_LIKE) or (
            isinstance(path_or_bytes, (list, tuple))
            and path_or_bytes
            and isinstance(path_or_bytes[0], PATH_LIKE)
        ):
            files = self._handle_files(path_or_bytes, ignore_ext)
            if self.num_workers:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    blobs = list(ex.map(lambda f: open(f, "rb").read(), files))
            else:
                blobs = [open(f, "rb").read() for f in files]
        else:
            blobs = (
                list(path_or_bytes) if isinstance(path_or_bytes, (list, tuple)) else [path_or_bytes]
            )

        # Pass 1 — metadata only: group/sort keys without touching pixels.
        light = [read_dicom_bytes(b, stop_before_pixels=True) for b in blobs]
        if any(int(ds.get("NumberOfFrames") or 1) > 1 for ds in light):
            # Multi-frame groups/sort keys live per-frame inside the file;
            # the two-pass pixel-deferral scheme cannot apply. Parse fully
            # (on the worker pool when configured), expand frames, and
            # group eagerly (still yielded per group).
            if self.num_workers:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    parsed = list(ex.map(read_dicom_bytes, blobs))
            else:
                parsed = [read_dicom_bytes(b) for b in blobs]
            yield from self._group_parsed(
                _expand_multiframe(parsed), group_by, sort_by, default_ornt
            )
            return
        for _group in group_by:
            if _group not in light[0]:
                raise KeyError(f"Tag {_group} does not exist in dicom")
        order = range(len(light))
        if sort_by:
            try:
                order = index_natsorted(
                    light,
                    key=lambda x: tuple(
                        _unpack_dicom_attr(x, attr, required=True) for attr in sort_by
                    ),
                )
            except KeyError as e:
                raise KeyError(f"Tag not found in dicom - {e}")

        grouped: Dict[tuple, List[int]] = {}
        for i in order:
            key = tuple(_unpack_dicom_attr(light[i], attr, required=True) for attr in group_by)
            grouped.setdefault(key, []).append(i)

        # Pass 2 — full parse per group, deferred until the group is pulled.
        def parse_group(idxs):
            if self.num_workers:
                with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                    return list(ex.map(read_dicom_bytes, [blobs[i] for i in idxs]))
            return [read_dicom_bytes(blobs[i]) for i in idxs]

        for key in sorted(grouped.keys()):
            headers = parse_group(grouped[key])
            arrs = []
            for ds in headers:
                arr2d = ds.pixel_array
                if arr2d.ndim != 2:
                    raise ValueError(
                        f"Expected one 2D frame per dataset, got shape {arr2d.shape}"
                    )
                arrs.append(arr2d)
            affine = to_RAS_affine(headers, default_ornt=default_ornt)
            yield MedicalVolume(np.stack(arrs, axis=-1), affine, headers=headers)

    read = DataReader.__call__


class DicomWriter(DataWriter):
    """Write MedicalVolumes as one DICOM file per slice (ref ``dicom_io.py:324-487``)."""

    data_format_code = ImageDataFormat.dicom

    def __init__(
        self,
        num_workers: int = 0,
        verbose: bool = False,
        fname_fmt: str = None,
        sort_by: Union[str, int, Sequence[Union[str, int]]] = None,
        transfer_syntax: str = None,
        multi_frame: bool = False,
    ):
        self.num_workers = num_workers
        self.verbose = verbose
        self.fname_fmt = fname_fmt
        self.sort_by = sort_by
        #: Optional compressed transfer syntax UID for the written slices
        #: (any member of ``codecs.COMPRESSED_SYNTAXES``, e.g. RLE or
        #: JPEG-LS Lossless). Default writes Explicit VR Little Endian.
        self.transfer_syntax = transfer_syntax
        #: Write ONE Enhanced MR Image Storage file holding every slice as a
        #: frame (functional-group geometry) instead of one file per slice.
        #: Composes with ``transfer_syntax`` (frames encode individually).
        #: Beyond the reference, whose writer/reader are per-slice-only.
        self.multi_frame = multi_frame

    def save(self, volume: MedicalVolume, dir_path: str, fname_fmt=_NoValue,
             sort_by=_NoValue, transfer_syntax=_NoValue, multi_frame=_NoValue):
        fname_fmt = self.fname_fmt if fname_fmt is _NoValue else fname_fmt
        sort_by = self.sort_by if sort_by is _NoValue else sort_by
        transfer_syntax = (
            self.transfer_syntax if transfer_syntax is _NoValue else transfer_syntax
        )
        multi_frame = self.multi_frame if multi_frame is _NoValue else multi_frame

        headers = volume.headers()
        if headers is None:
            raise ValueError("MedicalVolume headers must be initialized to save as a dicom")
        volume = volume.cpu()  # a volume on a card is written from the host

        sort_by = _wrap_as_tuple(sort_by, default=())

        # Headers must vary along exactly one spatial dim; reformat it last.
        single_dim = [i for i, dim in enumerate(headers.shape[:3]) if dim == 1]
        full_dim = [i for i in range(3) if i not in single_dim]
        if len(full_dim) > 1:
            raise ValueError(
                f"Only one spatial dimension can have headers. Got {len(full_dim)} - "
                f"headers.shape={headers.shape[:3]}"
            )
        if not full_dim:
            full_dim = [single_dim.pop()]
        new_orientation = tuple(volume.orientation[x] for x in single_dim + full_dim)
        volume = volume.reformat(new_orientation)
        assert volume.headers().shape[:3] == (1, 1, volume.shape[2])

        if len(volume.shape) > 3:
            shape = volume.shape[3:]
            multi_volumes = np.empty(shape, dtype=object)
            for dims in itertools.product(*[range(x) for x in shape]):
                multi_volumes[dims] = _format_volume_to_header(volume[(Ellipsis,) + dims])
            multi_volumes = multi_volumes.flatten()
            volume_arr = np.concatenate([v.volume for v in multi_volumes], axis=-1)
            headers = np.concatenate([v.headers(flatten=True) for v in multi_volumes], axis=-1)
        else:
            volume = _format_volume_to_header(volume)
            volume_arr = np.asarray(volume.volume)
            headers = volume.headers(flatten=True)

        assert headers.ndim == 1
        assert volume_arr.shape[2] == len(headers), (
            f"Dimension mismatch - {volume_arr.shape[-1]} slices but {len(headers)} headers"
        )

        if sort_by:
            idxs = np.asarray(
                index_natsorted(
                    headers,
                    key=lambda h: tuple(_unpack_dicom_attr(h, k, required=True) for k in sort_by),
                )
            )
            headers = headers[idxs]
            volume_arr = volume_arr[..., idxs]

        os.makedirs(dir_path, exist_ok=True)
        num_slices = len(headers)

        if multi_frame:
            fname = (fname_fmt or "I%04d.dcm") % 1
            _write_multiframe_file(
                volume_arr, headers, os.path.join(dir_path, fname), transfer_syntax
            )
            return

        filename_format = fname_fmt or ("I%0" + str(max(4, ceil(log10(max(num_slices, 2))))) + "d.dcm")
        filepaths = [os.path.join(dir_path, filename_format % (s + 1)) for s in range(num_slices)]

        if self.num_workers:
            with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                list(
                    ex.map(
                        lambda args: _write_dicom_file(*args),
                        [
                            (volume_arr[..., s], headers[s], filepaths[s], transfer_syntax)
                            for s in range(num_slices)
                        ],
                    )
                )
        else:
            for s in range(num_slices):
                _write_dicom_file(
                    volume_arr[..., s], headers[s], filepaths[s], transfer_syntax
                )

    write = DataWriter.__call__


def _expand_multiframe(dicom_slices: List[Dataset]) -> List[Dataset]:
    """Expand any multi-frame datasets into per-frame classic datasets."""
    if all(int(ds.get("NumberOfFrames") or 1) <= 1 for ds in dicom_slices):
        return dicom_slices
    from dosma_tpu_torch.core.io.dicom.multiframe import expand_frames

    return list(itertools.chain.from_iterable(expand_frames(ds) for ds in dicom_slices))


def to_RAS_affine(headers: List[Dataset], default_ornt: Tuple[str, str] = None) -> np.ndarray:
    """Build the RAS+ affine from DICOM (LPS+) headers (ref ``dicom_io.py:495-568``)."""
    try:
        im_dir = headers[0].ImageOrientationPatient
    except AttributeError:
        im_dir = _decode_inplane_direction(headers, default_ornt=default_ornt)
        if im_dir is None:
            raise RuntimeError("Could not determine in-plane directions from headers.")
    try:
        in_plane_pixel_spacing = headers[0].PixelSpacing
    except AttributeError:
        try:
            # Projection-geometry series carry ImagerPixelSpacing instead
            # (reference fallback, ``dicom_io.py:513-520``).
            in_plane_pixel_spacing = headers[0].ImagerPixelSpacing
        except AttributeError:
            raise RuntimeError(
                "Could not determine in-plane pixel spacing from headers. "
                "Neither 'PixelSpacing' nor 'ImagerPixelSpacing' found."
            )

    i_vec = np.round(np.asarray(im_dir[:3], dtype=np.float64), AFFINE_DECIMAL_PRECISION)
    j_vec = np.round(np.asarray(im_dir[3:], dtype=np.float64), AFFINE_DECIMAL_PRECISION)
    i_vec = i_vec * in_plane_pixel_spacing[0]
    j_vec = j_vec * in_plane_pixel_spacing[1]

    # k-vector from consecutive slice positions (preferred, avoids rounding
    # issues); fall back to cross product scaled by slice thickness.
    if len(headers) > 1:
        k_vec = np.asarray(headers[1].ImagePositionPatient, dtype=np.float64) - np.asarray(
            headers[0].ImagePositionPatient, dtype=np.float64
        )
    else:
        slice_thickness = headers[0].get("SliceThickness", 1.0) or 1.0
        i_norm = i_vec / np.linalg.norm(i_vec)
        j_norm = j_vec / np.linalg.norm(j_vec)
        k_norm = np.cross(i_norm, j_norm)
        k_vec = k_norm / np.linalg.norm(k_norm) * slice_thickness
        sbs = headers[0].get("SpacingBetweenSlices")
        if sbs is not None and sbs < 0:
            k_vec *= -1
    k_vec = np.round(k_vec, AFFINE_DECIMAL_PRECISION)

    orientation = np.stack([j_vec, i_vec, k_vec], axis=1)
    scanner_origin = headers[0].get("ImagePositionPatient", np.zeros(3))
    scanner_origin = np.round(np.asarray(scanner_origin, dtype=np.float64), SCANNER_ORIGIN_DECIMAL_PRECISION)

    affine = np.zeros((4, 4))
    affine[:3, :3] = orientation
    affine[:3, 3] = scanner_origin
    affine[:2, :] = -1 * affine[:2, :]  # LPS → RAS
    affine[3, 3] = 1
    affine[affine == 0] = 0
    return affine


def _decode_inplane_direction(headers, default_ornt=None):
    """In-plane direction fallback via PatientOrientation or ``default_ornt``
    (ref ``dicom_io.py:571-605``)."""
    _patient_ornt_to_nib = {"H": "S", "F": "I"}

    if len(headers) == 1 and headers[0].get("PatientOrientation"):
        ornt = [_patient_ornt_to_nib.get(k[:1], k[:1]) for k in headers[0].PatientOrientation]
        ornt = stdo.orientation_nib_to_standard(ornt)
        affine = stdo.to_affine(ornt)
        affine[:2, :] = -1 * affine[:2, :]
        return np.concatenate([affine[:3, 0], affine[:3, 1]], axis=0)

    if default_ornt:
        affine = stdo.to_affine(default_ornt)
        affine[:2, :] = -1 * affine[:2, :]
        return np.concatenate([affine[:3, 0], affine[:3, 1]], axis=0)
    return None


def _format_volume_to_header(volume: MedicalVolume) -> MedicalVolume:
    """Reformat a 3D volume to the orientation implied by its headers."""
    headers = volume.headers()
    assert headers.shape == (1, 1, volume.shape[2])

    affine = to_RAS_affine(list(headers.flatten()))
    orientation = stdo.orientation_from_affine(affine)

    if tuple(affine[:3, 3]) != volume.scanner_origin:
        raise ValueError(
            "Scanner origin mismatch. Currently we do not handle mismatch in "
            "scanner origin (i.e. cannot flip across axis)"
        )

    volume = volume.reformat(orientation)
    assert volume.headers().shape == (1, 1, volume.shape[2])
    return volume


def _write_multiframe_file(volume_arr: np.ndarray, headers, file_path: str,
                           transfer_syntax: str = None):
    """Write the whole stack as ONE Enhanced MR Image Storage object.

    Per-slice geometry/timing moves into the shared + per-frame functional
    groups (PS3.3 C.7.6.16): PixelMeasures/PlaneOrientation shared;
    PlanePosition, FrameContent (InStackPositionNumber), and MREcho
    (EffectiveEchoTime, when the slice headers carry EchoTime) per frame.
    The classic tags that vary per frame are stripped from the top level.
    This exceeds the reference, which can neither write nor read
    multi-frame objects (``dicom_io.py:303-314`` stacks per-file
    pixel_array blindly); our reader re-expands these files transparently
    (``dicom/multiframe.py``), so a round trip regroups multi-echo stacks
    by the synthesized EchoNumbers.
    """
    from dosma_tpu_torch.core.io.dicom import tags as T
    from dosma_tpu_torch.core.io.dicom.writer import generate_uid

    n = len(headers)
    base = copy.deepcopy(headers[0])

    arr = np.ascontiguousarray(np.moveaxis(volume_arr, -1, 0))  # (F, R, C)
    expected = (int(base.Rows), int(base.Columns))
    assert arr.shape[1:] == expected, (
        f"In-plane dimension mismatch - expected shape {expected}, got {arr.shape[1:]}"
    )
    bits_allocated = int(base.BitsAllocated)
    if arr.dtype.itemsize * 8 != bits_allocated:
        arr = _update_np_dtype(arr, bits_allocated)
    base.set_value("PixelRepresentation", 1 if arr.dtype.kind == "i" else 0)

    shared = Dataset()
    pm = Dataset()
    for kw in ("PixelSpacing", "SliceThickness", "SpacingBetweenSlices"):
        v = base.get(kw)
        if v is not None:
            pm.set_value(kw, v)
    shared.set_value("PixelMeasuresSequence", [pm])
    iop = base.get("ImageOrientationPatient")
    if iop is not None:
        po = Dataset()
        po.set_value("ImageOrientationPatient", iop)
        shared.set_value("PlaneOrientationSequence", [po])

    perframe = []
    for i, h in enumerate(headers):
        item = Dataset()
        ipp = h.get("ImagePositionPatient")
        if ipp is not None:
            pp = Dataset()
            pp.set_value("ImagePositionPatient", [float(x) for x in ipp])
            item.set_value("PlanePositionSequence", [pp])
        fcs = Dataset()
        fcs.set_value("InStackPositionNumber", i + 1)
        item.set_value("FrameContentSequence", [fcs])
        et = h.get("EchoTime")
        if et is not None:
            me = Dataset()
            me.set_value("EffectiveEchoTime", float(et))
            item.set_value("MREchoSequence", [me])
        perframe.append(item)

    # Echo identity must survive the round trip: the reader regroups by
    # EffectiveEchoTime. A multi-echo stack without per-slice EchoTime has
    # nothing standard to carry that identity in a multi-frame object.
    echo_numbers = {
        str(h.get("EchoNumbers")) for h in headers if h.get("EchoNumbers") is not None
    }
    have_echo_times = any(h.get("EchoTime") is not None for h in headers)
    if len(echo_numbers) > 1 and not have_echo_times:
        raise ValueError(
            "multi_frame write requires per-slice EchoTime to preserve echo "
            "identity (EchoNumbers alone has no standard multi-frame encoding); "
            "write per-slice files instead (multi_frame=False)"
        )

    # Frame-varying classic tags live in the functional groups now. Keep
    # frame-0's ImagePositionPatient/InstanceNumber at the top level so a
    # 1-frame file (which the reader returns unexpanded) stays readable;
    # the per-frame functional groups override them for real stacks.
    if len(echo_numbers) > 1 and "EchoNumbers" in base:
        del base["EchoNumbers"]
    # Tags that vary across slices but have no functional-group encoding
    # here would otherwise freeze frame 0's value onto every frame.
    for kw in (
        "SliceLocation", "AcquisitionTime", "ContentTime", "TriggerTime",
        "AcquisitionNumber", "TemporalPositionIdentifier",
        "WindowCenter", "WindowWidth",
        "SmallestImagePixelValue", "LargestImagePixelValue",
    ):
        vals = {str(h.get(kw)) for h in headers}
        if len(vals) > 1 and kw in base:
            del base[kw]
    base.set_value("NumberOfFrames", n)
    base.set_value("SharedFunctionalGroupsSequence", [shared])
    base.set_value("PerFrameFunctionalGroupsSequence", perframe)
    base.set_value("SOPClassUID", T.ENHANCED_MR_IMAGE_STORAGE)
    base.set_value("SOPInstanceUID", generate_uid())
    if base.file_meta is not None:
        base.file_meta.set_value("MediaStorageSOPClassUID", base.get("SOPClassUID"))
        base.file_meta.set_value("MediaStorageSOPInstanceUID", base.get("SOPInstanceUID"))
    base["PixelData"] = arr.tobytes()

    write_dicom(base, file_path, transfer_syntax=transfer_syntax)


def _write_dicom_file(np_slice: np.ndarray, header: Dataset, file_path: str,
                      transfer_syntax: str = None):
    """Replace PixelData with the 2D slice and write to ``file_path``."""
    header = copy.deepcopy(header)
    expected = (int(header.Rows), int(header.Columns))
    assert np_slice.shape == expected, (
        f"In-plane dimension mismatch - expected shape {expected}, got {np_slice.shape}"
    )

    bits_allocated = int(header.BitsAllocated)
    np_slice_bytes = np_slice.tobytes()
    bit_depth = int(len(np_slice_bytes) / (np_slice.shape[0] * np_slice.shape[1]) * 8)
    if bit_depth != bits_allocated:
        np_slice = _update_np_dtype(np_slice, bits_allocated)
        np_slice_bytes = np_slice.tobytes()
        bit_depth = np_slice.dtype.itemsize * 8
    assert bit_depth == bits_allocated, (
        f"Bit depth mismatch: Expected {bits_allocated} got {bit_depth}"
    )

    header.set_value("PixelRepresentation", 1 if np_slice.dtype.kind == "i" else 0)
    header["PixelData"] = np_slice_bytes
    write_dicom(header, file_path, transfer_syntax=transfer_syntax)


def _update_np_dtype(arr: np.ndarray, bit_depth: int) -> np.ndarray:
    """Coerce to an 8/16-bit dtype whose range covers ``arr`` (ref ``dicom_io.py:670-720``)."""
    assert bit_depth in (8, 16), "Only bit-depths of 8 and 16 are currently supported."
    dtype_dict = {
        8: [(np.int8, -128, 127), (np.uint8, 0, 255)],
        16: [
            (np.uint16, 0, 2**16 - 1),
            (np.int16, -(2**15), 2**15),
            (np.float16, -6.55e4, 6.55e4 - 1),
        ],
    }
    supported_floats = [np.float16]
    curr_min, curr_max = np.min(arr), np.max(arr)
    contains_float = (arr % 1 != 0).any()

    new_dtype = None
    for dtype, dtype_min, dtype_max in dtype_dict[bit_depth]:
        if curr_min < dtype_min or curr_max > dtype_max:
            continue
        new_dtype = dtype
        break
    if not new_dtype:
        raise ValueError(f"Cannot cast numpy array ({arr.dtype}) to bit-depth of {bit_depth} bits")
    if contains_float and new_dtype not in supported_floats:
        raise TypeError(f"Array contains float. Cannot cast ({arr.dtype}) to {new_dtype}")
    return arr.astype(new_dtype)
