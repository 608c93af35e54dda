"""Multi-frame → classic per-slice DICOM expansion.

Enhanced multi-frame objects (Enhanced MR Image Storage and friends) pack a
whole stack into one file: PixelData carries ``NumberOfFrames`` frames and
per-slice geometry lives in the functional-group sequences (PS3.3 C.7.6.16)
instead of the classic image-plane module.

The reference stacks per-file ``pixel_array`` blindly
(``dosma/core/io/dicom_io.py:303-314``) and silently builds a
wrong volume for such files; here each frame is promoted to a classic
single-slice :class:`Dataset` — geometry resolved from the shared/per-frame
functional groups, falling back to synthesized slice positions — so the rest
of the reader pipeline (grouping, sorting, affine construction) works
unchanged and correctly.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from dosma_tpu_torch.core.io.dicom import tags as T
from dosma_tpu_torch.core.io.dicom.dataset import Dataset

__all__ = ["expand_frames"]

#: Tags that must NOT propagate from the multi-frame object to the synthetic
#: per-slice datasets.
_STRIP_KEYWORDS = (
    "PixelData",
    "NumberOfFrames",
    "SharedFunctionalGroupsSequence",
    "PerFrameFunctionalGroupsSequence",
)


def _fg(item: Optional[Dataset], seq_keyword: str, attr_keyword: str):
    """Fetch ``attr`` from the first item of functional-group ``seq`` (or None)."""
    if item is None:
        return None
    seq = item.get(seq_keyword)
    if not seq:
        return None
    return seq[0].get(attr_keyword)


def _as_float3(v):
    return [float(x) for x in (v if isinstance(v, (list, tuple)) else [v])]


def expand_frames(ds: Dataset) -> List[Dataset]:
    """Split a multi-frame dataset into per-frame classic datasets.

    Single-frame datasets are returned unchanged (``[ds]``). Per-frame
    geometry / timing comes from, in priority order:

    1. ``PerFrameFunctionalGroupsSequence[i]`` (PlanePosition/PlaneOrientation/
       MREcho/PixelValueTransformation macros),
    2. ``SharedFunctionalGroupsSequence[0]`` (same macros, shared),
    3. the classic top-level tags,
    4. synthesized slice positions ``IPP0 + i * dz * normal`` where ``dz`` is
       SpacingBetweenSlices (fallback SliceThickness, fallback 1.0).

    When per-frame effective echo times are present, a classic ``EchoNumbers``
    index (1-based, ordered by echo time) is synthesized so tag-based volume
    grouping (default ``group_by="EchoNumbers"``) works on enhanced exports.
    """
    nframes = ds.get("NumberOfFrames")
    nframes = int(nframes) if nframes else 1
    if nframes <= 1 or "PixelData" not in ds:
        return [ds]

    arr = ds.pixel_array  # (F, R, C) or (F, R, C, S)
    if arr.ndim == 2:  # NumberOfFrames lied; treat as single-slice
        return [ds]
    if arr.ndim not in (3, 4):
        raise ValueError(f"Unexpected multi-frame pixel array rank {arr.ndim}")
    is_color = arr.ndim == 4
    nframes = arr.shape[0]

    shared_seq = ds.get("SharedFunctionalGroupsSequence")
    shared = shared_seq[0] if shared_seq else None
    perframe = ds.get("PerFrameFunctionalGroupsSequence") or []

    base = ds.copy()
    for kw in _STRIP_KEYWORDS:
        if kw in base:
            del base[kw]
    if ds.get("SOPClassUID") == T.ENHANCED_MR_IMAGE_STORAGE:
        base.set_value("SOPClassUID", T.MR_IMAGE_STORAGE)
    if base.file_meta is not None:
        # Pixel bytes are re-serialized native little-endian below; the
        # synthetic headers must not claim the parent's transfer syntax.
        base.file_meta = base.file_meta.copy()
        base.file_meta.set_value("TransferSyntaxUID", T.EXPLICIT_VR_LE)
        # Mirror the dataset's (possibly rewritten) SOP class — a non-MR
        # multi-frame object (e.g. multi-frame Secondary Capture) must not
        # get file meta claiming MR Image Storage over an SC dataset.
        sop = base.get("SOPClassUID")
        if sop:
            base.file_meta.set_value("MediaStorageSOPClassUID", sop)

    # Promote shared macros to classic tags on the base dataset.
    for seq_kw, attr_kw, out_kw in (
        ("PixelMeasuresSequence", "PixelSpacing", "PixelSpacing"),
        ("PixelMeasuresSequence", "SliceThickness", "SliceThickness"),
        ("PixelMeasuresSequence", "SpacingBetweenSlices", "SpacingBetweenSlices"),
        ("PlaneOrientationSequence", "ImageOrientationPatient", "ImageOrientationPatient"),
        ("MREchoSequence", "EffectiveEchoTime", "EchoTime"),
        ("PixelValueTransformationSequence", "RescaleSlope", "RescaleSlope"),
        ("PixelValueTransformationSequence", "RescaleIntercept", "RescaleIntercept"),
    ):
        v = _fg(shared, seq_kw, attr_kw)
        if v is not None:
            base.set_value(out_kw, v)

    # Geometry needed for synthesized positions.
    iop = base.get("ImageOrientationPatient")
    normal = None
    if iop is not None and len(iop) == 6:
        i_vec = np.asarray(_as_float3(iop[:3]))
        j_vec = np.asarray(_as_float3(iop[3:]))
        normal = np.cross(i_vec, j_vec)
        n = np.linalg.norm(normal)
        normal = normal / n if n else None
    dz = base.get("SpacingBetweenSlices") or base.get("SliceThickness") or 1.0
    ipp0 = base.get("ImagePositionPatient")

    # Per-frame (or shared) echo times → synthetic classic EchoNumbers.
    # Single-echo exports get EchoNumbers=1 on every frame so the default
    # ``group_by="EchoNumbers"`` load works on them too.
    echo_times = []
    for i in range(nframes):
        item = perframe[i] if i < len(perframe) else None
        echo_times.append(_fg(item, "MREchoSequence", "EffectiveEchoTime"))
    uniq = sorted({float(t) for t in echo_times if t is not None})
    have_echoes = bool(uniq)
    if have_echoes:
        echo_index = {t: k + 1 for k, t in enumerate(uniq)}
    elif base.get("EchoTime") is not None and "EchoNumbers" not in base:
        base.set_value("EchoNumbers", 1)

    from dosma_tpu_torch.core.io.dicom.writer import generate_uid

    out: List[Dataset] = []
    for i in range(nframes):
        item = perframe[i] if i < len(perframe) else None
        d = base.copy()

        ipp = _fg(item, "PlanePositionSequence", "ImagePositionPatient")
        if ipp is None:
            if ipp0 is not None and normal is not None:
                ipp = list(np.asarray(_as_float3(ipp0)) + i * float(dz) * normal)
            elif ipp0 is not None:
                ipp = list(_as_float3(ipp0))
        if ipp is not None:
            d.set_value("ImagePositionPatient", [float(x) for x in ipp])

        iop_i = _fg(item, "PlaneOrientationSequence", "ImageOrientationPatient")
        if iop_i is not None:
            d.set_value("ImageOrientationPatient", [float(x) for x in iop_i])

        for seq_kw, attr_kw, out_kw in (
            ("PixelMeasuresSequence", "PixelSpacing", "PixelSpacing"),
            ("MREchoSequence", "EffectiveEchoTime", "EchoTime"),
            ("PixelValueTransformationSequence", "RescaleSlope", "RescaleSlope"),
            ("PixelValueTransformationSequence", "RescaleIntercept", "RescaleIntercept"),
        ):
            v = _fg(item, seq_kw, attr_kw)
            if v is not None:
                d.set_value(out_kw, v)

        in_stack = _fg(item, "FrameContentSequence", "InStackPositionNumber")
        d.set_value("InstanceNumber", int(in_stack) if in_stack is not None else i + 1)
        if have_echoes and echo_times[i] is not None:
            d.set_value("EchoNumbers", echo_index[float(echo_times[i])])

        d.set_value("SOPInstanceUID", generate_uid())
        if d.file_meta is not None:
            d.file_meta.set_value("MediaStorageSOPInstanceUID", d.get("SOPInstanceUID"))

        frame = np.ascontiguousarray(arr[i])
        if frame.dtype.byteorder == ">":
            frame = frame.astype(frame.dtype.newbyteorder("="))
        if is_color:
            # Per-frame bytes are pixel-interleaved (R, C, S).
            d.set_value("PlanarConfiguration", 0)
        d[T.DICT["PixelData"][0]] = frame.tobytes()
        out.append(d)
    return out
