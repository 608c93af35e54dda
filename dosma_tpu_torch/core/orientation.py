"""Standardized orientation convention and utilities (RAS+).

The same module as ``dosma_tpu/core/orientation.py`` (numpy only, no
nibabel): all conversions are computed directly from the affine-column
convention:

- Orientations are tuples of axis codes ``"LR","RL","PA","AP","IS","SI"``;
  code ``XY`` means the array axis runs from anatomical X to Y (e.g. ``"LR"``
  = left → right = +x in RAS+).
- Column ``j`` of the 4x4 affine expresses array axis ``j`` in world (RAS+)
  coordinates, so axis direction = sign of the dominant entry of column ``j``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

__all__ = [
    "to_affine",
    "orientation_from_affine",
    "get_transpose_inds",
    "get_flip_inds",
    "orientation_nib_to_standard",
    "orientation_standard_to_nib",
    "SAGITTAL",
    "CORONAL",
    "AXIAL",
]

SAGITTAL = ("SI", "AP", "LR")
CORONAL = ("SI", "LR", "AP")
AXIAL = ("AP", "LR", "SI")

_EXPECTED_LEN = 3
_SUPPORTED = ("LR", "RL", "PA", "AP", "IS", "SI")
_AXIS_ID = {"LR": 0, "RL": 0, "PA": 1, "AP": 1, "IS": 2, "SI": 2}
# Code for (ras_axis, positive?) pairs.
_POSITIVE_CODE = ("LR", "PA", "IS")  # axis increases toward +x/+y/+z
_NEGATIVE_CODE = ("RL", "AP", "SI")


def _check_orientation(orientation) -> None:
    ok = (
        len(orientation) == _EXPECTED_LEN
        and all(isinstance(o, str) and o in _SUPPORTED for o in orientation)
        and len({_AXIS_ID[o] for o in orientation}) == _EXPECTED_LEN
    )
    if not ok:
        raise ValueError(
            "Orientation format mismatch: Orientations must be tuple of strings of "
            f"length {_EXPECTED_LEN} drawn from {_SUPPORTED} covering all three axes; "
            f"got {orientation}"
        )


def get_transpose_inds(curr_orientation, new_orientation) -> Tuple[int, ...]:
    """Axes permutation taking ``curr_orientation`` plane order to ``new_orientation``.

    Flips are ignored — ``("SI","AP","LR") → ("IS","PA","RL")`` is ``(0,1,2)``.
    """
    _check_orientation(curr_orientation)
    _check_orientation(new_orientation)
    curr_ids = [_AXIS_ID[o] for o in curr_orientation]
    new_ids = [_AXIS_ID[o] for o in new_orientation]
    if set(curr_ids) != set(new_ids):
        raise ValueError("Orientation mismatch: both orientations must contain the same axes")
    return tuple(curr_ids.index(n) for n in new_ids)


def get_flip_inds(curr_orientation, new_orientation):
    """Axes to flip after plane order already matches (see :func:`get_transpose_inds`)."""
    _check_orientation(curr_orientation)
    _check_orientation(new_orientation)
    curr_ids = [_AXIS_ID[o] for o in curr_orientation]
    new_ids = [_AXIS_ID[o] for o in new_orientation]
    if curr_ids != new_ids:
        raise ValueError(
            "All axis orientations (S/I, L/R, A/P) must be ordered. "
            "Use `get_transpose_inds` to reorder axes."
        )
    return [i for i in range(_EXPECTED_LEN) if curr_orientation[i] != new_orientation[i]]


_NIB_TO_STANDARD = {"R": "LR", "L": "RL", "A": "PA", "P": "AP", "S": "IS", "I": "SI"}


def orientation_nib_to_standard(nib_orientation) -> Tuple[str, ...]:
    """``("R","A","S") → ("LR","PA","IS")``."""
    return tuple(_NIB_TO_STANDARD[s] for s in nib_orientation)


def orientation_standard_to_nib(orientation) -> Tuple[str, ...]:
    """``("LR","PA","IS") → ("R","A","S")``."""
    return tuple(s[1] for s in orientation)


def _format_numbers(value, default_val, name, expected_num):
    if value is None:
        return (default_val,) * expected_num
    if isinstance(value, (int, float, np.integer, np.floating)):
        return (float(value),) * expected_num
    if not isinstance(value, (np.ndarray, Sequence)) or len(value) > expected_num:
        raise ValueError(
            f"`{name}` must be a real number or sequence (length<={expected_num}) "
            f"of real numbers. Got {value}"
        )
    out = tuple(float(v) for v in value)
    if len(out) < expected_num:
        out += (float(default_val),) * (expected_num - len(out))
    return out


def to_affine(
    orientation,
    spacing: Union[int, float, Sequence] = None,
    origin: Union[int, float, Sequence] = None,
) -> np.ndarray:
    """Build a 4x4 RAS+ affine from orientation codes, spacing, and origin.

    Mirrors reference ``to_affine`` (``orientation.py:241-315``), including
    2-length orientation inference.
    """
    if len(orientation) == 2:
        orientation = _infer_orientation(orientation)
    _check_orientation(orientation)
    spacing = _format_numbers(spacing, 1, "spacing", len(orientation))
    origin = _format_numbers(origin, 0, "origin", len(orientation))

    affine = np.zeros((4, 4), dtype=np.float64)
    for j, code in enumerate(orientation):
        ras_axis = _AXIS_ID[code]
        sign = 1.0 if code in _POSITIVE_CODE else -1.0
        affine[ras_axis, j] = sign * spacing[j]
    affine[:3, 3] = origin
    affine[3, 3] = 1.0
    return affine


def orientation_from_affine(affine) -> Tuple[str, ...]:
    """Closest-axis orientation codes for each array axis of ``affine``.

    Equivalent to ``nib.aff2axcodes`` → :func:`orientation_nib_to_standard`.
    """
    affine = np.asarray(affine)
    ornt = []
    used = set()
    cols = affine[:3, :3]
    for j in range(3):
        col = cols[:, j]
        order = np.argsort(-np.abs(col))
        ras_axis = next(int(a) for a in order if int(a) not in used)
        used.add(ras_axis)
        code = _POSITIVE_CODE[ras_axis] if col[ras_axis] >= 0 else _NEGATIVE_CODE[ras_axis]
        ornt.append(code)
    return tuple(ornt)


def _infer_orientation(orientation) -> Tuple[str, ...]:
    """Complete a 2-length orientation with the missing orthogonal direction."""
    idxs = {_AXIS_ID[k] for k in orientation}
    if len(orientation) != 2 or len(idxs) != 2:
        raise ValueError(
            "`orientation` must be an incomplete orientation that encodes orthogonal directions"
        )
    missing = [k for k, v in _AXIS_ID.items() if v not in idxs][0]
    return tuple(orientation) + (missing,)
