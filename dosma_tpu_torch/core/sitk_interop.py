"""SimpleITK interoperability math, with or without SimpleITK (counterpart
of ``dosma_tpu/core/sitk_interop.py``).

The geometry of ``MedicalVolume.to_sitk`` / ``from_sitk``: the axis
reversal between numpy's (i, j, k[, v]) storage and SimpleITK's (z, y, x)
arrays, the RAS+ <-> LPS+ sign flips, the spacing / direction factorization
of the affine, and the in-plane permute, as pure numpy functions.
:class:`HeadlessSitkImage` is a stand-in for the part of the
``SimpleITK.Image`` API these conversions touch, so they run without the
SimpleITK package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "HeadlessSitkImage",
    "medvol_to_sitk_params",
    "sitk_params_to_medvol",
    "permute_inplane_params",
]


class HeadlessSitkImage:
    """Duck-typed ``SimpleITK.Image`` stand-in (array in sitk z,y,x order).

    Implements the accessor subset used by :meth:`MedicalVolume.from_sitk`
    so conversion code and tests can run without the SimpleITK package.
    """

    def __init__(self, array_zyx, origin, spacing, direction, is_vector: bool = False):
        self._array = np.asarray(array_zyx)
        self._origin = tuple(float(v) for v in origin)
        self._spacing = tuple(float(v) for v in spacing)
        self._direction = tuple(float(v) for v in np.asarray(direction).ravel())
        self._is_vector = bool(is_vector)

    # sitk.Image API subset ------------------------------------------------
    def GetSize(self):
        shape = self._array.shape[:-1] if self._is_vector else self._array.shape
        return tuple(int(s) for s in shape[::-1])  # (x, y, z)

    def GetOrigin(self):
        return self._origin

    def GetSpacing(self):
        return self._spacing

    def GetDirection(self):
        return self._direction

    def GetNumberOfComponentsPerPixel(self):
        return int(self._array.shape[-1]) if self._is_vector else 1

    # numpy access (sitk uses module-level GetArrayFromImage) ---------------
    def array_from_image(self, copy: bool = False):
        return self._array.copy() if copy else self._array

    def __repr__(self):
        return (
            f"HeadlessSitkImage(size={self.GetSize()}, spacing={self._spacing}, "
            f"components={self.GetNumberOfComponentsPerPixel()})"
        )


def medvol_to_sitk_params(
    volume: np.ndarray,
    affine: np.ndarray,
    pixel_spacing: Sequence[float],
    vdim: Optional[int] = None,
) -> Tuple[np.ndarray, Tuple[float, ...], Tuple[float, ...], Tuple[float, ...]]:
    """Decompose a MedicalVolume into sitk constructor parameters.

    Returns ``(array_zyx, origin, spacing, direction)`` where ``array_zyx``
    is ordered for ``sitk.GetImageFromArray`` (axis order reversed, the
    vector axis — if any — kept last) and origin/direction are in LPS+.
    """
    arr = np.asarray(volume)
    ndim = arr.ndim
    if vdim is not None:
        if vdim < 0:
            vdim = ndim + vdim
        axes = tuple(i for i in range(ndim) if i != vdim)[::-1] + (vdim,)
    else:
        axes = tuple(range(ndim))[::-1]
    arr = np.transpose(arr, axes)

    lps = np.asarray(affine, float).copy()
    lps[:2] = -lps[:2]  # RAS+ -> LPS+
    spacing = tuple(float(s) for s in pixel_spacing)
    direction = lps[:3, :3] / np.asarray(spacing)
    origin = tuple(float(v) for v in lps[:3, 3])
    return arr, origin, spacing, tuple(direction.ravel())


def sitk_params_to_medvol(
    array_zyx: np.ndarray,
    origin: Sequence[float],
    spacing: Sequence[float],
    direction: Sequence[float],
    is_vector: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Rebuild ``(array_ijk, RAS affine)`` from sitk image parameters."""
    arr = np.asarray(array_zyx)
    ndim = arr.ndim
    if is_vector:
        axes = tuple(range(ndim)[-2::-1]) + (ndim - 1,)
    else:
        axes = tuple(range(ndim))[::-1]
    arr = np.transpose(arr, axes)

    direction = np.asarray(direction, float).reshape(-1, 3)
    affine = np.eye(4)
    affine[:3, :3] = direction * np.asarray(spacing, float)
    affine[:3, 3] = np.asarray(origin, float)
    affine[:2] = -affine[:2]  # LPS+ -> RAS+
    return arr, affine


def permute_inplane_params(
    array_zyx: np.ndarray,
    origin: Sequence[float],
    spacing: Sequence[float],
    direction: Sequence[float],
    is_vector: bool = False,
):
    """Apply sitk ``PermuteAxesImageFilter`` with order ``[1, 0, 2]`` in numpy.

    Swapping image axes x<->y permutes the array's in-plane axes, the
    spacing entries, and the direction-matrix *columns*; the origin (the
    physical position of index (0,0,0)) is unchanged.
    """
    arr = np.asarray(array_zyx)
    y_ax, x_ax = (arr.ndim - 3, arr.ndim - 2) if is_vector else (arr.ndim - 2, arr.ndim - 1)
    arr = np.swapaxes(arr, y_ax, x_ax)

    sp = tuple(spacing)
    spacing = (sp[1], sp[0]) + tuple(sp[2:])
    d = np.asarray(direction, float).reshape(-1, 3)
    direction = tuple(d[:, [1, 0, 2]].ravel())
    return arr, tuple(origin), spacing, direction
