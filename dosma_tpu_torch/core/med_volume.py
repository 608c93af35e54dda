"""The medical image data structure: array + RAS+ affine + DICOM headers.

Counterpart of ``dosma_tpu/core/med_volume.py``. The pixel array is either a
host ``numpy.ndarray`` or a ``torch.Tensor`` (on the CPU or a CUDA card); the
4x4 affine and the header table always live on the host, and headers stay
opaque object arrays.

  - ``reformat``/``reformat_as`` transpose and flip the spatial axes and
    recompute the affine and origin.
  - spatial-first slicing ``__getitem__`` slices headers and affine.
  - arithmetic goes through numpy's ufunc protocol; for tensor-backed
    volumes each ufunc is dispatched to the torch function of the same
    meaning, on the tensor's device.
"""

from __future__ import annotations

from copy import deepcopy
from numbers import Number
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
from numpy.lib.mixins import NDArrayOperatorsMixin

from dosma_tpu_torch.core import orientation as stdo
from dosma_tpu_torch.core.device import Device, cpu_device, get_device
from dosma_tpu_torch.defaults import SCANNER_ORIGIN_DECIMAL_PRECISION

__all__ = ["MedicalVolume"]

# numpy ufunc name -> torch function name, where the two differ.
_UFUNC_TO_TORCH = {
    "absolute": "abs",
    "power": "pow",
    "equal": "eq",
    "not_equal": "ne",
    "greater": "gt",
    "greater_equal": "ge",
    "less": "lt",
    "less_equal": "le",
    "invert": "bitwise_not",
    "conjugate": "conj",
}
# numpy ufunc name -> torch reduction over the given dims.
_REDUCE_TO_TORCH = {"add": torch.sum, "multiply": torch.prod, "maximum": torch.amax,
                    "minimum": torch.amin}


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _numpy_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class MedicalVolume(NDArrayOperatorsMixin):
    """Spatially-aware array with RAS+ affine tracking.

    Args:
        volume: array-like pixel data or ``torch.Tensor``, ndim >= 3 with
            spatial dims first.
        affine: 4x4 array mapping (i, j, k) voxel coordinates of the first
            three axes to RAS+ world coordinates.
        headers: optional array of DICOM header datasets, broadcastable
            against ``volume.shape``.
    """

    def __init__(self, volume, affine, headers=None):
        if not _is_tensor(volume) and not isinstance(volume, np.memmap):
            volume = np.asarray(volume)
        self._volume = volume
        self._affine = np.array(affine, dtype=np.float64)
        if self._affine.shape != (4, 4):
            raise ValueError(f"`affine` must be 4x4, got shape {self._affine.shape}")
        self._headers = self._validate_and_format_headers(headers) if headers is not None else None

    # ------------------------------------------------------------------
    # Reformatting
    # ------------------------------------------------------------------
    def reformat(self, new_orientation: Sequence, inplace: bool = False) -> "MedicalVolume":
        """Reorient to ``new_orientation`` by transposing/flipping spatial axes.

        Transposing axes permutes affine columns; flipping negates the column
        and shifts the origin by ``(n-1)`` voxels along the flipped direction.
        """
        headers = self._headers

        new_orientation = tuple(new_orientation)
        if new_orientation == self.orientation:
            return self if inplace else self._partial_clone(volume=self._volume)

        temp_affine = np.array(self._affine)

        transpose_inds = stdo.get_transpose_inds(self.orientation, new_orientation)
        all_transpose_inds = transpose_inds + tuple(range(3, self._volume.ndim))

        if _is_tensor(self._volume):
            volume = self._volume.permute(*all_transpose_inds)
        else:
            volume = np.transpose(self._volume, all_transpose_inds)
        if headers is not None:
            headers = np.transpose(headers, all_transpose_inds)
        for i in range(len(transpose_inds)):
            temp_affine[..., i] = self._affine[..., transpose_inds[i]]

        temp_orientation = tuple(self.orientation[i] for i in transpose_inds)

        flip_axs_inds = list(stdo.get_flip_inds(temp_orientation, new_orientation))
        if flip_axs_inds:
            if _is_tensor(volume):
                volume = torch.flip(volume, dims=flip_axs_inds)
            else:
                volume = np.flip(volume, axis=tuple(flip_axs_inds))
            if headers is not None:
                headers = np.flip(headers, axis=tuple(flip_axs_inds))

        a_vecs = temp_affine[:3, :3]
        a_origin = temp_affine[:3, 3]

        # phi: +1 keep, -1 flip, per array axis.
        phi = np.ones(3)
        phi[flip_axs_inds] *= -1

        b_vecs = a_vecs * phi[np.newaxis, :]

        # Origin moves by (n-1) voxels along each flipped axis.
        vol_shape_vec = (np.asarray(volume.shape[:3]) - 1) * (phi < 0).astype(np.float64)
        b_origin = np.round(
            a_origin - b_vecs @ vol_shape_vec,
            SCANNER_ORIGIN_DECIMAL_PRECISION,
        )

        new_affine = np.array(self._affine)
        new_affine[:3, :3] = b_vecs
        new_affine[:3, 3] = b_origin
        new_affine[new_affine == 0] = 0  # drop negative zeros

        if inplace:
            self._affine = new_affine
            self._volume = volume
            self._headers = headers
            mv = self
        else:
            mv = self._partial_clone(volume=volume, affine=new_affine, headers=headers)

        if mv.orientation != new_orientation:
            raise RuntimeError(
                f"Orientation mismatch: expected {new_orientation}, got {mv.orientation}"
            )
        return mv

    def reformat_as(self, other, inplace: bool = False) -> "MedicalVolume":
        """Reformat to the orientation of ``other``."""
        return self.reformat(other.orientation, inplace=inplace)

    # ------------------------------------------------------------------
    # Comparisons
    # ------------------------------------------------------------------
    def _allclose_spacing(self, mv, precision: int = None, ignore_origin: bool = False) -> bool:
        if precision is not None:
            tol = 10 ** (-precision)
            return np.allclose(mv.affine[:3, :3], self.affine[:3, :3], atol=tol) and (
                ignore_origin or np.allclose(mv.scanner_origin, self.scanner_origin, rtol=tol)
            )
        return bool((mv.affine == self.affine).all()) or (
            ignore_origin and bool((mv.affine[:, :3] == self.affine[:, :3]).all())
        )

    def is_same_dimensions(self, mv, precision: int = None, err: bool = False) -> bool:
        """True if same pixel spacing, orientation, scanner origin, and shape."""
        if not isinstance(mv, MedicalVolume):
            raise TypeError("`mv` must be a MedicalVolume.")

        is_close_spacing = self._allclose_spacing(mv, precision)
        is_same_orientation = mv.orientation == self.orientation
        is_same_shape = tuple(mv.volume.shape) == tuple(self.volume.shape)
        out = is_close_spacing and is_same_orientation and is_same_shape

        if err and not out:
            tol_str = f" (tol: 1e-{precision})" if precision else ""
            if not is_close_spacing:
                raise ValueError(
                    f"Affine matrices not equal{tol_str}:\n{self._affine}\n{mv._affine}"
                )
            if not is_same_orientation:
                raise ValueError(f"Orientations not equal: {self.orientation}, {mv.orientation}")
            raise ValueError(f"Shapes not equal: {self._volume.shape}, {mv._volume.shape}")
        return out

    # ------------------------------------------------------------------
    # Cloning & dtype/device movement
    # ------------------------------------------------------------------
    def clone(self, headers: bool = True) -> "MedicalVolume":
        """Deep copy. ``headers=False`` shares the header array."""
        vol = self._volume
        return self.__class__(
            vol.clone() if _is_tensor(vol) else vol.copy(),
            self._affine.copy(),
            headers=deepcopy(self._headers) if headers else self._headers,
        )

    def _partial_clone(self, **kwargs) -> "MedicalVolume":
        """Copy constructor args from ``self`` unless overridden in ``kwargs``."""
        if kwargs.get("volume", None) is False:
            kwargs["volume"] = self._volume
        for k in ("volume", "affine"):
            if k not in kwargs or kwargs[k] is True:
                val = getattr(self, f"_{k}")
                kwargs[k] = val.clone() if _is_tensor(val) else val.copy()
        if "headers" not in kwargs:
            kwargs["headers"] = self._headers
        elif isinstance(kwargs["headers"], bool) and kwargs["headers"]:
            kwargs["headers"] = deepcopy(self._headers)
        return self.__class__(**kwargs)

    def astype(self, dtype, **kwargs) -> "MedicalVolume":
        """Cast volume dtype in place and return self."""
        if _is_tensor(self._volume):
            self._volume = self._volume.to(_torch_dtype(dtype))
        else:
            self._volume = self._volume.astype(_numpy_dtype(dtype), **kwargs)
        return self

    def to(self, device) -> "MedicalVolume":
        """Move to ``device``. No-op (returns self) if already there.

        Volumes on the host are numpy arrays; volumes on a card are tensors.
        """
        device = Device(device)
        if device == self.device:
            return self
        vol = self._volume
        if device == cpu_device:
            volume = vol.cpu().numpy()
        else:
            if not _is_tensor(vol):
                vol = torch.from_numpy(np.ascontiguousarray(vol))
            volume = vol.to(device.ptdevice)
        return self._partial_clone(volume=volume)

    def cpu(self) -> "MedicalVolume":
        return self.to(cpu_device)

    # ------------------------------------------------------------------
    # Headers
    # ------------------------------------------------------------------
    def headers(self, flatten: bool = False):
        if flatten and self._headers is not None:
            return self._headers.flatten()
        return self._headers

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------
    @property
    def A(self):
        """The pixel array (alias of :attr:`volume`)."""
        return self._volume

    @property
    def volume(self):
        return self._volume

    @volume.setter
    def volume(self, value):
        if value.ndim != self._volume.ndim:
            raise ValueError("New volume must have same number of dimensions as current volume")
        if tuple(self._volume.shape) != tuple(value.shape):
            self._headers = None
        if not _is_tensor(value):
            value = np.asarray(value)
        self._volume = value

    @property
    def pixel_spacing(self) -> Tuple[float, ...]:
        vecs = self._affine[:3, :3]
        return tuple(np.sqrt(np.sum(vecs**2, axis=0)))

    @property
    def orientation(self) -> Tuple[str, ...]:
        return stdo.orientation_from_affine(self._affine)

    @property
    def scanner_origin(self) -> Tuple[float, ...]:
        return tuple(self._affine[:3, 3])

    @property
    def affine(self) -> np.ndarray:
        return self._affine

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._volume.shape)

    @property
    def ndim(self) -> int:
        return self._volume.ndim

    @property
    def dtype(self):
        return self._volume.dtype

    @property
    def device(self) -> Device:
        return get_device(self._volume)

    # ------------------------------------------------------------------
    # Internal helpers
    # ------------------------------------------------------------------
    def _validate_and_format_headers(self, headers):
        """Broadcast-shape the header array against the volume."""
        headers = _to_object_array(headers)
        if headers.ndim > self._volume.ndim:
            raise ValueError(
                f"`headers` has too many dimensions. "
                f"Got headers.ndim={headers.ndim}, but volume.ndim={self._volume.ndim}"
            )
        for dim in range(-headers.ndim, 0)[::-1]:
            if headers.shape[dim] not in (1, self._volume.shape[dim]):
                raise ValueError(
                    f"`headers` must follow standard broadcasting shape. "
                    f"Got headers.shape={headers.shape}, but volume.shape={self._volume.shape}"
                )
        ndim = self._volume.ndim
        shape = (1,) * (ndim - headers.ndim) + headers.shape
        return np.reshape(headers, shape)

    def _extract_input_array_ufunc(self, input, device=None):
        if device is None:
            device = self.device
        if isinstance(input, Number):
            return input
        if isinstance(input, np.ndarray):
            if device != cpu_device:
                raise RuntimeError(f"Expected device {device} but got device {cpu_device}")
            return torch.from_numpy(input) if _is_tensor(self._volume) else input
        if _is_tensor(input):
            if Device(input.device) != device:
                raise RuntimeError(f"Expected device {device} but got device {input.device}")
            return input
        if isinstance(input, MedicalVolume):
            if device != input.device:
                raise RuntimeError(f"Expected device {device} but got device {input.device}")
            self.is_same_dimensions(input, err=True)
            vol = input._volume
            if _is_tensor(self._volume) and not _is_tensor(vol):
                vol = torch.from_numpy(np.ascontiguousarray(vol))
            return vol
        return NotImplemented

    def _check_reduce_axis(self, axis) -> Optional[Union[int, Tuple[int, ...]]]:
        if axis is None:
            return None
        is_sequence = isinstance(axis, Sequence)
        if not is_sequence:
            axis = (axis,)
        axis = tuple(x if x >= 0 else self._volume.ndim + x for x in axis)
        if any(x < 3 for x in axis):
            raise ValueError("Cannot reduce MedicalVolume along spatial dimensions")
        return axis if is_sequence else axis[0]

    def _reduce_array(self, func, *inputs, **kwargs):
        reduce_axis = self._check_reduce_axis(kwargs.get("axis"))
        kwargs["axis"] = reduce_axis
        if not isinstance(reduce_axis, tuple):
            reduce_axis = (reduce_axis,)
        volume = func(*inputs, **kwargs)

        if np.isscalar(volume) or getattr(volume, "ndim", 0) == 0:
            return volume

        keepdims = kwargs.get("keepdims", False)
        if self._headers is not None:
            headers_slices = tuple(
                slice(None) if x not in reduce_axis else (slice(0, 1) if keepdims else 0)
                for x in range(self._headers.ndim)
            )
            headers = self._headers[headers_slices]
        else:
            headers = None
        return self._partial_clone(volume=volume, headers=headers)

    # ------------------------------------------------------------------
    # Indexing
    # ------------------------------------------------------------------
    def __getitem__(self, _slice):
        if isinstance(_slice, MedicalVolume):
            _slice = np.asarray(_slice.reformat_as(self).A)

        _slice = _canonical_slicers(_slice, self.shape)

        if _is_tensor(self._volume):
            volume = _tensor_getitem(self._volume, _slice)
        else:
            volume = self._volume[_slice]
        if any(dim == 0 for dim in volume.shape):
            raise IndexError("Empty slice requested")

        headers = self._headers
        if headers is not None:
            _slice_headers = []
            for idx, x in enumerate(_slice):
                if headers.shape[idx] == 1 and not isinstance(x, int):
                    _slice_headers.append(slice(None))
                elif headers.shape[idx] == 1 and isinstance(x, int):
                    _slice_headers.append(0)
                else:
                    _slice_headers.append(x)
            headers = headers[tuple(_slice_headers)]

        affine = _slice_affine(self._affine, _slice, self.shape)
        return self._partial_clone(volume=volume, affine=affine, headers=headers)

    def __repr__(self) -> str:
        nltb = "\n  "
        return (
            f"{self.__class__.__name__}({nltb}shape={self.shape},{nltb}"
            f"ornt={self.orientation}),{nltb}spacing={self.pixel_spacing},{nltb}"
            f"origin={self.scanner_origin},{nltb}device={self.device}\n)"
        )

    # ------------------------------------------------------------------
    # In-place arithmetic (numpy arrays and tensors share the dunders)
    # ------------------------------------------------------------------
    def _iops(self, other, opname: str):
        if isinstance(other, MedicalVolume):
            self.is_same_dimensions(other, err=True)
            other = other.volume
        if _is_tensor(self._volume) and isinstance(other, np.ndarray):
            other = torch.from_numpy(other)
        result = getattr(self._volume, opname)(other)
        if result is NotImplemented:
            raise TypeError(f"{opname} not supported for {type(other)}")
        self._volume = result
        return self

    def __iadd__(self, other):
        return self._iops(other, "__iadd__")

    def __ifloordiv__(self, other):
        return self._iops(other, "__ifloordiv__")

    def __imul__(self, other):
        return self._iops(other, "__imul__")

    def __ipow__(self, other):
        return self._iops(other, "__ipow__")

    def __isub__(self, other):
        return self._iops(other, "__isub__")

    def __itruediv__(self, other):
        return self._iops(other, "__itruediv__")

    # ------------------------------------------------------------------
    # NumPy protocols
    # ------------------------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        vol = self._volume
        if _is_tensor(vol):
            if vol.device.type != "cpu":
                raise TypeError(
                    f"Volume is on {vol.device}; call .cpu() to copy it to the host first."
                )
            vol = vol.numpy()
        arr = np.asarray(vol)
        if dtype is not None:
            arr = arr.astype(dtype)
        return arr

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method not in ("__call__", "reduce"):
            return NotImplemented

        device = self.device
        _inputs = []
        for inp in inputs:
            inp = self._extract_input_array_ufunc(inp, device)
            if inp is NotImplemented:
                return NotImplemented
            _inputs.append(inp)

        on_torch = _is_tensor(self._volume)
        if method == "__call__":
            if on_torch:
                if kwargs:
                    return NotImplemented
                fn = getattr(torch, _UFUNC_TO_TORCH.get(ufunc.__name__, ufunc.__name__), None)
                if fn is None:
                    return NotImplemented
                if ufunc.__name__ in ("maximum", "minimum"):
                    _inputs = [
                        torch.as_tensor(x, device=self._volume.device) if isinstance(x, Number)
                        else x for x in _inputs
                    ]
            else:
                fn = ufunc
            volume = fn(*_inputs, **kwargs)
            if tuple(volume.shape) != tuple(self._volume.shape):
                raise ValueError(
                    f"{self.__class__.__name__} does not support operations that change shape. "
                    f"Use operations on `self.volume` to modify array objects."
                )
            return self._partial_clone(volume=volume)

        # reduce
        if on_torch:
            torch_reduce = _REDUCE_TO_TORCH.get(ufunc.__name__)
            if torch_reduce is None:
                return NotImplemented

            def reduce_fn(x, axis=None, keepdims=False, **_):
                if axis is None:
                    return torch_reduce(x)
                # One dim at a time, last first: torch.prod takes a single dim.
                for dim in sorted(axis if isinstance(axis, tuple) else (axis,), reverse=True):
                    x = torch_reduce(x, dim=dim, keepdim=keepdims)
                return x
        else:
            reduce_fn = ufunc.reduce
        return self._reduce_array(reduce_fn, *_inputs, **kwargs)


def _to_object_array(headers) -> np.ndarray:
    """Build an object ndarray of header datasets WITHOUT letting numpy
    iterate into the datasets themselves (a dataset is itself iterable)."""
    if isinstance(headers, np.ndarray) and headers.dtype == object:
        return headers
    if not isinstance(headers, (list, tuple)):
        headers = [headers]
    arr = np.empty(len(headers), dtype=object)
    for i, h in enumerate(headers):
        arr[i] = h
    return arr


def _canonical_slicers(slicer, shape) -> tuple:
    """Canonicalize a slicer: expand Ellipsis, pad to ndim, enforce
    slice-only indexing on the first three (spatial) axes (nibabel's
    ``SpatialFirstSlicer.check_slicing`` semantics)."""
    if not isinstance(slicer, tuple):
        slicer = (slicer,)
    if any(s is Ellipsis for s in slicer):
        if sum(s is Ellipsis for s in slicer) > 1:
            raise IndexError("Only one Ellipsis allowed")
        idx = slicer.index(Ellipsis)
        n_explicit = len([s for s in slicer if s is not None]) - 1
        fill = (slice(None),) * (len(shape) - n_explicit)
        slicer = slicer[:idx] + fill + slicer[idx + 1 :]
    n_explicit = len([s for s in slicer if s is not None])
    if n_explicit > len(shape):
        raise IndexError("Too many indices for volume")
    slicer = slicer + (slice(None),) * (len(shape) - n_explicit)

    out = []
    dim = 0
    for s in slicer:
        if s is None:
            raise IndexError("New axis not permitted in MedicalVolume slicing")
        if isinstance(s, (int, np.integer)):
            if dim < 3:
                raise IndexError(
                    "Scalar indices disallowed in spatial dimensions; use `x:x+1` instead."
                )
            s = int(s)
            if s < 0:
                s += shape[dim]
            if not (0 <= s < shape[dim]):
                raise IndexError(f"Index {s} out of bounds for axis {dim} (size {shape[dim]})")
        elif isinstance(s, slice):
            pass
        elif isinstance(s, (np.ndarray, list)):
            if dim < 3:
                raise IndexError("Fancy indexing disallowed in spatial dimensions")
        else:
            raise IndexError(f"Unsupported index: {s!r}")
        out.append(s)
        dim += 1
    return tuple(out)


def _tensor_getitem(t: torch.Tensor, slicer: tuple) -> torch.Tensor:
    """``t[slicer]`` for a canonical slicer; torch has no negative-step
    slices, so those axes are gathered with explicit indices."""
    out = t
    dim = 0
    for s in slicer:
        if isinstance(s, int):
            out = out.select(dim, s)
            continue
        if isinstance(s, slice):
            start, stop, step = s.indices(out.shape[dim])
            if step > 0:
                out = out[(slice(None),) * dim + (slice(start, stop, step),)]
            else:
                idx = torch.arange(start, stop, step, device=out.device)
                out = out.index_select(dim, idx)
        else:
            idx = torch.as_tensor(np.asarray(s), device=out.device)
            out = out.index_select(dim, idx)
        dim += 1
    return out


def _slice_affine(affine: np.ndarray, slicer: tuple, shape) -> np.ndarray:
    """Update affine for a canonical slicer on the first three axes.

    ``A' = A @ T`` where T scales column i by the step and offsets the origin
    by the start index (nibabel ``SpatialFirstSlicer.slice_affine``).
    """
    transform = np.eye(4, dtype=np.float64)
    for i, s in enumerate(slicer[:3]):
        start, _, step = s.indices(shape[i])
        transform[i, i] = step
        transform[i, 3] = start
    return affine @ transform
