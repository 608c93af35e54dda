"""NumPy-function registry for :class:`MedicalVolume`.

Counterpart of ``dosma_tpu/core/numpy_routines.py``. ``np.stack``,
``np.concatenate``, ``np.where``, ``np.clip``, the reductions and the other
functions below, called on volumes, keep the affine and headers. A host
(numpy) volume is computed with numpy, as in ``dosma_tpu``; a volume backed
by a tensor is computed with torch on the tensor's device, never copied to
the host.
"""

from __future__ import annotations

import warnings
from typing import Sequence, Union

import numpy as np
import torch

from dosma_tpu_torch.core.device import as_tensor
from dosma_tpu_torch.core.med_volume import MedicalVolume, _is_tensor, _NoValue, _torch_dtype

__all__ = [
    "amin", "amax", "argmin", "argmax", "sum_np", "mean_np", "std",
    "nanmin", "nanmax", "nanargmin", "nanargmax", "nansum", "nanmean", "nanstd",
    "nan_to_num", "around", "clip", "stack", "concatenate", "expand_dims",
    "squeeze", "pad", "where", "all_np", "any_np", "zeros_like", "ones_like",
    "shares_memory", "may_share_memory",
]

_HANDLED_NUMPY_FUNCTIONS = {}


def implements(*np_functions):
    """Register an ``__array_function__`` implementation for MedicalVolume."""

    def decorator(func):
        for np_func in np_functions:
            _HANDLED_NUMPY_FUNCTIONS[np_func] = func
        return func

    return decorator


# ----------------------------------------------------------------------
# Reductions over non-spatial axes (or the whole volume)
# ----------------------------------------------------------------------
def _dims(x: torch.Tensor, axis):
    if axis is None:
        return tuple(range(x.ndim))
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def _floating(x: torch.Tensor, dtype=None) -> torch.Tensor:
    """numpy's mean/std promote integers and booleans to float64."""
    if dtype is not None:
        return x.to(_torch_dtype(dtype))
    return x if x.is_floating_point() else x.to(torch.float64)


def _per_dim(fn, x, axis, keepdims):
    """Apply a one-dim torch reduction over each axis, last first."""
    for dim in sorted(_dims(x, axis), reverse=True):
        x = fn(x, dim=dim, keepdim=keepdims)
    return x


def _nan_fill(x, fill):
    return torch.where(torch.isnan(x), torch.full_like(x, fill), x) if x.is_floating_point() else x


def _t_amin(x, axis=None, keepdims=False, **_):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdims)


def _t_amax(x, axis=None, keepdims=False, **_):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdims)


def _t_argmin(x, axis=None, keepdims=False, **_):
    return torch.argmin(x, dim=axis, keepdim=keepdims and axis is not None)


def _t_argmax(x, axis=None, keepdims=False, **_):
    return torch.argmax(x, dim=axis, keepdim=keepdims and axis is not None)


def _t_sum(x, axis=None, keepdims=False, dtype=None, **_):
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims,
                     dtype=None if dtype is None else _torch_dtype(dtype))


def _t_mean(x, axis=None, keepdims=False, dtype=None, **_):
    return torch.mean(_floating(x, dtype), dim=_dims(x, axis), keepdim=keepdims)


def _t_std(x, axis=None, keepdims=False, dtype=None, ddof=0, **_):
    return torch.std(_floating(x, dtype), dim=_dims(x, axis), correction=ddof, keepdim=keepdims)


def _t_nanmin(x, axis=None, keepdims=False, **_):
    out = torch.amin(_nan_fill(x, float("inf")), dim=_dims(x, axis), keepdim=keepdims)
    if not x.is_floating_point():
        return out
    all_nan = torch.isnan(x).all(dim=_dims(x, axis), keepdim=keepdims)
    return torch.where(all_nan, torch.full_like(out, float("nan")), out)


def _t_nanmax(x, axis=None, keepdims=False, **_):
    return -_t_nanmin(-x, axis=axis, keepdims=keepdims)


def _t_nanargmin(x, axis=None, keepdims=False, **_):
    return _t_argmin(_nan_fill(x, float("inf")), axis=axis, keepdims=keepdims)


def _t_nanargmax(x, axis=None, keepdims=False, **_):
    return _t_argmax(_nan_fill(x, float("-inf")), axis=axis, keepdims=keepdims)


def _t_nansum(x, axis=None, keepdims=False, dtype=None, **_):
    return torch.nansum(x, dim=_dims(x, axis), keepdim=keepdims,
                        dtype=None if dtype is None else _torch_dtype(dtype))


def _t_nanmean(x, axis=None, keepdims=False, dtype=None, **_):
    return torch.nanmean(_floating(x, dtype), dim=_dims(x, axis), keepdim=keepdims)


def _t_nanstd(x, axis=None, keepdims=False, dtype=None, ddof=0, **_):
    x = _floating(x, dtype)
    dims = _dims(x, axis)
    mean = torch.nanmean(x, dim=dims, keepdim=True)
    count = (~torch.isnan(x)).sum(dim=dims, keepdim=keepdims)
    sq = torch.nansum((x - mean) ** 2, dim=dims, keepdim=keepdims)
    return torch.sqrt(sq / (count - ddof))


def _t_all(x, axis=None, keepdims=False, **_):
    return _per_dim(torch.all, x, axis, keepdims) if axis is not None else torch.all(x)


def _t_any(x, axis=None, keepdims=False, **_):
    return _per_dim(torch.any, x, axis, keepdims) if axis is not None else torch.any(x)


_REDUCTIONS = {  # name: (numpy function, torch implementation)
    "amin": (np.amin, _t_amin),
    "amax": (np.amax, _t_amax),
    "argmin": (np.argmin, _t_argmin),
    "argmax": (np.argmax, _t_argmax),
    "sum": (np.sum, _t_sum),
    "mean": (np.mean, _t_mean),
    "std": (np.std, _t_std),
    "nanmin": (np.nanmin, _t_nanmin),
    "nanmax": (np.nanmax, _t_nanmax),
    "nanargmin": (np.nanargmin, _t_nanargmin),
    "nanargmax": (np.nanargmax, _t_nanargmax),
    "nansum": (np.nansum, _t_nansum),
    "nanmean": (np.nanmean, _t_nanmean),
    "nanstd": (np.nanstd, _t_nanstd),
    "all": (np.all, _t_all),
    "any": (np.any, _t_any),
}
# numpy-shadowing names get a `_np` suffix, matching the JAX package's exports.
_ALIAS = {"sum": "sum_np", "mean": "mean_np", "all": "all_np", "any": "any_np"}


def reduce_array_op(fname, x, axis=None, **kwargs):
    np_func, torch_func = _REDUCTIONS[fname]
    kwargs = {k: v for k, v in kwargs.items() if v is not _NoValue and v is not np._NoValue}
    func = torch_func if _is_tensor(x.A) else np_func
    return x._reduce_array(func, x.A, axis=axis, **kwargs)


def _make_reduction(fname):
    def reduction(x, axis=None, **kwargs):
        return reduce_array_op(fname, x, axis=axis, **kwargs)

    reduction.__name__ = reduction.__qualname__ = fname
    reduction.__doc__ = f"``{fname}`` over a MedicalVolume (numpy on the host, torch on tensors)."
    return reduction


for _fname, (_np_func, _) in _REDUCTIONS.items():
    globals()[_ALIAS.get(_fname, _fname)] = implements(_np_func)(_make_reduction(_fname))
del _fname, _np_func


# ----------------------------------------------------------------------
# Elementwise
# ----------------------------------------------------------------------
@implements(np.nan_to_num)
def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    if _is_tensor(x.A):
        return x._partial_clone(volume=torch.nan_to_num(x.A, nan=nan, posinf=posinf, neginf=neginf))
    vol = np.nan_to_num(x.A, copy=copy, nan=nan, posinf=posinf, neginf=neginf)
    return x._partial_clone(volume=vol) if copy else x


@implements(np.around, np.round)
def around(x, decimals=0, affine=False):
    """Round volume (and optionally affine). Tensors round half to even,
    as numpy does; integer tensors round only for negative ``decimals``."""
    affine_mat = np.around(x.affine, decimals) if affine else x.affine
    vol = x.A
    if not _is_tensor(vol):
        vol = np.around(vol, decimals)
    elif vol.is_floating_point():
        vol = torch.round(vol, decimals=decimals)
    elif decimals < 0:
        vol = torch.round(vol.to(torch.float64), decimals=decimals).to(vol.dtype)
    else:
        vol = vol.clone()
    return x._partial_clone(volume=vol, affine=affine_mat)


def _operand(v, ref: MedicalVolume):
    """A bound or choice for clip / where: a volume reformatted to ``ref``'s
    orientation, an array, or a scalar, as a tensor on ``ref``'s device when
    ``ref`` is tensor-backed."""
    if isinstance(v, MedicalVolume):
        v = v.reformat_as(ref).A
    if _is_tensor(ref.A) and v is not None and not isinstance(v, (int, float, bool)):
        v = as_tensor(v, ref.A.device)
    return v


@implements(np.clip)
def clip(x, x_min=None, x_max=None, **kwargs):
    x_min, x_max = _operand(x_min, x), _operand(x_max, x)
    if _is_tensor(x.A):
        if kwargs:
            raise TypeError(f"clip of a tensor-backed volume takes no {sorted(kwargs)}")
        return x._partial_clone(volume=torch.clamp(x.A, x_min, x_max))
    return x._partial_clone(volume=np.clip(x.A, x_min, x_max, **kwargs))


# ----------------------------------------------------------------------
# Stacking and concatenation
# ----------------------------------------------------------------------
def _arrays(xs):
    """The volumes' arrays, all tensors on the first one's device if it is
    tensor-backed."""
    if _is_tensor(xs[0].A):
        return [as_tensor(x.A, xs[0].A.device) for x in xs]
    return [np.asarray(x.A) for x in xs]


@implements(np.stack)
def stack(xs, axis: int = -1):
    """Stack volumes across a NON-spatial axis (default ``-1``), auto-orienting
    to the first volume."""
    if not isinstance(axis, int):
        raise TypeError(f"'{type(axis)}' cannot be interpreted as int")

    xs = [x.reformat(xs[0].orientation) for x in xs]
    affine = xs[0].affine
    for x in xs[1:]:
        x.is_same_dimensions(xs[0], err=True)
    try:
        axis = _to_positive_axis(axis, len(xs[0].shape), grow=True, invalid_axis="spatial")
    except ValueError:
        raise ValueError(f"Cannot stack across spatial dimension (axis={axis})")

    arrays = _arrays(xs)
    vol = torch.stack(arrays, dim=axis) if _is_tensor(arrays[0]) else np.stack(arrays, axis=axis)
    headers = [x.headers() for x in xs]
    if any(h is None for h in headers):
        headers = None
    else:
        headers = np.stack(headers, axis=axis)
    return MedicalVolume(vol, affine, headers=headers)


@implements(np.concatenate)
def concatenate(xs, axis: int = -1):
    """Concatenate volumes. Spatial concat requires same direction/spacing and
    contiguous origins; non-spatial requires equal affines."""
    if not isinstance(axis, int):
        raise TypeError(f"'{type(axis)}' cannot be interpreted as int")

    xs = [x.reformat(xs[0].orientation) for x in xs]
    axis = _to_positive_axis(axis, len(xs[0].shape), grow=False, invalid_axis=None)

    if axis in range(3):
        for i, x in enumerate(xs[1:]):
            if not x._allclose_spacing(xs[0], precision=None, ignore_origin=True):
                raise ValueError(
                    "All the inputs must have the same direction and pixel spacing "
                    "when concatenating spatial dimensions, but input at index 0 has "
                    f"affine {xs[0].affine[:3, :3]} and the input at index {i} has "
                    f"affine {x.affine[:3, :3]}"
                )
        for i, (x1, x2) in enumerate(zip(xs[:-1], xs[1:])):
            ijk1 = np.array([0.0, 0, 0, 1])
            ijk1[axis] = x1.shape[axis]
            xyz = (x1.affine @ ijk1)[:3]
            if not (np.asarray(x2.scanner_origin) == xyz).all():
                raise ValueError(
                    "All the inputs must be sequentially increasing in space "
                    f"when concatenating spatial dimensions, but input at index {i} "
                    f"ends at xyz location {xyz} and the input at index {i + 1} "
                    f"starts at xyz location {x2.scanner_origin}"
                )
    else:
        for i, x in enumerate(xs[1:]):
            if not x._allclose_spacing(xs[0], precision=None):
                raise ValueError(
                    "All the inputs must have the same affine matrix when concatenating "
                    f"non-spatial dimensions, but input at index 0 has affine {xs[0].affine} "
                    f"and the input at index {i} has affine {x.affine}"
                )

    arrays = _arrays(xs)
    if _is_tensor(arrays[0]):
        volume = torch.cat(arrays, dim=axis)
    else:
        volume = np.concatenate(arrays, axis=axis)
    headers = [x.headers() for x in xs]
    if any(h is None for h in headers):
        headers = None
    else:
        headers = np.concatenate(headers, axis=axis)
        if headers.ndim != volume.ndim or any(
            hs != 1 and hs != vs for hs, vs in zip(headers.shape, volume.shape)
        ):
            warnings.warn(
                f"Got invalid headers shape ({headers.shape}) given concatenated output "
                f"shape ({tuple(volume.shape)}). Dropping all headers in concatenated output."
            )
            headers = None

    return MedicalVolume(volume, xs[0].affine, headers=headers)


# ----------------------------------------------------------------------
# Shape operations
# ----------------------------------------------------------------------
@implements(np.expand_dims)
def expand_dims(x, axis: Union[int, Sequence[int]]):
    try:
        axis = _to_positive_axis(axis, len(x.shape), grow=True, invalid_axis="spatial")
    except ValueError:
        raise ValueError(f"Cannot expand across spatial dimensions (axis={axis})")
    if _is_tensor(x.A):
        vol = x.A
        for a in sorted(axis if isinstance(axis, tuple) else (axis,)):
            vol = vol.unsqueeze(a)
    else:
        vol = np.expand_dims(x.A, axis)
    headers = x.headers()
    if headers is not None:
        headers = np.expand_dims(headers, axis)
    return x._partial_clone(volume=vol, headers=headers)


@implements(np.squeeze)
def squeeze(x, axis: Union[int, Sequence[int]] = None):
    if axis is not None:
        try:
            axis = _to_positive_axis(axis, len(x.shape), grow=False, invalid_axis="spatial")
        except ValueError:
            raise ValueError(f"Cannot squeeze across spatial dimensions (axis={axis})")
    else:
        axis = tuple(i for i in range(3, len(x.shape)) if x.shape[i] == 1)
        if not axis:
            return x

    axes = axis if isinstance(axis, tuple) else (axis,)
    if _is_tensor(x.A):
        if any(x.shape[a] != 1 for a in axes):
            raise ValueError("cannot select an axis to squeeze out which has size not equal to one")
        vol = x.A
        for a in sorted(axes, reverse=True):
            vol = vol.squeeze(a)
    else:
        vol = np.squeeze(x.A, axis=axis)
    headers = x.headers()
    if headers is not None:
        headers = np.squeeze(headers, axis=axis)
    return x._partial_clone(volume=vol, headers=headers)


@implements(np.pad)
def pad(x: MedicalVolume, pad_width, mode="constant", **kwargs):
    """Pad; spatial padding shifts the scanner origin; headers are dropped.
    A tensor-backed volume takes ``mode="constant"`` (``constant_values`` a
    scalar)."""
    if _is_int(pad_width):
        pad_width = ((pad_width,),) * x.ndim
    if len(pad_width) < x.ndim:
        pad_width = ((0,),) * (x.ndim - len(pad_width)) + tuple(pad_width)
    pad_width = tuple((0,) if p is None else (p,) if _is_int(p) else tuple(p) for p in pad_width)
    pad_width = tuple(p * 2 if len(p) == 1 else p for p in pad_width)
    if not all(len(p) == 2 for p in pad_width):
        raise ValueError(f"Invalid pad_width {pad_width}")

    ijk = np.asarray([-p[0] for p in pad_width[:3]] + [0], dtype=np.float64)
    origin = x.affine @ (ijk + np.array([0, 0, 0, 1.0]))
    affine = x.affine.copy()
    affine[:, 3] = origin

    if _is_tensor(x.A):
        value = kwargs.pop("constant_values", 0)
        if mode != "constant" or kwargs or not np.isscalar(value):
            raise NotImplementedError(
                "pad of a tensor-backed volume supports mode='constant' with a scalar "
                f"constant_values; got mode={mode!r}, {kwargs}"
            )
        flat = [int(v) for p in reversed(pad_width) for v in p]
        arr = torch.nn.functional.pad(x.A, flat, mode="constant", value=value)
    else:
        arr = np.pad(x.A, pad_width, mode=mode, **kwargs)
    return x._partial_clone(volume=arr, affine=affine, headers=None)


@implements(np.where)
def where(*args, **kwargs):
    """The condition-only form returns indices (tensors for a tensor-backed
    volume); the 3-argument form returns a volume when one participates."""
    ref = next((a for a in args if isinstance(a, MedicalVolume)), None)
    on_torch = ref is not None and _is_tensor(ref.A)
    if len(args) == 1:
        cond = args[0].A if isinstance(args[0], MedicalVolume) else args[0]
        return torch.where(as_tensor(cond)) if on_torch else np.where(np.asarray(cond), **kwargs)
    if on_torch:
        cond, a, b = (_operand(v, ref) for v in args)
        out = torch.where(cond.to(torch.bool), torch.as_tensor(a, device=ref.A.device),
                          torch.as_tensor(b, device=ref.A.device))
    else:
        np_args = [np.asarray(a.A) if isinstance(a, MedicalVolume) else a for a in args]
        out = np.where(*np_args, **kwargs)
    if ref is not None:
        return ref._partial_clone(volume=out, headers=None)
    return out


def _make_fill_like(fname, np_func, torch_func):
    def fill_like(a, dtype=None, order="K", subok=True, shape=None):
        if _is_tensor(a.A):
            dt = None if dtype is None else _torch_dtype(dtype)
            if shape is None:
                vol = torch_func(a.A, dtype=dt)
            else:
                vol = getattr(torch, fname.split("_")[0])(
                    shape, dtype=dt or a.A.dtype, device=a.A.device)
        else:
            vol = np_func(a.A, dtype=dtype, order=order, subok=subok, shape=shape)
        return a._partial_clone(volume=vol)

    fill_like.__name__ = fname
    return fill_like


zeros_like = implements(np.zeros_like)(_make_fill_like("zeros_like", np.zeros_like,
                                                       torch.zeros_like))
ones_like = implements(np.ones_like)(_make_fill_like("ones_like", np.ones_like, torch.ones_like))


def _tensor_overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True if the two tensors' byte ranges overlap in one storage."""
    if a.device != b.device or a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr():
        return False
    if a.numel() == 0 or b.numel() == 0:
        return False

    def span(t):
        lo = t.data_ptr()
        hi = lo + sum((s - 1) * st for s, st in zip(t.shape, t.stride())) * t.element_size()
        return lo, hi + t.element_size()

    (lo_a, hi_a), (lo_b, hi_b) = span(a), span(b)
    return lo_a < hi_b and lo_b < hi_a


def _make_memory_check(np_func):
    """Volume AND header buffers must both satisfy the memory predicate."""

    def check(a, b, max_work=None):
        if _is_tensor(a.A) or _is_tensor(b.A):
            same = _is_tensor(a.A) and _is_tensor(b.A) and _tensor_overlap(a.A, b.A)
        else:
            same = np_func(a.A, b.A, max_work=max_work)
        if a.headers() is not None or b.headers() is not None:
            same = same and np_func(a.headers(), b.headers(), max_work=max_work)
        return same

    check.__name__ = np_func.__name__
    return check


shares_memory = implements(np.shares_memory)(_make_memory_check(np.shares_memory))
may_share_memory = implements(np.may_share_memory)(_make_memory_check(np.may_share_memory))


def _to_positive_axis(
    axis: Union[int, Sequence[int]],
    ndim: int,
    grow: bool = False,
    invalid_axis: Union[str, int, Sequence[int]] = None,
):
    """Convert axis to positive form; ``grow=True`` treats out-of-range axes
    as referring to the post-op (grown) dimensionality."""
    original_axis = axis
    is_sequence = isinstance(axis, Sequence)
    if not is_sequence:
        axis = (axis,)
    if grow:
        ndim += sum(x < 0 or x >= ndim for x in axis)
    axis = tuple(x if x >= 0 else ndim + x for x in axis)

    if invalid_axis is not None:
        if invalid_axis == "spatial":
            invalid_axis = tuple(range(3))
        elif not isinstance(invalid_axis, Sequence):
            invalid_axis = (invalid_axis,)
        if any(x in invalid_axis for x in axis):
            raise ValueError(
                f"Invalid axes {original_axis}. Specified axes should not be in {invalid_axis}"
            )
    return axis if is_sequence else axis[0]


def _is_int(x):
    return isinstance(x, (int, np.integer))
