"""Quantitative fitting: ``CurveFitter``, ``PolyFitter``, ``MonoExponentialFit``,
``curve_fit`` and ``polyfit``.

Counterpart of ``dosma_tpu/core/fitting.py``. Tensors are fit where they
lie: on a CUDA card by a hand-written kernel (or plain torch), on the CPU by
the plain PyTorch versions of the same algorithms. Host (numpy) data is
moved to the package's default device (the first CUDA card unless the
caller asked for another, :mod:`dosma_tpu_torch.core.device`), fit there,
and returned as host data. Data on a card is never moved to the host to be
fit; only the per-sequence scipy loop (models that torch cannot
differentiate, or scipy-only options) works on host copies, as in
``dosma_tpu``.

``curve_fit`` routes by model:

- the library :func:`monoexponential` (or ``kernel="pallas_monoexp"``) →
  :func:`dosma_tpu_torch.ops.monoexp.monoexp_lm`;
- the library :func:`biexponential` (or ``kernel="pallas_biexp"``) →
  :func:`dosma_tpu_torch.ops.biexp.biexp_lm`;
- any other model that :func:`dosma_tpu_torch.ops.generic_lm.compile_model`
  accepts (whitelisted torch operations, P ≤ 4) →
  :func:`dosma_tpu_torch.ops.generic_lm.generic_lm`; a refused model goes
  to :func:`dosma_tpu_torch.ops.nlls.lm_fit` on the same device, with a
  warning that names the refused node;
- a model that ``torch.func.jvp`` cannot differentiate, or scipy-only
  keyword arguments → the per-sequence scipy loop.

``_Fitter.fit`` flattens, masks, post-processes and scatters on the
volumes' device. ``out_ufuncs`` receive numpy arrays for numpy-backed
volumes (exactly as in ``dosma_tpu``) and tensors for tensor-backed ones,
so a ufunc meant for volumes on a card must be written in torch operations.
"""

from __future__ import annotations

import functools
import inspect
import warnings
from copy import deepcopy
from numbers import Number
from typing import Callable, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dosma_tpu_torch import defaults
from dosma_tpu_torch.core.device import as_tensor, compute_device
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.utils.profiling import annotate

__all__ = [
    "CurveFitter",
    "PolyFitter",
    "MonoExponentialFit",
    "curve_fit",
    "polyfit",
    "monoexponential",
    "biexponential",
]

_NoValue = object()
_KERNELS = ("auto", "pallas_monoexp", "pallas_biexp", "generic")


def _on_torch(*args) -> bool:
    # torch.fx proxies count too, so compile_model can trace the library models.
    return any(isinstance(v, (torch.Tensor, torch.fx.Proxy)) for v in args)


def monoexponential(x, a, b):
    """:math:`f(x) = a e^{b x}` (numpy arrays or torch tensors)."""
    if _on_torch(x, a, b):
        return a * torch.exp(b * x)
    return a * np.exp(b * x)


def biexponential(x, a1, b1, a2, b2):
    """:math:`f(x) = a_1 e^{b_1 x} + a_2 e^{b_2 x}` (numpy arrays or torch tensors)."""
    if _on_torch(x, a1, b1, a2, b2):
        return a1 * torch.exp(b1 * x) + a2 * torch.exp(b2 * x)
    return a1 * np.exp(b1 * x) + a2 * np.exp(b2 * x)


def _func_nparams(func: Callable) -> Tuple[int, list]:
    func_args = list(inspect.signature(func).parameters)
    if "self" in func_args:
        return len(func_args) - 2, func_args[2:]
    return len(func_args) - 1, func_args[1:]


def _as_torch_model(func: Callable, nparams: int) -> Optional[Callable]:
    """Wrap a scipy-style ``f(x, *params)`` as the batched model the LM
    engines take: ``model(x_col (T, 1), params tuple of (N,)) → (T, N)``.

    Returns None unless ``func``, probed with a (3, 1) ``x`` and (5,)
    parameters that carry forward-mode tangents, gives a (3, 5) tensor.
    """

    def model(x_col, params):
        return func(x_col, *params)

    x_col = torch.zeros((3, 1))
    params = tuple(torch.zeros(5) for _ in range(nparams))
    tangents = tuple(torch.ones(5) for _ in range(nparams))
    try:
        out, _ = torch.func.jvp(lambda *ps: model(x_col, ps), params, tangents)
    except Exception:  # any failure means the model is not torch-traceable
        return None
    if not isinstance(out, torch.Tensor) or tuple(out.shape) != (3, 5):
        return None
    return model


def _host_x(x) -> np.ndarray:
    """Sample positions as a host array (they are a few numbers)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _select(arr, mask):
    """``arr[mask]`` with the boolean mask moved to ``arr``'s kind and device."""
    if isinstance(arr, torch.Tensor):
        if not isinstance(mask, torch.Tensor):
            mask = torch.from_numpy(np.asarray(mask))
        return arr[mask.to(arr.device)]
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return arr[mask]


def _flat(arr):
    return arr.reshape(-1) if isinstance(arr, torch.Tensor) else np.asarray(arr).flatten()


def _flat_tensor(vol) -> torch.Tensor:
    """A volume's pixels as a flat float32 tensor on the volume's own device."""
    if not isinstance(vol, torch.Tensor):
        vol = torch.from_numpy(np.ascontiguousarray(vol))
    return vol.to(torch.float32).reshape(-1)


class _Fit:
    """Abstract base for quantitative-value fits."""

    def fit(self) -> Tuple[MedicalVolume, MedicalVolume]:
        raise NotImplementedError  # pragma: no cover


# ----------------------------------------------------------------------
# Option validators shared by the fitter facades.
# ----------------------------------------------------------------------
def _validate_out_ufuncs(ufuncs, nparams: int):
    ok = isinstance(ufuncs, Callable) or all(
        fn is None or isinstance(fn, Callable) for fn in ufuncs
    )
    if not ok:
        raise TypeError(f"`out_ufuncs` must be callable or sequence of callables. Got {ufuncs}")
    if isinstance(ufuncs, Sequence) and len(ufuncs) > nparams:
        warnings.warn(
            f"len(out_ufuncs)={len(ufuncs)}, but only {nparams} parameters. "
            f"Extra ufuncs will be ignored."
        )
    return ufuncs


def _validate_out_bounds(bounds):
    bounds = np.asarray(bounds)
    if bounds.shape[-1] != 2 or bounds.ndim > 2:
        raise ValueError("Invalid `out_bounds` - shape must be ([num_params,] 2)")
    if np.any(bounds[..., 0] > bounds[..., 1]):
        raise ValueError("Invalid `out_bounds` - lower bound must be <= upper bound")
    return bounds


def _validate_r2_threshold(threshold):
    if isinstance(threshold, str):
        if threshold != "preferences":
            raise ValueError(
                f"Invalid value r2_threshold='{threshold}'. "
                f"Expected `None`, a number between [0, 1], or 'preferences'."
            )
        return preferences.fitting_r2_threshold
    return threshold


def _bounds_as_rows(bounds: np.ndarray, nparams: int):
    """(lb_row, ub_row) broadcastable against a (..., P) param array."""
    if bounds.ndim == 2:
        missing = nparams - bounds.shape[0]
        if missing > 0:
            fill = np.tile(np.array([[-np.inf, np.inf]]), (missing, 1))
            bounds = np.concatenate([bounds, fill], axis=0)
        bounds = bounds.T
    return bounds[0], bounds[1]


class _Fitter:
    """MedicalVolume-level fitting: reorient → flatten → (mask-select) →
    ``_fit`` → post-process → scatter back → rewrap as MedicalVolumes, all
    on the volumes' device."""

    nan_to_num: Optional[float]
    out_ufuncs: Optional[Union[Callable, Sequence[Callable]]]
    out_bounds: Optional[np.ndarray]
    r2_threshold: Optional[float]
    y_bounds: Optional[Tuple[float, float]]

    def _process_mask(self, mask, y: MedicalVolume):
        if isinstance(mask, (np.ndarray, torch.Tensor)):
            mask = y._partial_clone(volume=mask, headers=None)
        elif not isinstance(mask, MedicalVolume):
            raise TypeError("`mask` must be a MedicalVolume or ndarray")
        mask = mask.reformat_as(y)
        if not mask.is_same_dimensions(y, defaults.AFFINE_DECIMAL_PRECISION):
            raise RuntimeError("`mask` and `y` dimension mismatch")
        return mask > 0

    def _process_params(self, x, r_squared):
        """Post-process pipeline: out_ufuncs → out_bounds → r² threshold →
        nan_to_num, on numpy arrays or tensors. ``x``: (..., P), in place
        where possible."""
        nparams = x.shape[-1]
        on_torch = isinstance(x, torch.Tensor)

        if isinstance(self.out_ufuncs, Callable):
            x = self.out_ufuncs(x)
        elif isinstance(self.out_ufuncs, Sequence):
            for i, fn in enumerate(self.out_ufuncs[:nparams]):
                if fn is not None:
                    x[..., i] = fn(x[..., i])

        if self.out_bounds is not None:
            lb, ub = _bounds_as_rows(self.out_bounds, nparams)
            if on_torch:
                # Compare in float64, as numpy does against float64 bounds.
                lb, ub = (torch.as_tensor(v, dtype=torch.float64, device=x.device) for v in (lb, ub))
                xd = x.to(torch.float64)
                x[(xd < lb) | (xd > ub)] = torch.nan
            else:
                with np.errstate(invalid="ignore"):
                    x[(x < lb) | (x > ub)] = np.nan

        if self.r2_threshold is not None:
            x[r_squared < self.r2_threshold] = np.nan

        if self.nan_to_num is not None:
            if on_torch:
                x = torch.nan_to_num(x, nan=self.nan_to_num)
            else:
                x = np.nan_to_num(x, nan=self.nan_to_num, copy=False)
        return x

    def _fit(self, x, y, **kwargs):
        raise NotImplementedError  # pragma: no cover

    @staticmethod
    def _flatten_echoes(y: Sequence[MedicalVolume]) -> torch.Tensor:
        """(T, N) tensor on the volumes' device: one row per echo."""
        vols = [v.volume for v in y]
        if all(isinstance(v, np.ndarray) for v in vols):
            return torch.from_numpy(np.concatenate([np.asarray(v).reshape(1, -1) for v in vols]))
        ts = [v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
              for v in vols]
        dtype = functools.reduce(torch.promote_types, [t.dtype for t in ts])
        return torch.stack([t.to(dtype).reshape(-1) for t in ts], dim=0)

    def _scatter_to_volume(self, popt, r_squared, mask, n_total):
        """Place masked-fit results back into full-length vectors."""
        fill = np.nan if self.nan_to_num is None else self.nan_to_num
        if isinstance(popt, torch.Tensor):
            popt_full = popt.new_full((n_total,) + tuple(popt.shape[-1:]), fill)
            r2_full = r_squared.new_full((n_total,), fill)
        else:
            popt_full = np.full((n_total,) + popt.shape[-1:], fill, popt.dtype)
            r2_full = np.full((n_total,), fill, r_squared.dtype)
        popt_full[mask] = popt
        r2_full[mask] = r_squared
        return popt_full, r2_full

    @staticmethod
    def _wrap_outputs(ref: MedicalVolume, popt, r_squared, copy_headers: bool):
        if not copy_headers:
            return (
                ref._partial_clone(volume=popt, headers=None),
                ref._partial_clone(volume=r_squared, headers=None),
            )
        headers = ref.headers()
        if headers is not None:
            headers = deepcopy(headers)
            extra_dims = popt.ndim - ref.volume.ndim
            if extra_dims > 0:
                headers = np.expand_dims(headers, axis=tuple(range(-extra_dims, 0)))
        return (
            ref._partial_clone(volume=popt, headers=headers),
            ref._partial_clone(volume=r_squared, headers=True),
        )


    def fit(self, x, y: Sequence[MedicalVolume], mask=None, copy_headers: bool = True, **kwargs):
        """Fit ``y`` volumes against ``x``.

        Numpy-backed volumes are fit on the default device and give
        numpy-backed maps; tensor-backed volumes are fit on their device and
        give tensor-backed maps there.
        """
        if not isinstance(y, (list, tuple)) or not all(isinstance(v, MedicalVolume) for v in y):
            raise TypeError("`y` must be sequence of MedicalVolumes.")

        x = _host_x(x)
        if x.shape[-1] != len(y):
            raise ValueError(
                f"Dimension mismatch: x.shape[-1]={x.shape[-1]}, but len(y)={len(y)}"
            )

        y = [v.reformat(y[0].orientation) for v in y]
        if len({v.device for v in y}) != 1:
            raise ValueError(f"`y` volumes lie on several devices: {[v.device for v in y]}")
        ref = y[0]
        host = all(isinstance(v.volume, np.ndarray) for v in y)

        svs = self._flatten_echoes(y).to(compute_device(*(v.volume for v in y)))
        n_total = svs.shape[-1]
        if mask is not None:
            mask = self._process_mask(mask, ref).volume.reshape(-1)
            if not isinstance(mask, torch.Tensor):
                mask = torch.from_numpy(np.ascontiguousarray(mask))
            mask = mask.to(svs.device)
            svs = svs[:, mask]

        popt, r_squared = self._fit(x, svs, **kwargs)
        if host:
            # Writable host copies for the numpy post-processing.
            popt, r_squared = np.array(popt.cpu().numpy()), np.array(r_squared.cpu().numpy())
            mask = None if mask is None else mask.cpu().numpy()
        popt = self._process_params(popt, r_squared)

        if mask is not None:
            popt, r_squared = self._scatter_to_volume(popt, r_squared, mask, n_total)

        popt = popt.reshape(tuple(ref.shape) + tuple(popt.shape[-1:]))
        r_squared = r_squared.reshape(tuple(ref.shape))
        return self._wrap_outputs(ref, popt, r_squared, copy_headers)


class CurveFitter(_Fitter):
    """Nonlinear least-squares fitter over MedicalVolumes.

    The constructor surface of ``dosma_tpu.CurveFitter``; the fit runs on
    the volumes' device through :func:`curve_fit`. ``kernel`` is passed to
    :func:`curve_fit`.
    """

    def __init__(
        self,
        func: Callable,
        p0: Sequence[float] = None,
        y_bounds: Tuple[float, float] = None,
        out_ufuncs: Union[Callable, Sequence[Callable]] = None,
        out_bounds=None,
        r2_threshold: Union[float, str] = "preferences",
        nan_to_num: float = None,
        num_workers: int = 0,
        chunksize: int = None,
        verbose: bool = False,
        kernel: str = "auto",
        **kwargs,
    ):
        func_name = func.__name__ if hasattr(func, "__name__") else type(func).__name__
        nparams, _ = _func_nparams(func)

        if out_ufuncs is not None:
            out_ufuncs = _validate_out_ufuncs(out_ufuncs, nparams)
        if out_bounds is not None:
            out_bounds = _validate_out_bounds(out_bounds)
        r2_threshold = _validate_r2_threshold(r2_threshold)

        self._func = func
        self._func_name = func_name
        self.p0 = self._format_p0(p0)
        self.y_bounds = y_bounds
        self.out_ufuncs = out_ufuncs
        self.out_bounds = out_bounds
        self.r2_threshold = r2_threshold
        self.nan_to_num = nan_to_num
        self.num_workers = num_workers
        self.chunksize = chunksize
        self.verbose = verbose
        self.kernel = kernel
        self.kwargs = kwargs

    def _format_p0(self, p0, ref: MedicalVolume = None, flatten=False, mask=None, depth=0):
        """Normalize p0 (scalar, sequence, dict, array, tensor or MedicalVolume)."""
        if p0 is None or isinstance(p0, Number):
            return p0
        elif isinstance(p0, MedicalVolume) and depth > 0:
            if ref is not None:
                p0 = p0.reformat_as(ref)
                assert p0.is_same_dimensions(ref, err=True)
            if flatten:
                p0 = _flat(p0.A)
                if mask is not None:
                    p0 = _select(p0, mask)
            return p0
        elif isinstance(p0, (np.ndarray, torch.Tensor)) and depth > 0:
            if ref is not None and tuple(p0.shape) != tuple(ref.shape):
                raise ValueError(f"Got p0.shape={tuple(p0.shape)}, but y.shape={ref.shape}")
            if flatten:
                p0 = _flat(p0)
            if mask is not None:
                p0 = _select(p0, mask)
            return p0

        if isinstance(p0, Mapping):
            return {k: self._format_p0(v, ref, flatten, mask, depth + 1) for k, v in p0.items()}
        elif isinstance(p0, Sequence):
            return tuple(self._format_p0(v, ref, flatten, mask, depth + 1) for v in p0)
        elif isinstance(p0, (np.ndarray, torch.Tensor, MedicalVolume)):
            return tuple(
                self._format_p0(p0[..., i], ref, flatten, mask, depth + 1)
                for i in range(p0.shape[-1])
            )
        raise ValueError(f"p0={p0} not supported")

    def fit(self, x, y: Sequence[MedicalVolume], mask=None, p0=_NoValue, copy_headers=True):
        if mask is not None:
            mask = self._process_mask(mask, y[0])

        if p0 is _NoValue:
            p0 = self.p0
        p0 = self._format_p0(
            p0, ref=y[0], flatten=True, mask=mask.A.reshape(-1) if mask is not None else None,
        )
        return super().fit(x, y, mask=mask, p0=p0, copy_headers=copy_headers)

    def _fit(self, x, y, p0=_NoValue):
        assert p0 is not _NoValue
        return curve_fit(
            self._func,
            x,
            y,
            self.y_bounds,
            p0=p0,
            show_pbar=self.verbose,
            num_workers=self.num_workers,
            chunksize=self.chunksize,
            kernel=self.kernel,
            **self.kwargs,
        )

    def __str__(self):
        attrs = ["p0", "y_bounds", "out_bounds", "r2_threshold", "nan_to_num"]
        vals = [f"func={self._func_name}"] + [f"{k}={getattr(self, k)}" for k in attrs]
        return f"{self.__class__.__name__}({', '.join(vals)})"


class PolyFitter(_Fitter):
    """Polynomial least-squares fitter over MedicalVolumes.

    ``num_workers`` is accepted for API parity: the joint batched solve is
    exact, so there is nothing to distribute.
    """

    def __init__(
        self,
        deg: int,
        rcond: float = None,
        y_bounds: Tuple[float, float] = None,
        out_ufuncs: Union[Callable, Sequence[Callable]] = None,
        out_bounds=None,
        r2_threshold: Union[float, str] = "preferences",
        nan_to_num: float = None,
        num_workers: int = None,
        chunksize: int = None,
        verbose: bool = False,
    ):
        if out_ufuncs is not None:
            out_ufuncs = _validate_out_ufuncs(out_ufuncs, deg + 1)
        if out_bounds is not None:
            out_bounds = _validate_out_bounds(out_bounds)
        r2_threshold = _validate_r2_threshold(r2_threshold)

        self.deg = deg
        self.rcond = rcond
        self.y_bounds = y_bounds
        self.out_ufuncs = out_ufuncs
        self.out_bounds = out_bounds
        self.r2_threshold = r2_threshold
        self.nan_to_num = nan_to_num
        self.num_workers = num_workers
        self.chunksize = chunksize
        self.verbose = verbose

    def fit(self, x, y: Sequence[MedicalVolume], mask=None, copy_headers: bool = True):
        return super().fit(x, y, mask=mask, copy_headers=copy_headers)

    def _fit(self, x, y):
        return polyfit(
            x,
            y,
            deg=self.deg,
            rcond=self.rcond,
            y_bounds=self.y_bounds,
            show_pbar=self.verbose,
            num_workers=self.num_workers,
            chunksize=self.chunksize,
        )

    def __str__(self):
        attrs = ["deg", "rcond", "y_bounds", "out_bounds", "r2_threshold", "nan_to_num"]
        vals = [f"{k}={getattr(self, k)}" for k in attrs]
        return f"{self.__class__.__name__}({', '.join(vals)})"


class MonoExponentialFit:
    """Monoexponential relaxometry fit :math:`y = a e^{-x/tc}`.

    Args:
        x: echo times, one per volume in ``y``.
        y: echo volumes (better given to :meth:`fit`).
        mask: voxels to keep (better given to :meth:`fit`).
        bounds: (lb, ub) of the time constant; outside → NaN → 0.
        tc0: initial time constant, or ``"polyfit"`` for a log-linear seed.
        r2_threshold: minimum r², a number, None, or ``"preferences"``.
        decimal_precision: decimals of the returned map (None: no rounding).
        num_workers, chunksize, verbose: accepted for API compatibility
            with ``dosma_tpu``, where only the host fit path reads them. That
            path is not ported, so a value other than the default warns that
            it has no effect.
    """

    def __init__(
        self,
        x: Sequence[float] = None,
        y: Sequence[MedicalVolume] = None,
        mask: MedicalVolume = None,
        bounds: Tuple[float, float] = (0, 100.0),
        tc0: Union[float, str] = 30.0,
        r2_threshold: Union[float, str] = "preferences",
        decimal_precision: int = 1,
        num_workers: int = 0,
        chunksize: int = 1000,
        verbose: bool = False,
    ):
        self.x = x
        if y is not None:
            warnings.warn(
                f"Setting `y` in the constructor can result in significant memory overhead. "
                f"Specify `y` in `{type(self).__name__}.fit(y=...)` instead."
            )
            self._check_y(x, y)
        self.y = y

        if mask is not None:
            warnings.warn(
                f"Setting `mask` in the constructor can result in significant memory overhead. "
                f"Specify `mask` in `{type(self).__name__}.fit(mask=...)` instead."
            )
        self.mask = mask

        if not (isinstance(tc0, Number) or (isinstance(tc0, str) and tc0 == "polyfit")):
            raise ValueError("`tc0` must either be a float or the string 'polyfit'.")

        if len(bounds) != 2:
            raise ValueError("`bounds` should provide lower/upper bound in format (lb, ub)")

        self.bounds = bounds
        self.tc0 = tc0
        _validate_r2_threshold(r2_threshold)
        self.r2_threshold = r2_threshold
        self.decimal_precision = decimal_precision
        ignored = {
            k: v
            for k, v, default in (
                ("num_workers", num_workers, 0),
                ("chunksize", chunksize, 1000),
                ("verbose", verbose, False),
            )
            if v != default
        }
        if ignored:
            warnings.warn(f"{type(self).__name__}: {ignored} have no effect in this package")
        self.num_workers = num_workers
        self.chunksize = chunksize
        self.verbose = verbose

    def fit(self, x=None, y: Sequence[MedicalVolume] = None, mask=None):
        """Fit the echoes; returns ``(tc_map, r_squared)`` volumes.

        Host (numpy) volumes are fit on the default device and give
        numpy-backed maps; tensor volumes are fit on their device and give
        tensor-backed maps there.
        """
        from dosma_tpu_torch.ops.monoexp_pipeline import monoexp_fit_full

        x = self.x if x is None else x
        y = self.y if y is None else y
        mask = self.mask if mask is None else mask

        with annotate("dosma.fit"):
            with annotate("dosma.fit.prepare"):
                self._check_y(x, y)
                orientation = y[0].orientation
                y = [sv.reformat(orientation) for sv in y]
                if len({sv.device for sv in y}) != 1:
                    raise ValueError(
                        f"`y` volumes lie on several devices: {[sv.device for sv in y]}")

                if isinstance(mask, (np.ndarray, torch.Tensor)):
                    mask = MedicalVolume(mask, affine=y[0].affine)
                if mask is not None:
                    # A mismatched mask must raise, not silently mask wrong voxels.
                    mask = mask.reformat_as(y[0])
                    if not mask.is_same_dimensions(y[0], defaults.AFFINE_DECIMAL_PRECISION):
                        raise RuntimeError("`mask` and `y` dimension mismatch")
                mask_flat = None if mask is None else mask.volume.reshape(-1)

            shape = y[0].shape
            vols = [sv.volume for sv in y]
            host = all(isinstance(v, np.ndarray) for v in vols)
            if host:
                # Host echoes cross to the compute device once, stacked.
                with annotate("dosma.fit.stack"):
                    yT = as_tensor(torch.stack([_flat_tensor(v) for v in vols], dim=0),
                                   compute_device())
            else:
                # Tensor echoes as flat rows: the fit lays them out for its kernel.
                yT = [v.reshape(-1) for v in vols]
            tc_flat, r2_flat = monoexp_fit_full(
                np.asarray(x, np.float32), yT,
                bounds=self.bounds, tc0=self.tc0,
                r2_threshold=_validate_r2_threshold(self.r2_threshold),
                decimal_precision=self.decimal_precision,
                mask_flat=mask_flat,
            )

            with annotate("dosma.fit.maps"):
                tc_arr, r2_arr = tc_flat.reshape(shape), r2_flat.reshape(shape)
                if host:
                    tc_arr, r2_arr = tc_arr.cpu().numpy(), r2_arr.cpu().numpy()

                headers = y[0].headers()
                headers = deepcopy(headers) if headers is not None else None
                tc_map = y[0]._partial_clone(volume=tc_arr, headers=headers)
                r_squared = y[0]._partial_clone(volume=r2_arr, headers=True)
        return tc_map, r_squared

    def _check_y(self, x, y):
        if (not isinstance(y, Sequence)) or (not all(isinstance(sv, MedicalVolume) for sv in y)):
            raise TypeError("`y` must be list of MedicalVolumes.")
        if len(x) != len(y):
            raise ValueError(f"`len(x)`={len(x)}, but `len(y)`={len(y)}")


def _build_p0_matrix(p0, param_args, N: int, device) -> torch.Tensor:
    """The (N, P) float32 initial-guess matrix on ``device`` from flexible
    ``p0``: None (ones), a number, a dict by parameter name, an (N, P) array,
    or a sequence whose entries are numbers, None, or per-voxel (N,) arrays
    or tensors."""
    P = len(param_args)
    out = torch.ones((N, P), dtype=torch.float32, device=device)

    def column(i, val):
        if isinstance(val, Number):
            out[:, i] = val
        else:
            out[:, i] = torch.as_tensor(val, dtype=torch.float32, device=device).reshape(-1)

    if p0 is None:
        return out
    if isinstance(p0, Number):
        out[:] = p0
        return out
    if isinstance(p0, Mapping):
        for i, name in enumerate(param_args):
            if p0.get(name) is not None:
                column(i, p0[name])
        return out
    if isinstance(p0, (np.ndarray, torch.Tensor)) and p0.ndim == 2:
        if tuple(p0.shape) != (N, P):
            raise ValueError(f"p0 array must have shape ({N}, {P}), got {tuple(p0.shape)}")
        return torch.as_tensor(p0, dtype=torch.float32, device=device)
    if isinstance(p0, Sequence):
        for i, val in enumerate(p0):
            if val is not None:
                column(i, val)
        return out
    raise ValueError(f"p0={p0} not supported")


def _as_result(arrays, like_numpy: bool, device):
    """Results as numpy arrays (numpy input) or tensors on ``device``."""
    if like_numpy:
        return tuple(a.cpu().numpy() if isinstance(a, torch.Tensor) else a for a in arrays)
    return tuple(torch.as_tensor(a, device=device) for a in arrays)


def curve_fit(
    func,
    x,
    y,
    y_bounds=None,
    p0=None,
    maxfev=100,
    ftol=1e-5,
    eps=1e-8,
    show_pbar=False,
    num_workers=0,
    chunksize: int = None,
    kernel: str = "auto",
    **kwargs,
):
    """Nonlinear least-squares fit of ``func`` to N data sequences at once.

    ``y`` is (T, N), a numpy array or a tensor on any device; returns
    ``(popts (N, P), r_squared (N,))`` as numpy arrays for numpy input (fit
    on the default device) and as tensors on ``y``'s device for tensor
    input. Data on a card is fit on the card, by a hand-written kernel or, for a model the generic kernel
    refuses, by :func:`dosma_tpu_torch.ops.nlls.lm_fit`. Functions that
    ``torch.func.jvp`` cannot differentiate, and scipy-only keyword
    arguments (``sigma``, parameter ``bounds``, ...), go to a per-sequence
    ``scipy.optimize.curve_fit`` loop on host copies.

    ``kernel`` keeps the names of ``dosma_tpu.curve_fit``; here they select
    CUDA kernels (or their plain versions for data on the CPU):

    - ``"auto"``: :func:`~dosma_tpu_torch.ops.monoexp.monoexp_lm` when
      ``func`` IS the library :func:`monoexponential`,
      :func:`~dosma_tpu_torch.ops.biexp.biexp_lm` when it IS the library
      :func:`biexponential`, otherwise
      :func:`~dosma_tpu_torch.ops.generic_lm.generic_lm` for a model its code
      generator accepts (whitelisted torch operations, P ≤ 4), and ``lm_fit``
      (with a warning naming the refused node) for any other;
    - ``"pallas_monoexp"`` / ``"pallas_biexp"``: ``monoexp_lm`` /
      ``biexp_lm`` for a user function known to share the library
      parametrization;
    - ``"generic"``: ``generic_lm``, or ``lm_fit`` for a refused model.
    """
    if kernel not in _KERNELS:
        raise ValueError(f"Unknown kernel {kernel!r}")
    from dosma_tpu_torch.ops.generic_lm import ModelRefused, compile_model, generic_lm
    from dosma_tpu_torch.ops.nlls import lm_fit

    x = _host_x(x)
    like_numpy = not isinstance(y, torch.Tensor)
    y = torch.as_tensor(np.asarray(y) if like_numpy else y, device=compute_device(y))
    if y.ndim == 1:
        y = y.reshape(tuple(y.shape) + (1,))
    N = y.shape[-1]
    device = y.device

    nparams, param_args = _func_nparams(func)
    p0_mat = _build_p0_matrix(p0, param_args, N, device)

    def scipy_loop():
        out = _scipy_curve_fit_loop(
            func, x, y.cpu().numpy(), y_bounds, p0_mat.cpu().numpy(), maxfev, ftol, eps, nparams,
            num_workers=num_workers, chunksize=chunksize, show_pbar=show_pbar, **kwargs,
        )
        return _as_result(out, like_numpy, device)

    if kwargs:
        # scipy-only options have no batched analog; fitting without them
        # would change results, so the exact per-sequence loop takes them.
        warnings.warn(
            f"curve_fit options {sorted(kwargs)} are only supported by the "
            f"scipy engine; falling back to per-sequence scipy fitting."
        )
        return scipy_loop()

    model = _as_torch_model(func, nparams)
    if model is None:
        warnings.warn(
            f"Function {getattr(func, '__name__', func)} is not differentiable by "
            f"torch.func.jvp; falling back to per-sequence scipy fitting."
        )
        return scipy_loop()

    if not y.is_floating_point() or y.dtype == torch.float64:
        y = y.to(torch.float32)
    if y_bounds is not None and bool(((y < y_bounds[0]) | (y > y_bounds[1])).any()):
        warnings.warn("Out of bounds values found. Failure in fit will result in np.nan")

    fit_kw = dict(max_iter=int(maxfev), ftol=ftol, y_bounds=y_bounds)
    use_mono = kernel == "pallas_monoexp" or (
        kernel == "auto" and func is monoexponential and nparams == 2
    )
    use_biexp = kernel == "pallas_biexp" or (
        kernel == "auto" and func is biexponential and nparams == 4
    )
    if use_mono:
        from dosma_tpu_torch.ops.monoexp import monoexp_lm

        popt, r2, _ = monoexp_lm(x, y, p0_mat, y_layout="tn", **fit_kw)
    elif use_biexp:
        from dosma_tpu_torch.ops.biexp import biexp_lm

        popt, r2, _ = biexp_lm(x, y, p0_mat, y_layout="tn", **fit_kw)
    else:
        try:
            program = compile_model(func, nparams)
        except ModelRefused as e:
            program = None
            warnings.warn(
                f"The generic CUDA kernel does not take {getattr(func, '__name__', func)!r} "
                f"({e}); fitting it with lm_fit on {device}."
            )
        if program is not None:
            popt, r2, _ = generic_lm(program, x, y, p0_mat, y_layout="tn", **fit_kw)
        else:
            popt, r2, _ = lm_fit(model, x, y.T, p0_mat, **fit_kw)
    return _as_result((popt, r2), like_numpy, device)


class _ScipyVoxelFitter:
    """One-sequence scipy fit, as a picklable callable so a process pool can
    fan it out. Returns ``(popt, r2)``, with NaN ``popt`` and r² = 0 for an
    out-of-bounds or all-zero sequence or a fit that fails."""

    def __init__(self, func, x, y_bounds, p0_mat, maxfev, ftol, eps, nparams, kwargs):
        self.func = func
        self.x = x
        self.y_bounds = y_bounds
        self.p0_mat = p0_mat
        self.maxfev = maxfev
        self.ftol = ftol
        self.eps = eps
        self.nparams = nparams
        self.kwargs = kwargs

    def __call__(self, item):
        import scipy.optimize as sop

        i, yi = item
        yb = self.y_bounds
        oob = yb is not None and ((yi < yb[0]).any() or (yi > yb[1]).any())
        if oob or (yi == 0).all():
            return np.full(self.nparams, np.nan), 0.0
        try:
            popt, _ = sop.curve_fit(
                self.func, self.x, yi, p0=self.p0_mat[i],
                maxfev=self.maxfev, ftol=self.ftol, **self.kwargs,
            )
            residuals = yi - self.func(self.x, *popt)
            ss_res = np.sum(residuals**2)
            ss_tot = np.sum((yi - np.mean(yi)) ** 2)
            return popt, 1 - (ss_res / (ss_tot + self.eps))
        except RuntimeError:
            return np.full(self.nparams, np.nan), 0.0


def _scipy_curve_fit_loop(func, x, y, y_bounds, p0_mat, maxfev, ftol, eps, nparams,
                          num_workers=0, chunksize=None, show_pbar=False, **kwargs):
    """Per-sequence ``scipy.optimize.curve_fit`` over the columns of host
    (T, N) ``y``. With ``num_workers`` > 0 the sequences fan out over a pool
    of spawned processes; a model the pickler rejects (a lambda, a closure)
    runs on a thread pool instead, with a warning."""
    N = y.shape[-1]
    if N == 0:
        return np.empty((0, nparams)), np.empty(0)
    fitter = _ScipyVoxelFitter(func, x, y_bounds, p0_mat, maxfev, ftol, eps, nparams, kwargs)
    items = [(i, y[:, i]) for i in range(N)]

    num_workers = min(int(num_workers or 0), N)
    if num_workers:
        import multiprocessing as mp
        import pickle

        try:
            pickle.dumps(fitter)
            pool_cls = mp.get_context("spawn").Pool
        except (pickle.PicklingError, AttributeError, TypeError):
            from multiprocessing.pool import ThreadPool as pool_cls

            warnings.warn(
                f"Model function {getattr(func, '__name__', func)!r} is not "
                f"picklable; using threads instead of processes for "
                f"num_workers={num_workers}."
            )
        with pool_cls(num_workers) as pool:
            data = pool.map(fitter, items, chunksize=chunksize)
    else:
        data = [fitter(item) for item in items]

    popts = np.stack([d[0] for d in data], axis=0)
    r2s = np.asarray([d[1] for d in data], dtype=np.float64)
    return popts, r2s


def polyfit(
    x,
    y,
    deg: int,
    rcond=None,
    full=False,
    w=None,
    cov=False,
    eps=1e-8,
    y_bounds=None,
    show_pbar=False,
    num_workers=None,
    chunksize: int = None,
):
    """Polynomial least squares over N sequences.

    ``y`` is (T, N), a numpy array or a tensor on any device. Returns
    ``(popts (N, deg+1) highest power first, r_squared (N,))``: numpy arrays
    for numpy input (fit on the default device), tensors on ``y``'s device
    for tensor input. The standard
    path is one batched solve on ``y``'s device
    (:func:`dosma_tpu_torch.ops.nlls.batched_polyfit`); ``full``/``cov``/``w``
    go to ``np.polyfit`` on a host copy, and their extra outputs are numpy.
    All-zero and out-of-``y_bounds`` sequences give NaN parameters, r² = 0.
    """
    from dosma_tpu_torch.ops.nlls import batched_polyfit

    x = _host_x(x)
    like_numpy = not isinstance(y, torch.Tensor)
    y = torch.as_tensor(np.asarray(y) if like_numpy else y, device=compute_device(y))
    if y.ndim == 1:
        y = y.reshape(tuple(y.shape) + (1,))
    device = y.device

    oob = None
    if y_bounds is not None:
        oob = ((y < y_bounds[0]) | (y > y_bounds[1])).any(0)
        if bool(oob.any()):
            warnings.warn("Out of bounds values found. Failure in fit will result in np.nan")
    invalid = (y == 0).all(0)
    if oob is not None:
        invalid = invalid | oob

    if full or cov or w is not None:
        yh = y.cpu().numpy()
        out = np.polyfit(x, yh, deg, rcond=rcond, full=full, w=w, cov=cov)
        popts = out[0] if (full or cov) else out
        V_mat = np.stack([x**i for i in range(deg, -1, -1)], axis=-1)
        ss_res = np.sum((V_mat @ popts - yh) ** 2, axis=0)
        ss_tot = np.sum((yh - yh.mean(axis=0, keepdims=True)) ** 2, axis=0)
        r_squared = 1 - ss_res / (ss_tot + eps)
        popts = popts.T.copy()
        invalid_h = invalid.cpu().numpy()
        popts[invalid_h] = np.nan
        r_squared = np.where(invalid_h, 0.0, r_squared)
        popts, r_squared = _as_result((popts, r_squared), like_numpy, device)
        if full:
            return (popts, r_squared) + tuple(out[1:])
        if cov:
            return popts, r_squared, out[1]
        return popts, r_squared

    popts, r_squared = batched_polyfit(x, y, deg)
    popts = popts.T.clone()
    popts[invalid] = torch.nan
    r_squared = torch.where(invalid, 0.0, r_squared)
    return _as_result((popts, r_squared), like_numpy, device)
