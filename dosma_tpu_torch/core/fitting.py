"""Quantitative fitting: ``MonoExponentialFit``.

Counterpart of the monoexponential part of ``dosma_tpu/core/fitting.py``.
The fit runs where the echo volumes are: volumes on a CUDA card are fit by
the hand-written kernel, volumes on the host by the plain PyTorch version of
the same algorithm (:mod:`dosma_tpu_torch.ops.monoexp`). Data on a card is
never moved to the host to be fit.

``CurveFitter``, ``PolyFitter`` and ``curve_fit`` are not ported yet.
"""

from __future__ import annotations

import warnings
from copy import deepcopy
from numbers import Number
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from dosma_tpu_torch import defaults
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.defaults import preferences

__all__ = ["MonoExponentialFit", "monoexponential"]


def monoexponential(x, a, b):
    """:math:`f(x) = a e^{b x}` (numpy arrays or torch tensors)."""
    if any(isinstance(v, torch.Tensor) for v in (x, a, b)):
        return a * torch.exp(b * x)
    return a * np.exp(b * x)


def _validate_r2_threshold(threshold):
    if isinstance(threshold, str):
        if threshold != "preferences":
            raise ValueError(
                f"Invalid value r2_threshold='{threshold}'. "
                f"Expected `None`, a number between [0, 1], or 'preferences'."
            )
        return preferences.fitting_r2_threshold
    return threshold


def _flat_tensor(vol) -> torch.Tensor:
    """A volume's pixels as a flat float32 tensor on the volume's own device."""
    if not isinstance(vol, torch.Tensor):
        vol = torch.from_numpy(np.ascontiguousarray(vol))
    return vol.to(torch.float32).reshape(-1)


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
        """Fit the echoes; returns ``(tc_map, r_squared)`` volumes on ``y``'s device.

        Host (numpy) volumes give numpy-backed maps; tensor volumes give
        tensor-backed maps on the same device.
        """
        from dosma_tpu_torch.ops.monoexp_pipeline import monoexp_fit_full

        x = self.x if x is None else x
        y = self.y if y is None else y
        mask = self.mask if mask is None else mask

        self._check_y(x, y)
        orientation = y[0].orientation
        y = [sv.reformat(orientation) for sv in y]
        if len({sv.device for sv in y}) != 1:
            raise ValueError(f"`y` volumes lie on several devices: {[sv.device for sv in y]}")

        if isinstance(mask, (np.ndarray, torch.Tensor)):
            mask = MedicalVolume(mask, affine=y[0].affine)
        if mask is not None:
            # A mismatched mask must raise, not silently mask wrong voxels.
            mask = mask.reformat_as(y[0])
            if not mask.is_same_dimensions(y[0], defaults.AFFINE_DECIMAL_PRECISION):
                raise RuntimeError("`mask` and `y` dimension mismatch")

        shape = y[0].shape
        yT = torch.stack([_flat_tensor(sv.volume) for sv in y], dim=0)
        tc_flat, r2_flat = monoexp_fit_full(
            np.asarray(x, np.float32), yT,
            bounds=self.bounds, tc0=self.tc0,
            r2_threshold=_validate_r2_threshold(self.r2_threshold),
            decimal_precision=self.decimal_precision,
            mask_flat=None if mask is None else _flat_tensor(mask.volume),
        )
        tc_arr, r2_arr = tc_flat.reshape(shape), r2_flat.reshape(shape)
        if all(isinstance(sv.volume, np.ndarray) for sv in y):
            tc_arr, r2_arr = tc_arr.numpy(), r2_arr.numpy()

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
