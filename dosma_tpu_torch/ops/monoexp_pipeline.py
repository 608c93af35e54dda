"""Monoexponential relaxometry on the data's device.

Counterpart of ``dosma_tpu/ops/monoexp_pipeline.py``: ``MonoExponentialFit``
semantics as seed + fit (:func:`dosma_tpu_torch.ops.monoexp.monoexp_lm`)
followed by plain elementwise torch post-processing — rate → time constant,
bounds and r² threshold → NaN, mask, ``nan_to_num`` and rounding — all on the
device the echoes are on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dosma_tpu_torch.ops.monoexp import _detect_uniform_x, monoexp_lm

__all__ = ["monoexp_fit_full"]


def monoexp_fit_full(
    x,
    yT,
    bounds: Tuple[float, float],
    tc0,
    r2_threshold: Optional[float],
    decimal_precision: Optional[int],
    mask_flat=None,
    nan_fill: float = 0.0,
    max_iter: int = 100,
):
    """Run the complete monoexp relaxometry fit.

    Args:
        x: (T,) echo/spin-lock times (host).
        yT: (T, N) echo data: a tensor (on the CPU or a card) or a numpy array.
        bounds: (lb, ub) time-constant bounds → NaN outside.
        tc0: initial tc guess or ``"polyfit"``.
        r2_threshold: minimum r² (below → NaN); None keeps every voxel.
        decimal_precision: rounding decimals (None = no rounding; halves
            round to even, as ``jnp.around`` does).
        mask_flat: optional (N,) mask; voxels outside get ``nan_fill``.
        nan_fill: value replacing NaNs.

    Returns:
        (tc_map (N,), r2 (N,)) float32 tensors on ``yT``'s device.
    """
    x = np.asarray(x, np.float32)
    uniform_x = _detect_uniform_x(x)
    if not isinstance(yT, torch.Tensor):
        yT = torch.from_numpy(np.ascontiguousarray(yT))
    if yT.dtype != torch.float32:
        yT = yT.to(torch.float32)
    device = yT.device

    if isinstance(tc0, str) and tc0 == "polyfit":
        p0 = None  # log-linear seed inside the fit
    else:
        p0 = torch.tensor([1.0, -1.0 / float(tc0)], dtype=torch.float32, device=device)

    popt, r2, _ = monoexp_lm(
        x, yT, p0, max_iter=max_iter, y_layout="tn", uniform_x=uniform_x
    )

    lb, ub = bounds
    tc = 1.0 / torch.abs(popt[:, 1])
    tc = torch.where((tc < lb) | (tc > ub), torch.nan, tc)
    if r2_threshold is not None:
        tc = torch.where(r2 < r2_threshold, torch.nan, tc)
    if mask_flat is not None:
        if not isinstance(mask_flat, torch.Tensor):
            mask_flat = torch.from_numpy(np.ascontiguousarray(mask_flat))
        inside = mask_flat.to(device=device, dtype=torch.float32).reshape(-1) > 0
        tc = torch.where(inside, tc, torch.nan)
        r2 = torch.where(inside, r2, nan_fill)
    tc = torch.nan_to_num(tc, nan=nan_fill)
    if decimal_precision is not None:
        tc = torch.round(tc, decimals=int(decimal_precision))
    return tc, r2
