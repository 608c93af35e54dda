"""Plain monoexponential relaxometry: the reference of the fit cells.

Upstream DOSMA's ``MonoExponentialFit`` fits ``y = a * exp(-x / tc)`` to
every voxel by least squares and post-processes the map: ``tc = 1 / |b|``,
NaN outside the bounds, below the r-squared threshold or outside the mask,
NaN filled with 0, rounded to the stated decimals; r-squared is
``1 - SSres / (SStot + 1e-8)``, 0 outside the mask and where the data are
all zero.

This file solves the same least-squares problem on its own terms, not the
program's: variable projection leaves one unknown, the rate ``b``; a grid
over the time constant brackets the smallest reduced cost, and bisection on
the sign of its derivative closes the bracket. No Levenberg-Marquardt, no
seed from a log-linear fit, no latch. It imports torch and numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fit_rates", "relaxation_maps"]

# Time constants the grid brackets (ms): wider than every configuration's bounds.
_TC_GRID = np.geomspace(0.5, 5000.0, 192)
_BISECTIONS = 64
_BLOCK = 1 << 21  # voxels a pass: bounds the (T, block) temporaries


def _sums(x, y, b):
    """(S, U, S', U') of the reduced cost at rates ``b`` (one a voxel, or a
    grid (G, 1) against every voxel)."""
    e = torch.exp(b[..., None, :] * x[:, None])  # (..., T, N)
    xe = x[:, None] * e
    return (e * e).sum(-2), (y * e).sum(-2), 2.0 * (xe * e).sum(-2), (xe * y).sum(-2)


def _fit_block(x, y):
    """Least-squares ``a``, ``b`` and r-squared of ``y`` (T, n) in ``y``'s dtype."""
    dt = y.dtype
    grid = torch.as_tensor(-1.0 / _TC_GRID, dtype=dt, device=y.device)
    # Reduced cost on the grid, less the constant sum of y^2: -U^2 / S.
    best = torch.zeros(y.shape[1], dtype=torch.int64, device=y.device)
    best_cost = torch.full((y.shape[1],), float("inf"), dtype=dt, device=y.device)
    for i, g in enumerate(grid):
        s, u, _, _ = _sums(x, y, g.expand(y.shape[1]))
        cost = torch.nan_to_num(-(u * u) / s, nan=float("inf"))
        better = cost < best_cost
        best = torch.where(better, i, best)
        best_cost = torch.where(better, cost, best_cost)
    lo = grid[torch.clamp(best - 1, min=0)]
    hi = grid[torch.clamp(best + 1, max=grid.numel() - 1)]
    for _ in range(_BISECTIONS):
        mid = 0.5 * (lo + hi)
        s, u, ds, du = _sums(x, y, mid)
        # d/db of -U^2/S has the sign of U^2 S' - 2 U U' S.
        rising = (u * u * ds - 2.0 * u * du * s) > 0
        hi = torch.where(rising, mid, hi)
        lo = torch.where(rising, lo, mid)
    b = 0.5 * (lo + hi)
    s, u, _, _ = _sums(x, y, b)
    a = u / s
    r = a * torch.exp(b[None, :] * x[:, None]) - y
    ss_res = (r * r).sum(0)
    d = y - y.mean(0)
    r2 = 1.0 - ss_res / ((d * d).sum(0) + 1e-8)
    return a, b, r2.to(dt)


def fit_rates(x, yT, dtype=torch.float64):
    """``(a, b, r2)`` of every voxel of ``yT`` (T, N), computed in ``dtype``."""
    x = torch.as_tensor(np.asarray(x, np.float64), device=yT.device).to(dtype)
    outs = [_fit_block(x, yT[:, i:i + _BLOCK].to(dtype))
            for i in range(0, yT.shape[1], _BLOCK)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def relaxation_maps(x, yT, mask_flat, fit_cfg, dtype=torch.float64):
    """The ``(tc, r2)`` maps (N,) that ``MonoExponentialFit`` semantics give
    for echoes ``yT`` (T, N) and ``mask_flat`` (N,; None keeps every voxel),
    fit in ``dtype`` and returned in float64."""
    a, b, r2 = fit_rates(x, yT, dtype)
    lb, ub = fit_cfg["bounds"]
    tc = 1.0 / torch.abs(b)
    invalid = (yT == 0).all(0) | ~torch.isfinite(a) | ~torch.isfinite(b)
    r2 = torch.where(invalid, torch.zeros_like(r2), r2)
    drop = invalid | (tc < lb) | (tc > ub) | (r2 < fit_cfg["r2_threshold"])
    if mask_flat is not None:
        inside = mask_flat.reshape(-1) > 0
        drop = drop | ~inside
        r2 = torch.where(inside, r2, torch.zeros_like(r2))
    tc = torch.where(drop, torch.zeros_like(tc), tc)
    tc = tc.to(torch.float64)
    if fit_cfg.get("decimal_precision") is not None:
        tc = torch.round(tc, decimals=int(fit_cfg["decimal_precision"]))
    return tc, r2.to(torch.float64)
