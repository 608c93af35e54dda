"""Plain resampling and motion recovery: the reference of the registration cell.

A registration answers with a world transform ``M`` (fixed world -> moving
world) and the moving volume resampled onto the fixed grid under it. The
affine parameter file resamples with a cubic B-spline (elastix
``FinalBSplineInterpolationOrder`` 3): coefficients under mirror boundary
conditions, the point clipped into the moving volume and 0 where it falls
more than 1e-3 voxel outside.

Here the coefficients come from a deconvolution in the Fourier domain of
the mirror-extended volume (period ``2n - 2`` along each axis, so the mirror
conditions hold exactly), not from the recursive filter the program runs;
and the 64 taps of each point are summed in one pass. Motion recovery is
the largest displacement, over the corners of the fixed grid, between the
returned index map and the known roll of the recipe.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["index_map", "cubic_coefficients", "cubic_warp", "corner_error_vox"]

_POINTS = 1 << 18  # output points a pass
# Voxels of a coordinate this close to the domain's edge are left out of the
# comparison: float32 coordinates of up to ~200 carry errors of ~1e-5.
EDGE_TOL = 1e-4


def index_map(matrix, fixed_affine, moving_affine) -> np.ndarray:
    """(3, 4) float64 map from a fixed-grid index to a moving-grid index."""
    b = np.linalg.inv(np.asarray(moving_affine, np.float64)) @ np.asarray(matrix, np.float64) \
        @ np.asarray(fixed_affine, np.float64)
    return b[:3]


def cubic_coefficients(vol: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline coefficients of ``vol`` (float64) under mirror conditions."""
    c = vol.to(torch.float64)
    for axis in range(c.ndim):
        n = c.shape[axis]
        if n < 2:
            continue
        ext = torch.cat([c, c.flip(axis).narrow(axis, 1, n - 2)], dim=axis)
        period = 2 * n - 2
        k = torch.arange(period, dtype=torch.float64, device=c.device)
        h = 4.0 / 6.0 + (2.0 / 6.0) * torch.cos(2 * np.pi * k / period)
        shape = [1] * c.ndim
        shape[axis] = period
        spec = torch.fft.fft(ext, dim=axis) / h.reshape(shape)
        c = torch.fft.ifft(spec, dim=axis).real.narrow(axis, 0, n).contiguous()
    return c


def _b3(t):
    at = t.abs()
    near = (4.0 - 6.0 * at ** 2 + 3.0 * at ** 3) / 6.0
    far = (2.0 - at) ** 3 / 6.0
    return torch.where(at < 1.0, near, torch.where(at < 2.0, far, torch.zeros_like(at)))


def _mirror(idx: torch.Tensor, n: int) -> torch.Tensor:
    period = max(2 * n - 2, 1)
    m = torch.remainder(idx, period)
    return torch.where(m > n - 1, period - m, m)


def cubic_warp(moving: torch.Tensor, b_map, out_shape, dtype=torch.float64):
    """``moving`` resampled at ``b_map @ (i, j, k, 1)`` for every index of
    ``out_shape``, the taps and sums in ``dtype``; and the points whose
    coordinate lies within ``EDGE_TOL`` of the edge of the domain, where a
    float32 coordinate may fall on the other side of it."""
    dev = moving.device
    dims = moving.shape
    coef = cubic_coefficients(moving).to(dtype).reshape(-1)
    b = torch.as_tensor(np.asarray(b_map, np.float64), device=dev)
    npts = int(np.prod(out_shape))
    out = torch.empty(npts, dtype=torch.float64, device=dev)
    edge = torch.empty(npts, dtype=torch.bool, device=dev)
    hi = torch.tensor([d - 1 for d in dims], dtype=torch.float64, device=dev)[:, None]
    offsets = torch.arange(-1, 3, device=dev)
    for start in range(0, npts, _POINTS):
        p = torch.arange(start, min(npts, start + _POINTS), device=dev)
        idx = torch.stack([p // (out_shape[1] * out_shape[2]), (p // out_shape[2]) % out_shape[1],
                           p % out_shape[2]]).to(torch.float64)
        c = b[:, :3] @ idx + b[:, 3:]
        inside = ((c >= -1e-3) & (c <= hi + 1e-3)).all(0)
        edge[start:start + p.numel()] = (((c + 1e-3).abs() < EDGE_TOL)
                                         | ((c - hi - 1e-3).abs() < EDGE_TOL)).any(0)
        c = torch.minimum(torch.clamp(c, min=0.0), hi)
        fl = torch.floor(c)
        taps = fl.to(torch.int64)[:, None, :] + offsets[None, :, None]  # (3, 4, P)
        w = _b3((c[:, None, :] - taps.to(torch.float64))).to(dtype)
        taps = torch.stack([_mirror(taps[a], dims[a]) for a in range(3)])
        flat = ((taps[0][:, None, None] * dims[1] + taps[1][None, :, None]) * dims[2]
                + taps[2][None, None, :])  # (4, 4, 4, P)
        weight = w[0][:, None, None] * w[1][None, :, None] * w[2][None, None, :]
        vals = (coef[flat] * weight).sum((0, 1, 2))
        out[start:start + p.numel()] = torch.where(inside, vals.to(torch.float64),
                                                   torch.zeros((), dtype=torch.float64,
                                                               device=dev))
    return out.reshape(tuple(out_shape)), edge.reshape(tuple(out_shape))


def corner_error_vox(b_map, shape, shift) -> float:
    """Largest distance, over the corners of a grid of ``shape``, between
    ``b_map`` and the index map of a pure roll by ``shift`` (moving index =
    fixed index + shift)."""
    b = np.asarray(b_map, np.float64)
    corners = np.array([[i, j, k, 1.0] for i in (0, shape[0] - 1)
                        for j in (0, shape[1] - 1) for k in (0, shape[2] - 1)]).T
    want = corners[:3] + np.asarray(shift, np.float64)[:, None]
    return float(np.linalg.norm(b @ corners - want, axis=0).max())
