"""Cubic B-spline free-form deformation (FFD).

Counterpart of ``dosma_tpu/ops/bspline.py``, in plain torch (the reference
runs it in XLA, not Pallas). The deformable transform of the registration:
a coarse control grid of 3-D displacements (mm), interpolated with cubic
B-spline basis functions (the Rueckert FFD). Evaluation at K points is
three dense per-axis basis contractions over the whole control grid, so
the gradient with respect to the grid (``torch.autograd``) is the
transposed contraction, not a scatter. The contractions run in full
float32 (:func:`full_f32`), as the reference asks XLA for
``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = [
    "bspline_displacement",
    "make_control_grid",
    "bending_energy",
    "subdivide_control_grid",
]


@contextlib.contextmanager
def full_f32():
    """float32 matrix products without TF32 inside the block, whatever the
    caller's global setting (TF32's 10-bit mantissa costs ~3 decimal digits
    on the control displacements and on their gradient)."""
    precision = torch.get_float32_matmul_precision()
    if precision == "highest":
        yield
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(precision)


def _cubic_bspline_weights(t: torch.Tensor):
    """Uniform cubic B-spline basis B0..B3 at the fractional offset t in [0, 1)."""
    t2 = t * t
    t3 = t2 * t
    b0 = (1 - t) ** 3 / 6.0
    b1 = (3 * t3 - 6 * t2 + 4) / 6.0
    b2 = (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0
    b3 = t3 / 6.0
    return b0, b1, b2, b3


def make_control_grid(fixed_shape, fixed_affine, grid_spacing_mm: float, grid_spacing_vox=None):
    """Control-grid geometry covering the fixed image domain (+1 margin).

    Returns ``(grid_shape, spacing_vox)``: the control-point counts per axis
    and the control spacing in fixed-image INDEX units (the grid is
    axis-aligned in the fixed index space). ``grid_spacing_vox`` (scalar or
    per axis, elastix's FinalGridSpacingInVoxels) overrides the physical
    spacing when given.
    """
    fixed_affine = np.asarray(fixed_affine)
    if grid_spacing_vox is not None:
        spacing_vox = np.maximum(
            np.broadcast_to(np.asarray(grid_spacing_vox, float), (3,)).copy(), 2.0
        )
    else:
        voxel_spacing = np.sqrt((fixed_affine[:3, :3] ** 2).sum(0))
        spacing_vox = np.maximum(grid_spacing_mm / np.maximum(voxel_spacing, 1e-6), 2.0)
    shape = np.floor(np.asarray(fixed_shape[:3]) / spacing_vox).astype(int) + 4
    shape = np.maximum(shape, 4)
    return tuple(int(s) for s in shape), spacing_vox


_DENSE_MAX_POINTS = 65536  # points a dense evaluation; larger K runs in slabs


def _basis_profile(u: torch.Tensor, g: int) -> torch.Tensor:
    """Dense basis profile (K, g) at continuous control coordinates ``u``
    (K,): row k holds the 4 non-zero basis weights on their control
    indices, clipped to the border (edge control points replicate). Built
    from comparisons, without a scatter, so its use stays a contraction."""
    fl = torch.floor(u)
    i0 = fl.to(torch.int32) - 1
    w = _cubic_bspline_weights(u - fl)
    iota = torch.arange(g, dtype=torch.int32, device=u.device)
    W = torch.zeros((u.shape[0], g), dtype=u.dtype, device=u.device)
    for a in range(4):
        ia = torch.clamp(i0 + a, 0, g - 1)
        W = W + (iota[None, :] == ia[:, None]) * w[a][:, None]
    return W


def bspline_displacement(ctrl: torch.Tensor, idx_pts: torch.Tensor,
                         spacing_vox) -> torch.Tensor:
    """Displacement (3, K) at fixed-image index coordinates ``idx_pts`` (3, K).

    ``ctrl``: (3, gx, gy, gz) control displacements (world mm). Control
    point (1, 1, 1) sits at index (0, 0, 0) (one cell of margin for the
    cubic support). K above 65,536 is evaluated in slabs of that many
    points, which bounds the (K, gx, gy) intermediate.
    """
    spacing_vox = torch.as_tensor(spacing_vox, dtype=idx_pts.dtype, device=idx_pts.device)
    K = idx_pts.shape[1]
    if K <= _DENSE_MAX_POINTS:
        return _bspline_disp_dense(ctrl, idx_pts, spacing_vox)
    return torch.cat([_bspline_disp_dense(ctrl, idx_pts[:, s:s + _DENSE_MAX_POINTS], spacing_vox)
                      for s in range(0, K, _DENSE_MAX_POINTS)], dim=1)


def _bspline_disp_dense(g: torch.Tensor, idx_pts: torch.Tensor, spacing_vox: torch.Tensor):
    u = idx_pts / spacing_vox[:, None] + 1.0  # continuous control coordinates
    _, gx, gy, gz = g.shape
    Wx = _basis_profile(u[0], gx)  # (K, gx)
    Wy = _basis_profile(u[1], gy)
    Wz = _basis_profile(u[2], gz)
    with full_f32():
        A = torch.einsum("kz,cxyz->ckxy", Wz, g)
        B = torch.einsum("ky,ckxy->ckx", Wy, A)
        return torch.einsum("kx,ckx->ck", Wx, B)


def _subdivide_axis(c: torch.Tensor, n_new: int) -> torch.Tensor:
    """Halve the control spacing along the LAST axis by exact cubic
    B-spline knot insertion (Lane-Riesenfeld midpoint rules).

    Old control ``i`` lives at image ``(i-1)*s`` and new control ``j`` at
    ``(j-1)*s/2``: new ODD indices are old knots (vertex rule
    ``(c[i-1] + 6 c[i] + c[i+1]) / 8``), new EVEN indices old midpoints
    (edge rule ``(c[i] + c[i+1]) / 2``). Edge replication matches the
    clipped border of :func:`_basis_profile`.
    """
    cp = torch.cat([c[..., :1], c, c[..., -1:]], dim=-1)
    v = (cp[..., :-2] + 6.0 * cp[..., 1:-1] + cp[..., 2:]) / 8.0  # vertex_i
    e = (cp[..., 1:-1] + cp[..., 2:]) / 2.0  # edge_i = mid(c_i, c_{i+1})
    n = c.shape[-1]
    # [e_0, v_1, e_1, v_2, ..., v_{n-1}, e_{n-1}] (length 2n-1): index j even
    # is e_{j/2}, odd is v_{(j+1)/2}.
    pairs = torch.stack([e[..., : n - 1], v[..., 1:]], dim=-1)
    out = torch.cat([pairs.reshape(*c.shape[:-1], 2 * (n - 1)), e[..., -1:]], dim=-1)
    if n_new > out.shape[-1]:  # only when the coarse grid was all margin
        extra = n_new - out.shape[-1]
        out = torch.cat([out] + [out[..., -1:]] * extra, dim=-1)
    return out[..., :n_new]


def subdivide_control_grid(ctrl: torch.Tensor, new_shape) -> torch.Tensor:
    """Refine ``ctrl`` (3, gx, gy, gz) to half the control spacing per axis:
    a grid of shape ``(3, *new_shape)`` holding the same displacement field
    (up to border clipping), the coarse-to-fine step of multi-grid FFD
    registration (elastix's GridSpacingSchedule)."""
    out = ctrl
    for ax, n_new in zip((1, 2, 3), new_shape):
        out = torch.movedim(_subdivide_axis(torch.movedim(out, ax, -1), int(n_new)), -1, ax)
    return out


def bending_energy(ctrl: torch.Tensor) -> torch.Tensor:
    """Discrete bending-energy regularizer (second differences of the grid)."""
    e = 0.0
    for axis in (1, 2, 3):
        d2 = torch.diff(ctrl, n=2, dim=axis)
        e = e + torch.mean(d2 * d2)
    return e
