"""Image registration: pyramid stages, metrics, chains and warps.

Counterpart of ``dosma_tpu/ops/registration.py``: translation, rigid and
affine transforms, and the multi-grid B-spline (FFD) stage of
:func:`register_pair_bspline` (:mod:`dosma_tpu_torch.ops.bspline`). Each
stage is an in-process optimization:

- transforms parameterized in world (RAS) space about the fixed image's
  centre (rotations in radians, translations in mm, affine deviations
  from the identity), scaled to natural units (:func:`_param_scale`);
- a Gaussian smoothing pyramid on the full grid (elastix's
  FixedSmoothingImagePyramid): each level smooths both images with a
  per-level sigma;
- metrics: Mattes-style mutual information from differentiable soft joint
  histograms (:func:`_soft_mi`), MSE and NCC;
- a fresh random set of fixed voxels every iteration (elastix's
  RandomCoordinate sampler), drawn per level by :func:`_level_draws`;
- Adam with a cosine-decayed step and a Polyak average over the last
  quarter of each level, written out to optax's conventions, with
  ``torch.autograd`` through the samplers.

Stages of a chain compose in world space, so a chain resamples the moving
image once: the final warp of the moving volume and of every extra volume
on its grid is one launch of the CUDA kernel ``csrc/warp_grid.cu``
(:mod:`dosma_tpu_torch.ops.warp`) for tensors on a card. A chain with a
B-spline stage maps each fixed point through every stage and samples the
moving image at the resulting points (:func:`warp_volume_chain`), in chunks
of the fixed grid, as ``dosma_tpu`` does with its point samplers.

Host (numpy) inputs are computed on the package's default device
(:mod:`dosma_tpu_torch.core.device`) and results come back as host
arrays; tensors are computed on their own device and results stay there.
Matrix products of world coordinates and of the joint histogram run in
full float32 (:func:`_mm` switches TF32 off around them).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dosma_tpu_torch.core.device import compute_device
from dosma_tpu_torch.ops import interp
from dosma_tpu_torch.ops.bspline import (
    bending_energy,
    bspline_displacement,
    full_f32,
    make_control_grid,
    subdivide_control_grid,
)
from dosma_tpu_torch.ops.warp import warp_grid_batched

__all__ = [
    "RegistrationParams",
    "register_pair",
    "register_pair_bspline",
    "register_chain",
    "register_chain_batch",
    "register_pair_batch",
    "warp_volume",
    "warp_volume_batch",
    "warp_volume_chain",
    "compose_transforms",
]

@dataclass(frozen=True)
class RegistrationParams:
    """Configuration of one registration stage (the analog of one elastix
    parameter file)."""

    transform: str = "rigid"  # translation | rigid | affine | bspline
    metric: str = "mi"  # mi | mse | ncc
    resolutions: int = 3
    iterations: int = 300
    num_bins: int = 32
    num_samples: int = 2048
    learning_rate: float = 0.01
    seed: int = 0
    # MI Parzen window on the moving side: "cubic" = Mattes' third-order
    # B-spline window (elastix AdvancedMattesMutualInformation), "linear" =
    # the first-order hat window.
    mi_kernel: str = "cubic"
    # Interpolation order of METRIC sampling (elastix BSplineInterpolationOrder)
    # and of the FINAL resample (FinalBSplineInterpolationOrder): 0 (final
    # only), 1 or 3.
    interp_order: int = 1
    final_interp_order: int = 3
    # B-spline (FFD) stage options. ``grid_spacing_vox`` (voxel units,
    # scalar or per axis, elastix FinalGridSpacingInVoxels) overrides
    # ``grid_spacing_mm`` when set.
    grid_spacing_mm: float = 32.0
    grid_spacing_vox: Optional[Tuple[float, ...]] = None
    bending_weight: float = 1e-2
    # Explicit per-level shrink factors, coarsest → finest (elastix
    # ImagePyramidSchedule); None = 2^(L-1-l). Its length overrides
    # ``resolutions``.
    pyramid_schedule: Optional[Tuple[float, ...]] = None
    # Per-level budgets, coarsest → finest (elastix's per-resolution
    # MaximumNumberOfIterations / NumberOfSpatialSamples). The B-spline
    # multi-grid chain honours them stage by stage; matrix stages run the
    # flat ``iterations`` / ``num_samples`` at every level (a schedule
    # collapses to its max, warned at parse time).
    iteration_schedule: Optional[Tuple[int, ...]] = None
    sample_schedule: Optional[Tuple[int, ...]] = None

    def level_budget(self, n: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
        """Per-level (iterations, samples), coarsest → finest, length ``n``."""

        def _expand(sched, flat):
            if not sched:
                return (int(flat),) * n
            s = tuple(int(v) for v in sched)
            if len(s) >= n:
                # A schedule longer than the level count keeps its coarsest
                # n-1 entries plus its finest, tuned for full resolution.
                return s[: n - 1] + (s[-1],)
            return s + (s[-1],) * (n - len(s))

        return (
            _expand(self.iteration_schedule, self.iterations),
            _expand(self.sample_schedule, self.num_samples),
        )

    @property
    def nparams(self) -> int:
        return {"translation": 3, "rigid": 6, "affine": 12}[self.transform]


# ----------------------------------------------------------------------
# Device placement
# ----------------------------------------------------------------------
def _f32(x, device) -> torch.Tensor:
    """``x`` (array or tensor) as a float32 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(device)


def _host_or_tensor(t: torch.Tensor, host: bool):
    return t.cpu().numpy() if host else t


# ----------------------------------------------------------------------
# Transform parameterization (world space, centred)
# ----------------------------------------------------------------------
def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-float32 matrix product.

    World coordinates are ~100 mm; TF32's 10-bit mantissa would quantize
    them by ~0.1 mm and skew the registration, so TF32 is off around the
    product whatever the caller's global setting.
    """
    with full_f32():
        return torch.matmul(a, b)


def _inv(m: torch.Tensor) -> torch.Tensor:
    """4x4 inverse without the host synchronisation of an error check."""
    return torch.linalg.inv_ex(m).inverse


def _params_to_matrix(theta: torch.Tensor, center: torch.Tensor, transform: str) -> torch.Tensor:
    """4x4 world → world matrix (differentiable in ``theta``); rotation and
    scaling about ``center``: ``x' = R (x - c) + c + t``."""
    dev, dt = theta.device, theta.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    bottom = torch.zeros((1, 4), dtype=dt, device=dev)
    bottom[0, 3] = 1.0  # a fill on the device: no host-to-device copy per call
    if transform == "translation":
        return torch.cat([torch.cat([eye3, theta[:3, None]], dim=1), bottom])
    if transform == "rigid":
        one, zero = torch.ones((), dtype=dt, device=dev), torch.zeros((), dtype=dt, device=dev)
        cx, sx = torch.cos(theta[0]), torch.sin(theta[0])
        cy, sy = torch.cos(theta[1]), torch.sin(theta[1])
        cz, sz = torch.cos(theta[2]), torch.sin(theta[2])

        def mat(rows):
            return torch.stack([torch.stack(r) for r in rows])

        Rx = mat([[one, zero, zero], [zero, cx, -sx], [zero, sx, cx]])
        Ry = mat([[cy, zero, sy], [zero, one, zero], [-sy, zero, cy]])
        Rz = mat([[cz, -sz, zero], [sz, cz, zero], [zero, zero, one]])
        R = _mm(Rz, _mm(Ry, Rx))
        t = theta[3:6]
    else:  # affine: 9 matrix deviations + 3 translations
        R = eye3 + theta[:9].reshape(3, 3)
        t = theta[9:12]
    top = torch.cat([R, (center - _mm(R, center) + t)[:, None]], dim=1)
    return torch.cat([top, bottom])


def _params_to_matrix_np(theta, center, transform: str) -> np.ndarray:
    """Host (float64 numpy) twin of :func:`_params_to_matrix`."""
    theta = np.asarray(theta, np.float64)
    center = np.asarray(center, np.float64)
    if transform == "translation":
        M = np.eye(4)
        M[:3, 3] = theta[:3]
        return M
    if transform == "rigid":
        rx, ry, rz = theta[:3]
        t = theta[3:6]
        cx, sx = np.cos(rx), np.sin(rx)
        cy, sy = np.cos(ry), np.sin(ry)
        cz, sz = np.cos(rz), np.sin(rz)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        R = Rz @ Ry @ Rx
    else:
        R = np.eye(3) + theta[:9].reshape(3, 3)
        t = theta[9:12]
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = center - R @ center + t
    return M


# ----------------------------------------------------------------------
# Resampling
# ----------------------------------------------------------------------
def _trilinear_sample(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``vol`` (D0, D1, D2) at fractional index coordinates (3, N),
    order 1, each corner outside the volume contributing 0: the
    ``map_coordinates(mode="constant", cval=0)`` boundary, so boundary
    samples keep their smooth partial sums. Differentiable in ``coords``."""
    n, chunk = coords.shape[1], interp._POINT_CHUNK
    if n <= chunk:
        return interp._trilinear_gather(vol, coords)
    return torch.cat([interp._trilinear_gather(vol, coords[:, s:s + chunk])
                      for s in range(0, n, chunk)])


def _sample_order(src: torch.Tensor, m_idx: torch.Tensor, order: int) -> torch.Tensor:
    """Sample at index coordinates (3, N) at spline ``order``: 3 samples the
    4x4x4 neighbourhood of ``src``, the moving volume's prefiltered, padded
    coefficients (:func:`~dosma_tpu_torch.ops.interp.cubic_coeffs`, taken
    once for every chunk of points); 0 is nearest (labels and masks) and 1
    trilinear, both of the volume itself."""
    if order == 3:
        return interp.cubic_sample_coeffs(src, m_idx)
    if order == 0:
        return interp.nearest_sample(src, m_idx)
    return _trilinear_sample(src, m_idx)


def _world_matrix_to_index_map(M, fixed_affine, moving_affine) -> torch.Tensor:
    """Index-space map: moving_idx = B @ fixed_idx_homog, B = A_m^-1 M A_f."""
    return _mm(_inv(moving_affine), _mm(M, fixed_affine))


def _warp_arr(moving_arr: torch.Tensor, B: torch.Tensor, fixed_shape, order: int = 1):
    """Full-grid resample under a precomputed index-space map ``B``."""
    return _warp_arr_batch(moving_arr[None], B, fixed_shape, order)[0]


def _grid_index(fixed_shape, device) -> torch.Tensor:
    """Homogeneous index coordinates (4, N) of the fixed grid."""
    axes = [torch.arange(d, dtype=torch.float32, device=device) for d in fixed_shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij")).reshape(3, -1)
    return torch.cat([grid, torch.ones((1, grid.shape[1]), device=device)])


def _warp_arr_batch(moving_stack: torch.Tensor, B: torch.Tensor, fixed_shape, order: int = 1):
    """Full-grid resample of a stack of same-grid volumes under ``B`` (one
    (4|3, 4) map, or one per group of volumes).

    Orders 1 and 3 go to :func:`dosma_tpu_torch.ops.warp.warp_grid_batched`
    (the CUDA kernel for tensors on a card, one launch for the whole stack);
    order 0 (nearest) is plain torch.
    """
    fixed_shape = tuple(int(s) for s in fixed_shape)
    if order in (1, 3):
        return warp_grid_batched(moving_stack, B, fixed_shape, order)
    if order != 0:
        raise ValueError(f"Unsupported interpolation order {order}")
    Bs = B[None] if B.ndim == 2 else B
    per_group = moving_stack.shape[0] // Bs.shape[0]
    idx = _grid_index(fixed_shape, moving_stack.device)
    out = []
    for v in range(moving_stack.shape[0]):
        m_idx = _mm(Bs[v // per_group][:3], idx)
        out.append(interp.nearest_sample(moving_stack[v], m_idx).reshape(fixed_shape))
    return torch.stack(out)


def warp_volume(moving_arr, M, fixed_affine, moving_affine, fixed_shape, order: int = 1):
    """Resample ``moving_arr`` onto the fixed grid under the world transform
    ``M`` (fixed world → moving world).

    ``order``: 0 (nearest), 1 (trilinear) or 3 (cubic B-spline, elastix
    FinalBSplineInterpolationOrder 3). Host input is computed on the
    default device and returned as a numpy array.
    """
    host = not isinstance(moving_arr, torch.Tensor)
    dev = compute_device(moving_arr)
    B = _world_matrix_to_index_map(_f32(M, dev), _f32(fixed_affine, dev), _f32(moving_affine, dev))
    out = _warp_arr(_f32(moving_arr, dev), B, fixed_shape, int(order))
    return _host_or_tensor(out, host)


def warp_volume_batch(moving_stack, M, fixed_affine, moving_affine, fixed_shape,
                      order: int = 1):
    """:func:`warp_volume` of a stack of same-grid volumes (NB, ...): one
    kernel launch for the stack (the transform reuse of ``apply_warp``)."""
    host = not isinstance(moving_stack, torch.Tensor)
    dev = compute_device(moving_stack)
    B = _world_matrix_to_index_map(_f32(M, dev), _f32(fixed_affine, dev), _f32(moving_affine, dev))
    out = _warp_arr_batch(_f32(moving_stack, dev), B, fixed_shape, int(order))
    return _host_or_tensor(out, host)


# ----------------------------------------------------------------------
# Metrics
# ----------------------------------------------------------------------
def _soft_mi(fixed_vals, moving_vals, weights, num_bins: int,
             f_lo, f_hi, m_lo, m_hi, kernel: str = "cubic") -> torch.Tensor:
    """Negative mutual information from Parzen-window soft histograms,
    differentiable in ``moving_vals`` through the fractional bin weights.

    The joint histogram is one product of dense (sample x bin) weight
    matrices. ``kernel="cubic"`` (Mattes): a cubic B-spline window on the
    moving side at twice ``num_bins`` (half the pitch, so its bandwidth
    equals the hat's at ``num_bins``), the moving-bin axis extended by the
    window's 2-bin support at each end, and the hat window on the fixed
    side. ``kernel="linear"``: the hat window on both sides at
    ``num_bins``.
    """
    eps = 1e-10
    dt, dev = fixed_vals.dtype, fixed_vals.device
    if kernel == "cubic":
        nb = 2 * num_bins
        fb = torch.clamp((fixed_vals - f_lo) / (f_hi - f_lo + eps) * (nb - 1), 0, nb - 1)
        mb = torch.clamp((moving_vals - m_lo) / (m_hi - m_lo + eps) * (nb - 1), 0, nb - 1)
        bins = torch.arange(nb, dtype=dt, device=dev)
        F = torch.clamp(1.0 - torch.abs(fb[:, None] - bins[None, :]), min=0.0)  # (S, 2B)
        mbins = torch.arange(-2, nb + 2, dtype=dt, device=dev)
        six = torch.full((), 6.0, dtype=dt, device=dev)
        Mh = interp._b3(mb[:, None] - mbins[None, :], six)  # (S, 2B+4)
    else:
        bins = torch.arange(num_bins, dtype=dt, device=dev)
        fb = torch.clamp((fixed_vals - f_lo) / (f_hi - f_lo + eps) * (num_bins - 1),
                         0, num_bins - 1)
        mb = torch.clamp((moving_vals - m_lo) / (m_hi - m_lo + eps) * (num_bins - 1),
                         0, num_bins - 1)
        F = torch.clamp(1.0 - torch.abs(fb[:, None] - bins[None, :]), min=0.0)
        Mh = torch.clamp(1.0 - torch.abs(mb[:, None] - bins[None, :]), min=0.0)

    joint = _mm((F * weights[:, None]).T, Mh)
    joint = joint / (torch.sum(joint) + eps)
    pf = torch.sum(joint, dim=1, keepdim=True)
    pm = torch.sum(joint, dim=0, keepdim=True)
    mi_val = torch.sum(joint * (torch.log(joint + eps) - torch.log(pf + eps) - torch.log(pm + eps)))
    return -mi_val


def _mse(fixed_vals, moving_vals, weights):
    w = weights / (torch.sum(weights) + 1e-10)
    return torch.sum(w * (fixed_vals - moving_vals) ** 2)


def _ncc(fixed_vals, moving_vals, weights):
    """Negative normalized cross-correlation (elastix's
    AdvancedNormalizedCorrelation), not squared: -(c^2) has zero gradient
    at c = 0 and rewards contrast inversion as much as alignment."""
    w = weights / (torch.sum(weights) + 1e-10)
    fm = torch.sum(w * fixed_vals)
    mm = torch.sum(w * moving_vals)
    fc = fixed_vals - fm
    mc = moving_vals - mm
    num = torch.sum(w * fc * mc)
    den = torch.sqrt(torch.sum(w * fc**2) * torch.sum(w * mc**2)) + 1e-10
    return -(num / den)


# ----------------------------------------------------------------------
# The smoothing pyramid
# ----------------------------------------------------------------------
_SMOOTH_RADIUS = 8  # minimum taps = 2R+1; widened for deep pyramids


def _gauss_smooth3(arr: torch.Tensor, sigma, radius: int = _SMOOTH_RADIUS) -> torch.Tensor:
    """Separable 3D Gaussian blur, ``sigma`` in voxels, edge-padded.

    Shifted-slice sums in ``dosma_tpu``'s order (not ``F.conv3d``, which
    runs in TF32 through cuDNN by default). A sigma near 0 degenerates to
    a delta: the finest level is the unsmoothed volume.
    """
    dev = arr.device
    offs = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    s = torch.full((), float(np.maximum(np.float32(sigma), np.float32(1e-3))), device=dev)
    q = offs / s
    w = torch.exp(-0.5 * (q * q))
    w = w / torch.sum(w)

    for axis in range(3):
        n = arr.shape[axis]
        src = torch.clamp(torch.arange(-radius, n + radius, device=dev), 0, n - 1)
        ap = torch.index_select(arr, axis, src)
        out = torch.zeros_like(arr)
        for k in range(2 * radius + 1):
            out = out + w[k] * ap.narrow(axis, k, n)
        arr = out
    return arr


def _smooth_radius_for_levels(n_levels: int) -> int:
    """Kernel radius covering ~3 sigma of the coarsest level of the
    factor/2 sigma schedule (sigma_max = 2^(L-1)/2)."""
    sigma_max = 2 ** (n_levels - 1) / 2.0
    return max(_SMOOTH_RADIUS, int(np.ceil(3.0 * sigma_max)))


def _smooth_radius_for_sigmas(sigmas) -> int:
    """Kernel radius covering ~3 sigma of an explicit sigma schedule."""
    return max(_SMOOTH_RADIUS, int(np.ceil(3.0 * float(np.max(np.asarray(sigmas))))))


def _pyramid_sigmas(resolutions: int) -> np.ndarray:
    """Per-level smoothing sigmas (voxels): factor/2 for factor 2^(L-1-l),
    0 at the finest level."""
    factors = [2 ** (resolutions - 1 - lvl) for lvl in range(resolutions)]
    return np.array([f / 2.0 if f > 1 else 0.0 for f in factors], np.float32)


def _stage_sigmas(cfg: RegistrationParams) -> np.ndarray:
    """Per-level sigmas of a stage: the elastix ImagePyramidSchedule if
    given (sigma = factor/2), else the default 2^(L-1-l) schedule."""
    if cfg.pyramid_schedule:
        return np.array([f / 2.0 if f > 1 else 0.0 for f in cfg.pyramid_schedule], np.float32)
    return _pyramid_sigmas(cfg.resolutions)


# ----------------------------------------------------------------------
# The optimizer
# ----------------------------------------------------------------------
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8
_COSINE_ALPHA = 0.1  # the schedule decays to 10% of the peak step


def _cosine_lrs(learning_rate: float, iterations: int) -> list:
    """optax.cosine_decay_schedule(learning_rate, max(1, iterations),
    alpha=0.1) at counts 0 .. iterations-1, in float32."""
    f32 = np.float32
    decay_steps = max(1, int(iterations))
    out = []
    for count in range(int(iterations)):
        c = f32(min(count, decay_steps))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c / f32(decay_steps)))
        decayed = f32(1.0 - _COSINE_ALPHA) * cosine + f32(_COSINE_ALPHA)
        out.append(float(f32(learning_rate) * decayed))
    return out


def _adam_step(theta, grad, mu, nu, count: int, lr: float):
    """One optax.adam update (b1 0.9, b2 0.999, eps 1e-8 after the square
    root, no eps_root) at step size ``lr``; ``count`` is the number of
    updates before this one. Returns ``(theta, mu, nu)``."""
    mu = (1 - _ADAM_B1) * grad + _ADAM_B1 * mu
    nu = (1 - _ADAM_B2) * (grad * grad) + _ADAM_B2 * nu
    t = np.float32(count + 1)
    bc1 = float(np.float32(1.0) - np.power(np.float32(_ADAM_B1), t))
    bc2 = float(np.float32(1.0) - np.power(np.float32(_ADAM_B2), t))
    update = (mu / bc1) / (torch.sqrt(nu / bc2) + _ADAM_EPS)
    return theta + update * (-lr), mu, nu


def _level_draws(seed: int, level: int, iterations: int, num_samples: int,
                 device) -> torch.Tensor:
    """Uniform [0, 1) draws (iterations, 3, num_samples) of one pyramid
    level: a fresh set of fixed-grid sample coordinates per iteration, from
    a generator seeded by (seed, level)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + int(level)) % (2**63))
    return torch.rand((iterations, 3, num_samples), generator=gen, device=device)


def _bspline_draws(seed: int, stage: int, iterations: int, num_samples: int,
                   device) -> torch.Tensor:
    """Uniform [0, 1) draws (iterations, 3, num_samples) of one B-spline
    stage, from a generator seeded by (seed, stage) as :func:`_level_draws`
    seeds a pyramid level's."""
    return _level_draws(seed, stage, iterations, num_samples, device)


def _pyramid_core(
    fixed_arr, fixed_affine, fixed_mask,
    moving_arr, moving_affine,
    theta0, param_scale, center, sigmas,
    transform: str, metric: str,
    iterations: int, num_samples: int, num_bins: int,
    learning_rate, seed,
    moving_mask=None,
    radius: Optional[int] = None,
    mi_kernel: str = "cubic",
    interp_order: int = 1,
):
    """Multi-resolution optimization of one parameter stage.

    Tensors on one device; ``sigmas`` a host array. Every level works on
    the full grid smoothed by its sigma, restarts Adam and the cosine
    schedule, and starts from the previous level's parameters. Returns
    ``(theta (P,), losses (levels, iterations))``.
    """
    fshape = tuple(fixed_arr.shape)
    inv_moving = _inv(moving_affine)
    sigmas = np.asarray(sigmas, np.float32)
    if radius is None:
        radius = _smooth_radius_for_levels(int(sigmas.shape[0]))
    dev = fixed_arr.device
    shape_m1 = torch.tensor(fshape, dtype=torch.float32, device=dev) - 1
    m_hi_idx = torch.tensor(moving_arr.shape, dtype=torch.float32, device=dev)[:, None] - 1
    lrs = _cosine_lrs(learning_rate, iterations)
    tail_start = max(0, iterations - max(1, iterations // 4))

    theta = theta0
    losses = []
    for level_idx, sigma in enumerate(sigmas):
        f_s = _gauss_smooth3(fixed_arr, sigma, radius)
        m_s = _gauss_smooth3(moving_arr, sigma, radius)
        # Metric-sampling interpolator: order 3 prefilters and pads the
        # smoothed moving image once per level.
        m_cp = interp.cubic_coeffs(m_s) if interp_order == 3 else None
        mask_s = _gauss_smooth3(fixed_mask, sigma, radius) if fixed_mask is not None else None
        mmask_s = _gauss_smooth3(moving_mask, sigma, radius) if moving_mask is not None else None
        f_lo, f_hi = torch.min(f_s), torch.max(f_s)
        m_lo, m_hi = torch.min(m_s), torch.max(m_s)

        # The fixed side of the metric does not depend on theta: draw every
        # iteration's coordinates up front, sort each iteration's samples by
        # linear index (the metric is permutation-invariant; the moving-side
        # gathers then walk near-monotone addresses), and sample fixed
        # values, mask weights and world coordinates in one pass.
        u = _level_draws(seed, level_idx, iterations, num_samples, dev)
        idx_all = u * shape_m1[None, :, None]
        lin = (idx_all[:, 0] * fshape[1] + idx_all[:, 1]) * fshape[2] + idx_all[:, 2]
        order = torch.argsort(lin, dim=1, stable=True)
        idx_all = torch.take_along_dim(idx_all, order[:, None, :], dim=2)
        flat = idx_all.permute(1, 0, 2).reshape(3, iterations * num_samples)
        fixed_vals_all = _trilinear_sample(f_s, flat).reshape(iterations, num_samples)
        w0_all = (_trilinear_sample(mask_s, flat).reshape(iterations, num_samples)
                  if mask_s is not None else None)
        flat_h = torch.cat([flat, torch.ones((1, flat.shape[1]), device=dev)])
        world_all = _mm(fixed_affine, flat_h).reshape(4, iterations, num_samples).permute(1, 0, 2)

        def loss_fn(theta_n, it):
            th = theta_n * param_scale
            M = _params_to_matrix(th, center, transform)
            m_idx = _mm(inv_moving, _mm(M, world_all[it]))[:3]
            if interp_order == 3:
                moving_vals = interp.cubic_sample_coeffs(m_cp, m_idx)
            else:
                moving_vals = _trilinear_sample(m_s, m_idx)
            # Downweight samples that map outside the moving volume.
            inside = torch.all((m_idx >= 0) & (m_idx <= m_hi_idx), dim=0)
            w0 = w0_all[it] if w0_all is not None else 1.0
            weights = w0 * (0.01 + 0.99 * inside.to(torch.float32))
            if mmask_s is not None:
                weights = weights * _trilinear_sample(mmask_s, m_idx)
            fixed_vals = fixed_vals_all[it]
            if metric == "mi":
                return _soft_mi(fixed_vals, moving_vals, weights, num_bins, f_lo, f_hi,
                                m_lo, m_hi, kernel=mi_kernel)
            if metric == "ncc":
                return _ncc(fixed_vals, moving_vals, weights)
            return _mse(fixed_vals, moving_vals, weights)

        theta_n = (theta / param_scale).detach()
        mu, nu = torch.zeros_like(theta_n), torch.zeros_like(theta_n)
        acc = torch.zeros_like(theta_n)
        level_losses = []
        for it in range(iterations):
            theta_n.requires_grad_(True)
            loss = loss_fn(theta_n, it)
            (grad,) = torch.autograd.grad(loss, theta_n)
            with torch.no_grad():
                theta_n, mu, nu = _adam_step(theta_n.detach(), grad, mu, nu, it, lrs[it])
                if it >= tail_start:
                    acc = acc + theta_n
            level_losses.append(loss.detach())
        # Polyak tail average over the last quarter; iterations == 0 is a
        # no-op stage that keeps its seed.
        n_tail = iterations - tail_start
        theta_n = acc / float(n_tail) if n_tail > 0 else theta_n.detach()
        theta = theta_n * param_scale
        losses.append(torch.stack(level_losses) if level_losses
                      else torch.zeros(0, device=dev))
    return theta, torch.stack(losses)


# ----------------------------------------------------------------------
# Chains
# ----------------------------------------------------------------------
def _seed_theta_traced(transform: str, M: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Stage seed from the previous stage's world matrix, on the device
    (the seeding policy of :func:`_seed_theta_from_matrix`)."""
    lin = M[:3, :3]
    t_world = M[:3, 3] + _mm(lin, center) - center
    if transform == "translation":
        return M[:3, 3]
    if transform == "rigid":
        # Translation-only seed: Euler angles of a possibly non-orthogonal
        # prior are ill-defined.
        return torch.cat([torch.zeros(3, device=M.device), t_world])
    return torch.cat([(lin - torch.eye(3, device=M.device)).reshape(-1), t_world])


def _optimize_chain_impl(
    fixed_arr, fixed_affine, fixed_mask,
    moving_arr, moving_affine, moving_mask,
    extras, init_matrix, center, scales, sigmas, seeds,
    stage_statics, final_order: int = 1, warp: bool = True,
):
    """A sequential-stage chain (e.g. rigid → affine) and its final warp.

    Each stage re-registers the ORIGINAL moving image, warm-started from the
    previous stage's world transform: the same fixed → moving map as
    elastix's chaining of resampled outputs, with no intermediate
    interpolation. ``stage_statics``: per stage ``(transform, metric,
    iterations, num_samples, num_bins, lr, use_fmask, use_mmask, radius,
    mi_kernel, interp_order)``. The final warp of the moving volume and of
    every volume of ``extras`` (on the moving grid) is ONE warp-kernel
    launch. Returns ``(Ms_cumulative, warped, warped_extras,
    losses_per_stage, B)``; with ``warp=False`` the warps are skipped.
    """
    M = init_matrix
    Ms, losses_all = [], []
    for i, st in enumerate(stage_statics):
        (transform, metric, iterations, num_samples, num_bins, lr,
         use_fm, use_mm, radius, mi_kernel, interp_order) = st
        theta0 = _seed_theta_traced(transform, M, center)
        theta, losses = _pyramid_core(
            fixed_arr, fixed_affine, fixed_mask if use_fm else None,
            moving_arr, moving_affine,
            theta0, scales[i], center, sigmas[i],
            transform, metric, iterations, num_samples, num_bins,
            lr, seeds[i],
            moving_mask=moving_mask if use_mm else None,
            radius=radius,
            mi_kernel=mi_kernel,
            interp_order=interp_order,
        )
        M = _params_to_matrix(theta, center, transform)
        Ms.append(M)
        losses_all.append(losses)

    B = _world_matrix_to_index_map(M, fixed_affine, moving_affine)
    warped = warped_extras = None
    if warp:
        stack = moving_arr[None] if extras is None else torch.cat([moving_arr[None], extras])
        warped_all = _warp_arr_batch(stack, B, tuple(fixed_arr.shape), final_order)
        warped = warped_all[0]
        warped_extras = warped_all[1:] if extras is not None else None
    return tuple(Ms), warped, warped_extras, tuple(losses_all), B


def _chain_statics(stage_cfgs, use_fmask, use_mmask):
    return tuple(
        (
            cfg.transform, cfg.metric, int(cfg.iterations), int(cfg.num_samples),
            int(cfg.num_bins), float(cfg.learning_rate),
            bool(use_fmask[i]), bool(use_mmask[i]),
            _smooth_radius_for_sigmas(_stage_sigmas(cfg)),
            str(cfg.mi_kernel), int(cfg.interp_order),
        )
        for i, cfg in enumerate(stage_cfgs)
    )


def _fixed_center(fixed_shape, fixed_affine) -> np.ndarray:
    """World coordinates of the fixed grid's centre (the rotation centre)."""
    center_idx = (np.asarray(fixed_shape) - 1) / 2.0
    return (np.asarray(fixed_affine) @ np.array([*center_idx, 1.0]))[:3].astype(np.float32)


def _spacing(affine) -> np.ndarray:
    return np.sqrt((np.asarray(affine)[:3, :3] ** 2).sum(0))


def _chain_host_args(stage_cfgs, fixed_shape, fixed_affine):
    spacing = _spacing(fixed_affine)
    center = _fixed_center(fixed_shape, fixed_affine)
    scales = tuple(_param_scale(cfg.transform, fixed_shape, spacing) for cfg in stage_cfgs)
    sigmas = tuple(_stage_sigmas(cfg) for cfg in stage_cfgs)
    return center, scales, sigmas


def _matrix_stages_only(stage_cfgs, name: str):
    if any(cfg.transform == "bspline" for cfg in stage_cfgs):
        raise ValueError(f"{name} supports matrix stages only (no bspline)")


def register_chain(
    fixed_arr,
    fixed_affine: np.ndarray,
    moving_arr,
    moving_affine: np.ndarray,
    stage_cfgs: Sequence[RegistrationParams],
    fixed_mask=None,
    moving_mask=None,
    use_mask: Optional[Sequence[bool]] = None,
    extras=None,
    init_matrix: Optional[np.ndarray] = None,
):
    """Sequential-stage registration and the final warps.

    Every matrix stage of the chain, then the warp of ``moving_arr`` and of
    every volume in ``extras`` (on the moving grid, the transform reuse of
    the reference) in one kernel launch.

    Returns ``(Ms, warped, warped_extras, info)``: ``Ms[i]`` is the
    CUMULATIVE fixed-world → moving-world matrix after stage ``i`` (host
    float64), ``warped``/``warped_extras`` lie on the fixed grid (host
    arrays for host input, tensors on the input's device otherwise).
    """
    stage_cfgs = list(stage_cfgs)
    _matrix_stages_only(stage_cfgs, "register_chain")
    if use_mask is None:
        use_mask = [fixed_mask is not None or moving_mask is not None] * len(stage_cfgs)
    host = not isinstance(moving_arr, torch.Tensor)
    dev = compute_device(moving_arr, fixed_arr)

    fixed_dev = _f32(fixed_arr, dev)
    moving_dev = _f32(moving_arr, dev)
    fmask_dev = _f32(fixed_mask, dev) if fixed_mask is not None else None
    mmask_dev = _f32(moving_mask, dev) if moving_mask is not None else None
    extras_dev = (torch.stack([_f32(e, dev) for e in extras])
                  if extras is not None and len(extras) else None)

    use_fmask = [bool(u) and fmask_dev is not None for u in use_mask]
    use_mmask = [bool(u) and mmask_dev is not None for u in use_mask]
    statics = _chain_statics(stage_cfgs, use_fmask, use_mmask)
    center, scales, sigmas = _chain_host_args(stage_cfgs, fixed_dev.shape, fixed_affine)
    init = np.eye(4, dtype=np.float32) if init_matrix is None else init_matrix

    Ms, warped, warped_extras, losses, _B = _optimize_chain_impl(
        fixed_dev, _f32(fixed_affine, dev), fmask_dev if any(use_fmask) else None,
        moving_dev, _f32(moving_affine, dev), mmask_dev if any(use_mmask) else None,
        extras_dev, _f32(init, dev), _f32(center, dev),
        tuple(_f32(s, dev) for s in scales), sigmas,
        tuple(int(cfg.seed) for cfg in stage_cfgs),
        statics, int(stage_cfgs[-1].final_interp_order),
    )
    Ms_host = [M.cpu().numpy().astype(np.float64) for M in Ms]
    info = {"losses": [l.cpu().numpy() for l in losses]}
    # Per-stage stall diagnostics; `stalled` reflects the FINAL stage.
    info["stages"] = [_stall_diagnostics(l) for l in info["losses"]]
    info.update(info["stages"][-1])
    warped = _host_or_tensor(warped, host)
    if warped_extras is not None:
        warped_extras = _host_or_tensor(warped_extras, host)
    return Ms_host, warped, warped_extras, info


def register_chain_batch(
    fixed_arr,
    fixed_affine: np.ndarray,
    moving_arrs,
    moving_affine: np.ndarray,
    stage_cfgs: Sequence[RegistrationParams],
    fixed_mask=None,
    use_mask: Optional[Sequence[bool]] = None,
    first_index: int = 0,
):
    """:func:`register_chain` for a stack of moving images on one grid (the
    intra-registration case). Each image runs the chain in turn, with stage
    seeds offset by its index (plus ``first_index``: a rank's block of a
    sharded batch offsets by its images' global indices); the final warps of
    the whole stack are one kernel launch, one transform per volume.

    Returns ``(Ms (M, S, 4, 4) cumulative per stage, warped (M, ...),
    info)``.
    """
    stage_cfgs = list(stage_cfgs)
    _matrix_stages_only(stage_cfgs, "register_chain_batch")
    if use_mask is None:
        use_mask = [fixed_mask is not None] * len(stage_cfgs)
    host = not isinstance(moving_arrs, torch.Tensor)
    dev = compute_device(moving_arrs, fixed_arr)

    fixed_dev = _f32(fixed_arr, dev)
    moving_dev = _f32(moving_arrs, dev)
    fmask_dev = _f32(fixed_mask, dev) if fixed_mask is not None else None
    use_fmask = [bool(u) and fmask_dev is not None for u in use_mask]
    statics = _chain_statics(stage_cfgs, use_fmask, [False] * len(stage_cfgs))
    center, scales, sigmas = _chain_host_args(stage_cfgs, fixed_dev.shape, fixed_affine)
    f_aff, m_aff = _f32(fixed_affine, dev), _f32(moving_affine, dev)
    center_dev = _f32(center, dev)
    scales_dev = tuple(_f32(s, dev) for s in scales)
    init = torch.eye(4, device=dev)

    Ms, Bs, losses = [], [], []
    for i in range(moving_dev.shape[0]):
        seeds = tuple(int(cfg.seed) + first_index + i for cfg in stage_cfgs)
        Ms_i, _w, _e, losses_i, B = _optimize_chain_impl(
            fixed_dev, f_aff, fmask_dev if any(use_fmask) else None,
            moving_dev[i], m_aff, None, None, init, center_dev, scales_dev, sigmas, seeds,
            statics, warp=False,
        )
        Ms.append(torch.stack(Ms_i))
        Bs.append(B)
        losses.append(losses_i)
    warped = _warp_arr_batch(moving_dev, torch.stack(Bs), tuple(fixed_dev.shape),
                             int(stage_cfgs[-1].final_interp_order))
    info = {"losses": [np.stack([l[s].cpu().numpy() for l in losses])
                       for s in range(len(stage_cfgs))]}
    return torch.stack(Ms).cpu().numpy().astype(np.float64), _host_or_tensor(warped, host), info


# ----------------------------------------------------------------------
# Single stages
# ----------------------------------------------------------------------
def _seed_theta_from_matrix(params: RegistrationParams, init_matrix, center) -> np.ndarray:
    """Initial parameters from a prior world → world matrix.

    With ``x' = R (x - c) + c + t``, ``t = M[:3,3] - c + R c``. Translation
    stages take t with R = I; affine stages also seed the linear part;
    rigid stages seed the translation only.
    """
    theta0 = np.zeros(params.nparams, np.float32)
    if init_matrix is None:
        return theta0
    M = np.asarray(init_matrix, np.float64)
    center = np.asarray(center, np.float64)
    if params.transform == "translation":
        theta0[:3] = M[:3, 3]
    elif params.transform == "rigid":
        theta0[3:6] = M[:3, 3] + M[:3, :3] @ center - center
    else:  # affine
        theta0[:9] = (M[:3, :3] - np.eye(3)).ravel()
        theta0[9:12] = M[:3, 3] + M[:3, :3] @ center - center
    return theta0


def _param_scale(transform: str, fixed_shape, spacing) -> np.ndarray:
    """Natural parameter scales: ~0.1 rad rotations, ~1/10 FOV translations."""
    fov = float(np.mean(np.asarray(fixed_shape) * np.asarray(spacing)))
    t_scale = max(fov / 10.0, 1.0)
    if transform == "translation":
        return np.full(3, t_scale, np.float32)
    if transform == "rigid":
        return np.concatenate([np.full(3, 0.1), np.full(3, t_scale)]).astype(np.float32)
    return np.concatenate([np.full(9, 0.1), np.full(3, t_scale)]).astype(np.float32)


def _stall_diagnostics(losses_per_level) -> dict:
    """``stalled=True`` when the FINEST level's loss did not measurably
    improve (medians of its first and last deciles): the registration likely
    failed to engage. A pair that starts at the optimum also shows no
    decrease."""
    finest = np.asarray(losses_per_level[-1], np.float64).ravel()
    if finest.size < 10:
        return {"stalled": False, "loss_decrease": 0.0}
    k = max(1, finest.size // 10)
    start = float(np.median(finest[:k]))
    end = float(np.median(finest[-k:]))
    decrease = start - end
    scale = max(abs(start), 1e-12)
    return {"stalled": bool(decrease < 1e-4 * scale), "loss_decrease": decrease}


def _run_pyramid_stage(fixed_dev, fixed_affine, mask_dev, moving_dev, moving_affine,
                       theta0, center, spacing, params: RegistrationParams, moving_mask=None):
    """One parameter stage on device tensors; returns host (theta, losses)."""
    dev = fixed_dev.device
    scale = _param_scale(params.transform, fixed_dev.shape, spacing)
    sigmas = _stage_sigmas(params)
    theta, losses = _pyramid_core(
        fixed_dev, _f32(fixed_affine, dev), mask_dev,
        moving_dev, _f32(moving_affine, dev),
        _f32(theta0, dev), _f32(scale, dev), _f32(center, dev), sigmas,
        params.transform, params.metric,
        params.iterations, params.num_samples, params.num_bins,
        params.learning_rate, params.seed,
        moving_mask=moving_mask,
        radius=_smooth_radius_for_sigmas(sigmas),
        mi_kernel=params.mi_kernel,
        interp_order=int(params.interp_order),
    )
    return theta.cpu().numpy(), losses.cpu().numpy()


def register_pair(
    fixed_arr,
    fixed_affine: np.ndarray,
    moving_arr,
    moving_affine: np.ndarray,
    params: RegistrationParams,
    fixed_mask=None,
    init_matrix: Optional[np.ndarray] = None,
    moving_mask=None,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Multi-resolution registration of one moving image to the fixed image.

    Returns ``(M, theta, info)``: ``M`` the 4x4 world → world transform
    (fixed-world point → moving-world point), ``theta`` the stage's raw
    parameters, ``info`` the per-level losses and stall diagnostics.
    """
    dev = compute_device(moving_arr, fixed_arr)
    fixed_dev = _f32(fixed_arr, dev)
    moving_dev = _f32(moving_arr, dev)
    mask_dev = _f32(fixed_mask, dev) if fixed_mask is not None else None
    mmask_dev = _f32(moving_mask, dev) if moving_mask is not None else None
    center = _fixed_center(fixed_dev.shape, fixed_affine)
    theta0 = _seed_theta_from_matrix(params, init_matrix, center)
    theta_host, losses = _run_pyramid_stage(
        fixed_dev, fixed_affine, mask_dev, moving_dev, moving_affine,
        theta0, center, _spacing(fixed_affine), params, moving_mask=mmask_dev,
    )
    M = _params_to_matrix_np(theta_host, center, params.transform)
    info = {"losses": [np.asarray(l) for l in losses]}
    info.update(_stall_diagnostics(info["losses"]))
    return M, theta_host, info


def register_pair_batch(
    fixed_arr,
    fixed_affine: np.ndarray,
    moving_arrs,
    moving_affine: np.ndarray,
    params: RegistrationParams,
    fixed_mask=None,
):
    """Register a stack of moving images (M, d0, d1, d2) on one grid to one
    fixed image, image ``i`` with seed ``params.seed + i``. Returns
    ``(Ms (M, 4, 4), thetas (M, P), info)``."""
    dev = compute_device(moving_arrs, fixed_arr)
    fixed_dev = _f32(fixed_arr, dev)
    moving_dev = _f32(moving_arrs, dev)
    mask_dev = _f32(fixed_mask, dev) if fixed_mask is not None else None
    center = _fixed_center(fixed_dev.shape, fixed_affine)
    spacing = _spacing(fixed_affine)
    theta0 = np.zeros(params.nparams, np.float32)
    thetas, losses = [], []
    for i in range(moving_dev.shape[0]):
        cfg = dataclasses.replace(params, seed=params.seed + i)
        theta, loss = _run_pyramid_stage(fixed_dev, fixed_affine, mask_dev, moving_dev[i],
                                         moving_affine, theta0, center, spacing, cfg)
        thetas.append(theta)
        losses.append(loss)
    thetas = np.stack(thetas)
    losses = np.stack(losses)  # (M, levels, iterations)
    info = {"losses": [losses[:, lvl] for lvl in range(losses.shape[1])]}
    Ms = np.stack([_params_to_matrix_np(t, center, params.transform) for t in thetas])
    return Ms, thetas, info


# ----------------------------------------------------------------------
# The B-spline (FFD) stage
# ----------------------------------------------------------------------
def _optimize_bspline_chain(
    fixed_arr, fixed_affine, fixed_mask,
    moving_arr, moving_affine, moving_mask,
    ctrl0, spacings, bending_weight: float, seed: int,
    stage_statics, metric: str, num_bins: int,
    mi_kernel: str = "cubic", interp_order: int = 1,
):
    """The multi-grid FFD chain (Rueckert's schedule, elastix's
    GridSpacingSchedule with a FixedSmoothingImagePyramid).

    Each stage optimizes the control grid on the full-resolution pair
    smoothed by the stage's sigma, with the stage's own iteration and sample
    budgets, Adam under a cosine schedule and a Polyak average over the
    last quarter; the grid is then subdivided (exact knot insertion) for
    the next, finer stage. A zero-iteration stage passes the grid through.
    Tensors on one device; ``stage_statics`` per stage ``(grid_shape,
    sigma, radius, iterations, num_samples, lr)``; ``spacings`` (stages, 3)
    control spacings in fixed-index units. Returns ``(ctrl, losses per
    stage)``.
    """
    dev = fixed_arr.device
    fshape = tuple(fixed_arr.shape)
    inv_moving = _inv(moving_affine)
    f_lo, f_hi = torch.min(fixed_arr), torch.max(fixed_arr)
    m_lo, m_hi = torch.min(moving_arr), torch.max(moving_arr)
    shape_m1 = torch.tensor(fshape, dtype=torch.float32, device=dev) - 1
    m_hi_idx = torch.tensor(moving_arr.shape, dtype=torch.float32, device=dev)[:, None] - 1

    ctrl = ctrl0
    losses_all = []
    n_stages = len(stage_statics)
    for g, (grid_shape, sigma, radius, iterations, num_samples, lr) in enumerate(stage_statics):
        if iterations <= 0:
            # elastix allows 0 in a per-level MaximumNumberOfIterations.
            losses_all.append(torch.zeros(0, device=dev))
            if g + 1 < n_stages:
                ctrl = subdivide_control_grid(ctrl, stage_statics[g + 1][0])
            continue
        spacing_vox = spacings[g]
        if sigma > 0:
            f_s = _gauss_smooth3(fixed_arr, sigma, radius)
            m_s = _gauss_smooth3(moving_arr, sigma, radius)
            mask_s = _gauss_smooth3(fixed_mask, sigma, radius) if fixed_mask is not None else None
            mmask_s = (_gauss_smooth3(moving_mask, sigma, radius)
                       if moving_mask is not None else None)
        else:
            f_s, m_s, mask_s, mmask_s = fixed_arr, moving_arr, fixed_mask, moving_mask
        m_cp = interp.cubic_coeffs(m_s) if interp_order == 3 else None

        # The fixed side does not depend on the grid: draw every iteration's
        # coordinates up front and sample fixed values, mask weights and
        # world coordinates in one pass.
        u = _bspline_draws(seed, g, iterations, num_samples, dev)
        idx_all = u * shape_m1[None, :, None]
        flat = idx_all.permute(1, 0, 2).reshape(3, iterations * num_samples)
        fixed_vals_all = _trilinear_sample(f_s, flat).reshape(iterations, num_samples)
        w0_all = (_trilinear_sample(mask_s, flat).reshape(iterations, num_samples)
                  if mask_s is not None else None)
        flat_h = torch.cat([flat, torch.ones((1, flat.shape[1]), device=dev)])
        world_all = _mm(fixed_affine, flat_h).reshape(4, iterations, num_samples).permute(1, 0, 2)

        def loss_fn(ctrl_g, it, spacing_vox=spacing_vox, m_s=m_s, m_cp=m_cp,
                    mmask_s=mmask_s, w0_all=w0_all):
            disp = bspline_displacement(ctrl_g, idx_all[it], spacing_vox)
            world = world_all[it]
            world = torch.cat([world[:3] + disp, world[3:]])
            m_idx = _mm(inv_moving, world)[:3]
            if interp_order == 3:
                moving_vals = interp.cubic_sample_coeffs(m_cp, m_idx)
            else:
                moving_vals = _trilinear_sample(m_s, m_idx)
            inside = torch.all((m_idx >= 0) & (m_idx <= m_hi_idx), dim=0)
            w0 = w0_all[it] if w0_all is not None else 1.0
            weights = w0 * (0.01 + 0.99 * inside.to(torch.float32))
            if mmask_s is not None:
                weights = weights * _trilinear_sample(mmask_s, m_idx)
            fixed_vals = fixed_vals_all[it]
            if metric == "mi":
                data_loss = _soft_mi(fixed_vals, moving_vals, weights, num_bins, f_lo, f_hi,
                                     m_lo, m_hi, kernel=mi_kernel)
            elif metric == "ncc":
                data_loss = _ncc(fixed_vals, moving_vals, weights)
            else:
                data_loss = _mse(fixed_vals, moving_vals, weights)
            return data_loss + bending_weight * bending_energy(ctrl_g)

        lrs = _cosine_lrs(lr, iterations)
        # Polyak tail average: the stochastic metric makes the annealed
        # iterates bounce around the optimum; the last quarter's mean
        # cancels that noise. Only the average propagates.
        tail_start = max(0, iterations - max(1, iterations // 4))
        mu, nu = torch.zeros_like(ctrl), torch.zeros_like(ctrl)
        acc = torch.zeros_like(ctrl)
        stage_losses = []
        for it in range(iterations):
            ctrl_g = ctrl.detach().requires_grad_(True)
            with full_f32():  # the backward's products too
                loss = loss_fn(ctrl_g, it)
                (grad,) = torch.autograd.grad(loss, ctrl_g)
            with torch.no_grad():
                ctrl, mu, nu = _adam_step(ctrl_g.detach(), grad, mu, nu, it, lrs[it])
                if it >= tail_start:
                    acc = acc + ctrl
            stage_losses.append(loss.detach())
        ctrl = acc / float(iterations - tail_start)
        losses_all.append(torch.stack(stage_losses))
        if g + 1 < n_stages:
            ctrl = subdivide_control_grid(ctrl, stage_statics[g + 1][0])
    return ctrl, tuple(losses_all)


def _bspline_stage_plan(fixed_shape, fixed_affine, params: RegistrationParams):
    """Coarse → fine multi-grid plan: per-stage control grid shape and
    spacing (index units), smoothing sigma and learning rate.

    Stage ``g`` of ``n`` uses the control spacing ``final * 2^(n-1-g)`` and
    the matrix pyramid's sigma for that level; grid shapes follow
    :func:`~dosma_tpu_torch.ops.bspline.make_control_grid`.
    """
    sigmas = _stage_sigmas(params)
    n = len(sigmas)
    _, spacing_final = make_control_grid(
        fixed_shape, fixed_affine, params.grid_spacing_mm, params.grid_spacing_vox
    )
    shapes, spacings, stage_sigmas, lrs = [], [], [], []
    for g in range(n):
        shape, s = make_control_grid(fixed_shape, fixed_affine, None,
                                     grid_spacing_vox=spacing_final * (2 ** (n - 1 - g)))
        shapes.append(shape)
        spacings.append(s.astype(np.float32))
        stage_sigmas.append(float(sigmas[g]))
        # Displacements are in mm: coarse grids take proportionally larger steps.
        lrs.append(params.learning_rate * float(np.mean(s)))
    return shapes, spacings, stage_sigmas, lrs


def register_pair_bspline(
    fixed_arr,
    fixed_affine: np.ndarray,
    moving_arr,
    moving_affine: np.ndarray,
    params: RegistrationParams,
    fixed_mask=None,
    moving_mask=None,
):
    """Multi-grid, multi-resolution B-spline FFD registration.

    Returns ``(ctrl (3, gx, gy, gz), spacing_vox (3,), info)`` as host
    arrays: the control displacements in world mm over the full-resolution
    fixed index grid at the FINAL (``params.grid_spacing_mm``) spacing, and
    the per-stage losses with the stall diagnostics.
    """
    dev = compute_device(moving_arr, fixed_arr)
    fixed_dev = _f32(fixed_arr, dev)
    moving_dev = _f32(moving_arr, dev)
    shapes, spacings, sigmas, lrs = _bspline_stage_plan(tuple(fixed_dev.shape), fixed_affine,
                                                        params)
    stage_iters, stage_samples = params.level_budget(len(shapes))
    stage_statics = tuple(
        # The stage's own kernel radius: a fine stage does not pay the
        # coarsest stage's taps.
        (shapes[g], sigmas[g], max(1, int(np.ceil(3.0 * float(sigmas[g])))),
         stage_iters[g], stage_samples[g], float(lrs[g]))
        for g in range(len(shapes))
    )
    ctrl, losses = _optimize_bspline_chain(
        fixed_dev, _f32(fixed_affine, dev),
        _f32(fixed_mask, dev) if fixed_mask is not None else None,
        moving_dev, _f32(moving_affine, dev),
        _f32(moving_mask, dev) if moving_mask is not None else None,
        torch.zeros((3, *shapes[0]), dtype=torch.float32, device=dev),
        _f32(np.stack(spacings), dev), float(np.float32(params.bending_weight)),
        int(params.seed), stage_statics, params.metric, int(params.num_bins),
        mi_kernel=params.mi_kernel, interp_order=int(params.interp_order),
    )
    info = {"losses": [l.cpu().numpy() for l in losses]}
    info.update(_stall_diagnostics(info["losses"]))
    return ctrl.cpu().numpy(), np.asarray(spacings[-1]), info


# ----------------------------------------------------------------------
# Transform chains
# ----------------------------------------------------------------------
_CHAIN_CHUNK = 1 << 20  # fixed-grid points a pass of a mixed chain


def _grid_points(fixed_shape, start: int, stop: int, device) -> torch.Tensor:
    """Homogeneous index coordinates (4, stop - start) of the fixed grid's
    points ``start .. stop-1`` in C order."""
    _d0, d1, d2 = fixed_shape
    lin = torch.arange(start, stop, dtype=torch.int64, device=device)
    pts = torch.stack([lin // (d1 * d2), (lin // d2) % d1, lin % d2]).to(torch.float32)
    return torch.cat([pts, torch.ones((1, pts.shape[1]), device=device)])


def _warp_chain_impl(moving_arr, fixed_affine, moving_affine, payloads, kinds,
                     fixed_shape, order: int = 1):
    """Resample ``moving_arr`` through a mixed chain: each fixed point goes
    through the stages innermost-last, ``y = T1(T2(...Tn(x)))``, then one
    interpolation at spline ``order``. The fixed grid runs in chunks of
    :data:`_CHAIN_CHUNK` points, which bounds the world-coordinate and
    displacement temporaries (a knee's 23.6M points would take 377 MB for
    the homogeneous grid alone)."""
    dev = moving_arr.device
    inv_fixed = _inv(fixed_affine)
    inv_moving = _inv(moving_affine)
    src = interp.cubic_coeffs(moving_arr) if order == 3 else moving_arr
    n = int(np.prod(fixed_shape))
    out = torch.empty(n, dtype=torch.float32, device=dev)
    stages = list(zip(kinds, payloads))[::-1]
    for start in range(0, n, _CHAIN_CHUNK):
        stop = min(n, start + _CHAIN_CHUNK)
        world = _mm(fixed_affine, _grid_points(fixed_shape, start, stop, dev))
        for kind, payload in stages:
            if kind == "matrix":
                world = _mm(payload[0], world)
            else:
                ctrl, spacing_vox = payload
                disp = bspline_displacement(ctrl, _mm(inv_fixed, world)[:3], spacing_vox)
                world = torch.cat([world[:3] + disp, world[3:]])
        out[start:stop] = _sample_order(src, _mm(inv_moving, world)[:3], order)
    return out.reshape(fixed_shape)


def warp_volume_chain(moving_arr, stages, fixed_affine, moving_affine, fixed_shape,
                      order: int = 1):
    """Resample through a transform chain of ``("matrix", M)`` and
    ``("bspline", ctrl, spacing_vox)`` stages in estimation order, with ONE
    final interpolation at spline ``order`` (0 nearest, 1 trilinear, 3
    cubic B-spline).

    A matrix-only chain composes (:func:`compose_transforms`) and warps
    through the warp kernel (:func:`warp_volume`); a chain with a B-spline
    stage maps the fixed points through each stage and samples the moving
    image at them (:func:`_warp_chain_impl`). Host input is computed on the
    default device and returned as a numpy array.
    """
    fixed_shape = tuple(int(s) for s in fixed_shape)
    stages = list(stages)
    kinds = [kind for kind, *_ in stages]
    bad = [k for k in kinds if k not in ("matrix", "bspline")]
    if bad:
        raise ValueError(f"Unknown stage kind {bad[0]}")
    if "bspline" not in kinds:
        M = compose_transforms([payload[0] for _kind, *payload in stages])
        return warp_volume(moving_arr, M, fixed_affine, moving_affine, fixed_shape, order=order)
    host = not isinstance(moving_arr, torch.Tensor)
    dev = compute_device(moving_arr)
    payloads = [tuple(_f32(x, dev) for x in payload) for _kind, *payload in stages]
    out = _warp_chain_impl(_f32(moving_arr, dev), _f32(fixed_affine, dev),
                           _f32(moving_affine, dev), payloads, kinds, fixed_shape, int(order))
    return _host_or_tensor(out, host)


def compose_transforms(matrices: Sequence[np.ndarray]) -> np.ndarray:
    """Compose sequential stage transforms into one world map,
    ``M1 @ M2 @ ... @ Mn``: stage i+1 is estimated on stage i's output,
    which lives on the fixed grid, so the chain resamples once."""
    out = np.eye(4)
    for M in matrices:
        out = out @ np.asarray(M)
    return out
