"""Batched nonlinear least squares: Levenberg–Marquardt in plain PyTorch.

Counterpart of ``dosma_tpu/ops/nlls.py``, on the device the data is on. The
voxel axis N is last: parameters are P flat (N,) vectors, data is (T, N),
and the P×P normal equations are per-voxel (N,) entries solved with an
unrolled Cholesky. Jacobian columns come from P forward-mode
``torch.func.jvp`` passes with one-hot tangents, as the JAX engine takes
them with ``jax.jvp``.

The LM iteration (:func:`_lm_loop`) takes its model and Jacobian from a
*source*, so :func:`lm_fit` and the generic kernel's plain version
(:mod:`dosma_tpu_torch.ops.generic_lm`, whose source is a dual-number
interpreter) run one loop. Unlike the JAX loop, which keeps polishing
latched voxels until all of them have latched, each voxel here is frozen at
its latch, so its result does not depend on the others.

NaN semantics: all-zero sequences, out-of-bounds inputs, and non-converged
voxels under ``nan_policy="scipy"`` give NaN parameters and r² = 0.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from dosma_tpu_torch.ops.monoexp import _tmean, _tsum

__all__ = ["lm_fit", "batched_polyfit", "r_squared"]


def _chol_solve_unrolled(A, b, P: int):
    """Solve P×P SPD systems stored as per-voxel flat vectors.

    ``A``: dict (i, j) -> (N,) for j <= i (lower triangle with the
    diagonal); ``b``: list of P (N,) vectors. Unrolled Cholesky with pivots
    clamped at 1e-30, then the two substitutions.
    """
    L = {}
    for i in range(P):
        for j in range(i + 1):
            s = A[(i, j)]
            for k in range(j):
                s = s - L[(i, k)] * L[(j, k)]
            if i == j:
                L[(i, j)] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[(i, j)] = s / L[(j, j)]
    z = []
    for i in range(P):
        s = b[i]
        for k in range(i):
            s = s - L[(i, k)] * z[k]
        z.append(s / L[(i, i)])
    delta = [None] * P
    for i in reversed(range(P)):
        s = z[i]
        for k in range(i + 1, P):
            s = s - L[(k, i)] * delta[k]
        delta[i] = s / L[(i, i)]
    return delta


def _lm_loop(source, yT: torch.Tensor, params: Sequence[torch.Tensor], max_iter: int,
             ftol: float, xtol: float, latch_bad_init: bool):
    """The LM iteration on (T, N) ``yT`` from P (N,) seeds.

    ``source.value(params)`` gives the (T, N) model; ``source.value_and_jacobian
    (params)`` the model and its P (T, N) Jacobian columns. Strict ``<``
    accept; λ ×0.33 (floor 1e-12) on accept, ×3 (cap 1e10) on reject; a
    voxel latches on an accepted step with a small relative decrease or
    step, on a small step at λ ≤ 1e-2, or on a rejection at λ ≥ 1e2, and is
    then frozen. A voxel whose initial cost is not finite starts from cost
    +inf, and with ``latch_bad_init`` (the generic kernel's rule) latches at
    once; without it (``lm_fit``'s rule) it iterates like any other.

    Returns (params list, latched (N,) bool, bad_init (N,) bool).
    """
    P = len(params)
    params = list(params)

    def cost_of(ps):
        r = source.value(ps) - yT
        c = _tsum(r * r)
        return torch.where(torch.isfinite(c), c, torch.inf)

    cost = cost_of(params)
    bad_init = ~torch.isfinite(cost)
    lam = torch.full_like(cost, 1e-3)
    latched = bad_init.clone() if latch_bad_init else torch.zeros_like(bad_init)
    for _ in range(max_iter):
        active = ~latched
        if not bool(active.any()):
            break
        f, cols = source.value_and_jacobian(params)
        r = f - yT
        A = {}
        for i in range(P):
            for j in range(i + 1):
                A[(i, j)] = _tsum(cols[i] * cols[j])
        g = [_tsum(cols[i] * r) for i in range(P)]
        for i in range(P):
            A[(i, i)] = A[(i, i)] + lam * torch.clamp(A[(i, i)], min=1e-12)

        delta = _chol_solve_unrolled(A, g, P)
        new_params = [params[i] - delta[i] for i in range(P)]
        new_cost = cost_of(new_params)

        accept = new_cost < cost
        rel_decrease = (cost - new_cost) <= ftol * torch.clamp(cost, min=1e-30)
        step_ratio = torch.zeros_like(cost)
        for i in range(P):
            step_ratio = torch.maximum(
                step_ratio, torch.abs(delta[i]) / torch.clamp(torch.abs(params[i]), min=1e-12)
            )
        small_step = step_ratio <= xtol
        gn_small = small_step & (lam <= 1e-2)
        at_floor = ~accept & (lam >= 1e2)
        newly = (accept & (rel_decrease | small_step)) | gn_small | at_floor

        take = active & accept
        params = [torch.where(take, new_params[i], params[i]) for i in range(P)]
        cost = torch.where(take, new_cost, cost)
        new_lam = torch.where(
            accept, torch.clamp(lam * 0.33, min=1e-12), torch.clamp(lam * 3.0, max=1e10)
        )
        lam = torch.where(active, new_lam, lam)
        latched = latched | (active & newly)
    return params, latched, bad_init


def _finish(source, yT, params, latched, bad_init):
    """Packed (P + 2, N) rows [params..., r2, converged] after the loop."""
    finite = torch.ones_like(latched)
    for p in params:
        finite = finite & torch.isfinite(p)
    converged = (latched & finite & ~bad_init).to(yT.dtype)
    r = source.value(params) - yT
    ss_res = _tsum(r * r)
    d = yT - _tmean(yT)
    ss_tot = _tsum(d * d)
    r2 = 1.0 - ss_res / (ss_tot + 1e-8)
    return torch.stack(list(params) + [r2, converged], dim=0)


def _apply_nan_policy(rows, yT, nparams, y_bounds, nan_policy):
    """(popt (N, P), r2 (N,), converged (N,)) from packed rows, with the
    invalid-input and non-convergence NaN policy applied."""
    popt = rows[:nparams].T
    r2 = rows[nparams]
    converged = rows[nparams + 1] > 0.5
    invalid = (yT == 0).all(0)
    if y_bounds is not None:
        lo, hi = y_bounds
        invalid = invalid | ((yT < lo) | (yT > hi)).any(0)
    bad = invalid | ~converged if nan_policy == "scipy" else invalid
    popt = torch.where(bad[:, None], torch.nan, popt)
    r2 = torch.where(bad, 0.0, r2)
    return popt, r2, converged


def _seed_columns(p0, N: int, dtype, device) -> Tuple[int, list]:
    """P (N,) seed vectors from (P,) or (N, P) ``p0``."""
    p0 = torch.as_tensor(p0, dtype=dtype, device=device)
    if p0.ndim == 1:
        return p0.shape[0], [p0[i].expand(N).clone() for i in range(p0.shape[0])]
    if p0.ndim != 2 or p0.shape[0] != N:
        raise ValueError(f"p0 must be (P,) or ({N}, P), got {tuple(p0.shape)}")
    return p0.shape[1], [p0[:, i].clone() for i in range(p0.shape[1])]


class _JvpSource:
    """Model values and Jacobian columns of ``model_fn(x_col, params)``:
    P forward-mode passes with one-hot tangents."""

    def __init__(self, model_fn: Callable, x_col: torch.Tensor, shape):
        self.model_fn = model_fn
        self.x_col = x_col
        self.shape = shape

    def value(self, params):
        return torch.broadcast_to(self.model_fn(self.x_col, tuple(params)), self.shape)

    def value_and_jacobian(self, params):
        params = tuple(params)
        f, cols = None, []
        for i in range(len(params)):
            tangents = tuple(
                torch.ones_like(p) if j == i else torch.zeros_like(p) for j, p in enumerate(params)
            )
            fi, col = torch.func.jvp(
                lambda *ps: self.model_fn(self.x_col, ps), params, tangents
            )
            f = fi if f is None else f
            cols.append(torch.broadcast_to(col, self.shape))
        return torch.broadcast_to(f, self.shape), cols


def lm_fit(
    model_fn: Callable,
    x,
    y,
    p0,
    max_iter: int = 50,
    ftol: float = 1e-5,
    xtol: float = 1e-5,
    y_bounds: Optional[Tuple[float, float]] = None,
    nan_policy: str = "scipy",
):
    """Batched Levenberg–Marquardt fit on ``y``'s device.

    Args:
        model_fn: ``f(x_col, params)`` with ``x_col`` (T, 1) and ``params`` a
            tuple of P (N,) tensors → (T, N), written in torch ops that
            ``torch.func.jvp`` can differentiate.
        x: (T,) independent variable.
        y: (N, T) data (one row per voxel): a tensor on any device or a
            numpy array (fit on the CPU).
        p0: (N, P) or (P,) initial guesses.
        max_iter: maximum LM iterations (analog of scipy ``maxfev``).
        ftol: relative cost-decrease convergence tolerance.
        xtol: relative step-size convergence tolerance.
        y_bounds: optional (lo, hi); sequences with any observation outside
            are not fit (NaN params, r² = 0).
        nan_policy: ``"scipy"`` → non-converged voxels get NaN params and
            r² = 0; ``"keep"`` → best-effort params for all voxels.

    Returns:
        (popt (N, P), r2 (N,), converged (N,)) tensors on ``y``'s device.
    """
    if not isinstance(y, torch.Tensor):
        y = torch.from_numpy(np.ascontiguousarray(y))
    if y.dtype not in (torch.float32, torch.float64):
        y = y.to(torch.float32)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = torch.as_tensor(np.asarray(x), dtype=y.dtype, device=y.device)
    N, T = y.shape
    yT = y.T
    P, params = _seed_columns(p0, N, y.dtype, y.device)
    source = _JvpSource(model_fn, x[:, None], (T, N))
    params, latched, bad_init = _lm_loop(
        source, yT, params, int(max_iter), float(ftol), float(xtol), latch_bad_init=False
    )
    rows = _finish(source, yT, params, latched, bad_init)
    return _apply_nan_policy(rows, yT, P, y_bounds, nan_policy)


def r_squared(yhat: torch.Tensor, y: torch.Tensor, eps: float = 1e-8, axis: int = 0):
    """Vectorized r² along ``axis``."""
    residuals = yhat - y
    ss_res = torch.sum(residuals**2, dim=axis)
    ss_tot = torch.sum((y - torch.mean(y, dim=axis, keepdim=True)) ** 2, dim=axis)
    return 1 - (ss_res / (ss_tot + eps))


def batched_polyfit(x, y, deg: int):
    """Vandermonde least-squares polyfit of all sequences at once.

    x: (T,), y: (T, N) tensor (on any device). Returns (popts (deg+1, N)
    highest power first, r2 (N,)) in float32 on ``y``'s device. deg == 1
    is the closed-form linear regression; higher degrees solve with
    ``torch.linalg.lstsq``.
    """
    if not isinstance(y, torch.Tensor):
        y = torch.from_numpy(np.ascontiguousarray(y))
    y = y.to(torch.float32)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32, device=y.device)

    if deg == 1:
        x_mean = torch.mean(x)
        xc = x - x_mean
        sxx = torch.sum(xc * xc)
        y_mean = torch.mean(y, dim=0)
        # xc sums to zero, so xc @ (y - y_mean) == xc @ y.
        slope = torch.matmul(xc, y) / sxx
        intercept = y_mean - slope * x_mean
        popts = torch.stack([slope, intercept], dim=0)
        yhat = x[:, None] * slope[None, :] + intercept[None, :]
        return popts, r_squared(yhat, y, axis=0)

    V = torch.stack([x**i for i in range(deg, -1, -1)], dim=-1)  # (T, deg+1)
    popts = torch.linalg.lstsq(V, y).solution  # (deg+1, N)
    yhat = torch.matmul(V, popts)
    return popts, r_squared(yhat, y, axis=0)
