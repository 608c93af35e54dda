"""Monoexponential Levenberg–Marquardt fit: CUDA kernel and plain version.

Counterpart of ``dosma_tpu/ops/monoexp_pallas.py``. :func:`monoexp_lm` fits
``y = a * exp(b * x)`` per voxel with the same contract as
``monoexp_lm_pallas``: ``y`` (N, T) → ``(popt (N, 2), r2 (N,), converged
(N,))``. A tensor on a CUDA card goes to the hand-written kernel
(``csrc/monoexp_lm.cu``), and a launch error raises; a tensor on the CPU goes
to :func:`monoexp_lm_reference`, the plain PyTorch version of the same
algorithm. Data on a card is never moved to the host to be fit.

The algorithm (both versions): an optional log-linear seed, then VARPRO —
the amplitude ``a`` is eliminated in closed form and damped exact-Newton
runs on the rate ``b`` alone. Each voxel iterates until its own
convergence latch or ``max_iter``, then stays frozen, so its result does
not depend on its neighbours.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch

__all__ = ["monoexp_lm", "monoexp_lm_reference"]

_OUT_ROWS = 4  # [a, b, r2, converged]


def _detect_uniform_x(x) -> bool:
    """True when ``x`` is a uniformly spaced 1-D grid (>= 3 points)."""
    xv = np.asarray(x, np.float64)
    if xv.ndim != 1 or xv.size < 3:
        return False
    d = np.diff(xv)
    return bool(np.all(np.isfinite(d)) and np.allclose(d, d[0], rtol=1e-5, atol=1e-12))


# ----------------------------------------------------------------------
# Plain PyTorch version (the kernel's reference, and the CPU path)
# ----------------------------------------------------------------------
def _tsum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the echo axis (dim 0) in order t = 0, 1, ..., T-1, as the
    kernel accumulates: with the same order and no fused multiply-add on
    either side, the two versions round every operation alike."""
    s = v[0]
    for t in range(1, v.shape[0]):
        s = s + v[t]
    return s


def _tmean(v: torch.Tensor) -> torch.Tensor:
    """Mean over the echo axis as the kernel takes it: the ordered sum
    divided by T. (The divisor is a tensor on v's device because torch
    turns division by a Python number into a multiplication by its
    reciprocal on CUDA, which rounds differently for T = 3.)"""
    T = torch.tensor(float(v.shape[0]), dtype=v.dtype, device=v.device)
    return _tsum(v) / T


def _exp_cols(b: torch.Tensor, x: torch.Tensor, uniform_x: bool) -> torch.Tensor:
    """(T, N) columns exp(b x_t). Uniform echoes use e_t = e0 * q^t, built
    by repeated multiplication exactly as the kernel does."""
    T = x.shape[0]
    if uniform_x and T > 2:
        cols = [torch.exp(b * x[0])]
        q = torch.exp(b * (x[1] - x[0]))
        for _ in range(T - 1):
            cols.append(cols[-1] * q)
        return torch.stack(cols, dim=0)
    return torch.exp(b[None, :] * x[:, None])


def _reduced_cost(e: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """phi(b) = min_a sum (a e - y)^2 from the actual residuals (not the
    cancellation-prone Y2 - t1^2/s1), and t1 = sum y e."""
    s1 = torch.clamp(_tsum(e * e), min=1e-30)
    t1 = _tsum(y * e)
    a = t1 / s1
    r = a * e - y
    c = _tsum(r * r)
    return torch.where(torch.isfinite(c), c, torch.inf), t1


def _seed_polyfit(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Log-linear seed rate: deg-1 lstsq on log(y), each voxel clamped to
    max(1e-3 of its own peak, 1e-10)."""
    peak = y.amax(0)
    safe = torch.maximum(y, torch.clamp(1e-3 * peak, min=1e-10))
    L = torch.log(safe)
    xm = _tmean(x)
    xc = x - xm
    varx = _tsum(xc * xc)
    Lm = _tmean(L)
    return _tsum(xc[:, None] * (L - Lm)) / varx


def _packed_reference(x, yT, p0b, max_iter, ftol, xtol, uniform_x) -> torch.Tensor:
    """The fit on (T, N) ``yT``: packed (4, N) rows [a, b, r2, converged]."""
    T, N = yT.shape
    b = _seed_polyfit(yT, x) if p0b is None else p0b.expand(N).clone()

    cost0, t1_0 = _reduced_cost(_exp_cols(b, x, uniform_x), yT)
    bad_init = ~(torch.isfinite(cost0) & torch.isfinite(t1_0))

    xx = (x * x)[:, None]
    xc = x[:, None]
    xy = xc * yT
    xxy = xx * yT
    lam = torch.full_like(b, 1e-3)
    latched = bad_init.clone()
    for _ in range(max_iter):
        active = ~latched
        if not bool(active.any()):
            break
        e = _exp_cols(b, x, uniform_x)
        e2 = e * e
        s1 = torch.clamp(_tsum(e2), min=1e-30)
        s2 = _tsum(xc * e2)
        s3 = _tsum(xx * e2)
        u = _tsum(yT * e)
        u1 = _tsum(xy * e)
        u2 = _tsum(xxy * e)
        inv_s1 = 1.0 / s1
        a = u * inv_s1
        r = a * e - yT
        cost = _tsum(r * r)
        cost = torch.where(torch.isfinite(cost), cost, torch.inf)

        g = a * (a * s2 - u1)
        phi2 = 4.0 * a * a * s3 + (
            8.0 * a * s2 * (u1 - a * s2) - 2.0 * (u1 * u1 + u * u2)
        ) * inv_s1
        D = torch.clamp(0.5 * torch.abs(phi2), min=1e-30)
        raw = g / D
        new_b = b - raw / (1.0 + lam)
        new_cost, _ = _reduced_cost(_exp_cols(new_b, x, uniform_x), yT)

        accept = (new_cost <= cost) & torch.isfinite(new_cost)
        rel_decrease = (cost - new_cost) <= ftol * torch.clamp(cost, min=1e-30)
        small_step = torch.abs(raw) <= xtol * torch.clamp(torch.abs(b), min=1e-12)
        pred_small = (D * raw * raw) <= ftol * torch.clamp(cost, min=1e-30)
        at_floor = (~accept) & (lam >= 1e2)
        newly = (accept & rel_decrease) | small_step | pred_small | at_floor

        new_lam = torch.where(
            accept, torch.clamp(lam * 0.33, min=1e-12), torch.clamp(lam * 10.0, max=1e10)
        )
        b = torch.where(active & accept, new_b, b)
        lam = torch.where(active, new_lam, lam)
        latched = latched | (active & newly)

    e = _exp_cols(b, x, uniform_x)
    s1 = torch.clamp(_tsum(e * e), min=1e-30)
    a = _tsum(yT * e) / s1
    finite = torch.isfinite(a) & torch.isfinite(b)
    converged = (latched & finite & ~bad_init).to(torch.float32)
    r = a * e - yT
    ss_res = _tsum(r * r)
    d = yT - _tmean(yT)
    ss_tot = _tsum(d * d)
    r2 = 1.0 - ss_res / (ss_tot + 1e-8)
    return torch.stack([a, b, r2, converged], dim=0)


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------
def _kernel_fn(fmad: bool = False):
    from dosma_tpu_torch.ops._build import load_library

    lib = load_library("monoexp_lm", fmad=fmad)
    fn = lib.dosma_monoexp_lm
    if fn.argtypes is None:
        vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, ll, ll, vp, ll, vp, ll, ci, ci, cf, cf, ci, ci, vp]
        fn.restype = ci
    return fn


def _packed_kernel(x, yT, p0b, max_iter, ftol, xtol, uniform_x, fmad=False) -> torch.Tensor:
    """Launch ``csrc/monoexp_lm.cu`` on the current stream: packed (4, N).

    ``fmad=True`` launches the build with fused multiply-adds (see
    ``_build.load_library``); the fit path never passes it.
    """
    T, N = yT.shape
    out = torch.empty((_OUT_ROWS, N), dtype=torch.float32, device=yT.device)
    fn = _kernel_fn(fmad)
    with torch.cuda.device(yT.device):
        stream = torch.cuda.current_stream().cuda_stream
        monoexp_lm.launches += 1
        err = fn(
            x.data_ptr(), yT.data_ptr(), yT.stride(0), yT.stride(1),
            None if p0b is None else p0b.data_ptr(),
            0 if p0b is None or p0b.numel() == 1 else p0b.stride(0),
            out.data_ptr(), N, T, int(max_iter), float(ftol), float(xtol),
            int(p0b is None), int(bool(uniform_x)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"monoexp_lm kernel launch failed: {torch.cuda.get_device_name(yT.device)} "
            f"reported CUDA error {err}"
        )
    return out


# ----------------------------------------------------------------------
# Public wrappers
# ----------------------------------------------------------------------
def _fit(
    packed: Optional[Callable], x, y, p0, max_iter, ftol, xtol, y_bounds, nan_policy,
    y_layout, uniform_x,
):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()  # (T,) echo times: a few bytes
    x_host = np.asarray(x, np.float32)
    if uniform_x is None:
        uniform_x = _detect_uniform_x(x_host)

    if not isinstance(y, torch.Tensor):
        y = torch.from_numpy(np.ascontiguousarray(y))
    yT = y.T if y_layout != "tn" else y
    if yT.ndim != 2 or yT.shape[0] != x_host.shape[0]:
        raise ValueError(f"y must be (N, {x_host.shape[0]}) for y_layout={y_layout!r}")
    if yT.dtype != torch.float32:
        yT = yT.to(torch.float32)
    device = yT.device
    if packed is None:
        if device.type == "cuda":
            packed = _packed_kernel
        elif device.type == "cpu":
            packed = _packed_reference
        else:
            raise ValueError(f"monoexp_lm runs on cpu or cuda tensors, got {device}")
    T, N = yT.shape

    x_dev = torch.as_tensor(x_host, device=device)
    if p0 is None:
        p0b = None
    else:
        p0_t = torch.as_tensor(p0, dtype=torch.float32, device=device)
        p0b = p0_t[1].reshape(1) if p0_t.ndim == 1 else p0_t[:, 1]
        if p0b.numel() not in (1, N):
            raise ValueError(f"p0 must be (2,) or ({N}, 2), got {tuple(p0_t.shape)}")

    if N == 0:
        out = torch.empty((_OUT_ROWS, 0), dtype=torch.float32, device=device)
    else:
        out = packed(x_dev, yT, p0b, int(max_iter), float(ftol), float(xtol), bool(uniform_x))

    a, b, r2 = out[0], out[1], out[2]
    converged = out[3] > 0.5
    popt = torch.stack([a, b], dim=-1)

    invalid = (yT == 0).all(0)
    if y_bounds is not None:
        lo, hi = y_bounds
        invalid = invalid | ((yT < lo) | (yT > hi)).any(0)
    bad = invalid | ~converged if nan_policy == "scipy" else invalid
    popt = torch.where(bad[:, None], torch.nan, popt)
    r2 = torch.where(bad, 0.0, r2)
    return popt, r2, converged


def monoexp_lm(
    x,
    y,
    p0=None,
    max_iter: int = 50,
    ftol: float = 1e-5,
    xtol: float = 1e-5,
    y_bounds: Optional[Tuple[float, float]] = None,
    nan_policy: str = "scipy",
    y_layout: str = "nt",
    uniform_x=None,
):
    """Per-voxel monoexponential fit ``y = a * exp(b * x)``.

    Args:
        x: (T,) echo times (host array or tensor).
        y: (N, T) data, or (T, N) with ``y_layout="tn"``; a CUDA tensor is
            fit by the kernel, a CPU tensor or numpy array by the plain
            version. Any strides are read in place.
        p0: None seeds from the log-linear polyfit; otherwise (2,) or
            (N, 2) ``[a, b]`` seeds (only ``b`` is used: ``a`` is closed-form).
        y_bounds: (lo, hi): voxels with any echo outside → NaN, r2 = 0.
        nan_policy: ``"scipy"`` also sets non-converged voxels to NaN, r2 = 0;
            any other value keeps their parameters.
        uniform_x: force the uniform-echo path on or off (None detects).

    Returns:
        (popt (N, 2), r2 (N,), converged (N,) bool), on ``y``'s device.
        All-zero voxels are NaN with r2 = 0.
    """
    return _fit(None, x, y, p0, max_iter, ftol, xtol, y_bounds, nan_policy, y_layout, uniform_x)


monoexp_lm.launches = 0  # kernel launches; only _packed_kernel adds to it


def monoexp_lm_reference(
    x,
    y,
    p0=None,
    max_iter: int = 50,
    ftol: float = 1e-5,
    xtol: float = 1e-5,
    y_bounds: Optional[Tuple[float, float]] = None,
    nan_policy: str = "scipy",
    y_layout: str = "nt",
    uniform_x=None,
):
    """:func:`monoexp_lm` computed by the plain PyTorch version on any device."""
    return _fit(
        _packed_reference, x, y, p0, max_iter, ftol, xtol, y_bounds, nan_policy, y_layout,
        uniform_x,
    )
