"""Biexponential Levenberg–Marquardt fit: CUDA kernel and plain version.

Counterpart of ``dosma_tpu/ops/biexp_pallas.py``. :func:`biexp_lm` fits
``y = a1 * exp(b1 * x) + a2 * exp(b2 * x)`` per voxel with the contract of
``biexp_lm_pallas``: ``y`` (N, T) → ``(popt (N, 4), r2 (N,), converged
(N,))``. A tensor on a CUDA card goes to the hand-written kernel
(``csrc/biexp_lm.cu``), and a launch error raises; a tensor on the CPU goes
to :func:`biexp_lm_reference`, the plain PyTorch version of the same
algorithm.

The algorithm (both versions): LM on all four parameters with the
closed-form Jacobian ``[e1, a1 x e1, e2, a2 x e2]``, the exponential columns
carried at the accepted parameters, an unrolled 4×4 Cholesky, equal cost
accepted, λ ×0.33 on accept and ×10 on reject (``lm_fit``'s ladder is ×3),
and a latch on the predicted reduction or the step ratio. Each voxel
iterates until its own latch or ``max_iter`` and then stays frozen.
Uniformly spaced echoes with 3 <= T <= 8 build each column as e0 * q^t
(``monoexp._exp_cols``): four exponentials a proposal in the kernel instead
of 2T, a few ulp from exact exponentials; the JAX kernel takes exact ones.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dosma_tpu_torch.ops.monoexp import _detect_uniform_x, _exp_cols, _tmean, _tsum
from dosma_tpu_torch.ops.nlls import _apply_nan_policy
from dosma_tpu_torch.utils.profiling import count

__all__ = ["biexp_lm", "biexp_lm_reference"]

_OUT_ROWS = 6  # [a1, b1, a2, b2, r2, converged]
_MAX_REGISTER_ECHOES = 8  # lm_common.cuh::kMaxRegisterEchoes: the kernel's uniform path ends here


# ----------------------------------------------------------------------
# Plain PyTorch version (the kernel's reference, and the CPU path)
# ----------------------------------------------------------------------
def _packed_reference(x, yT, p0m, max_iter, ftol, xtol, uniform_x) -> torch.Tensor:
    """The fit on (T, N) ``yT`` from (4, N) seeds: packed (6, N) rows.
    ``uniform_x`` builds the exponential columns as e0 * q^t (only for
    3 <= T <= 8, as the kernel does)."""
    uniform_x = bool(uniform_x) and x.shape[0] <= _MAX_REGISTER_ECHOES
    xc = x[:, None]
    a1, b1, a2, b2 = (p0m[i].clone() for i in range(4))

    def cost_at(a1, b1, a2, b2):
        e1, e2 = _exp_cols(b1, x, uniform_x), _exp_cols(b2, x, uniform_x)
        r = a1 * e1 + a2 * e2 - yT
        c = _tsum(r * r)
        return torch.where(torch.isfinite(c), c, torch.inf), e1, e2

    cost, e1, e2 = cost_at(a1, b1, a2, b2)
    bad_init = ~torch.isfinite(cost)
    lam = torch.full_like(cost, 1e-3)
    latched = torch.zeros_like(bad_init)
    for _ in range(max_iter):
        active = ~latched
        if not bool(active.any()):
            break
        r = a1 * e1 + a2 * e2 - yT
        j2 = a1 * (xc * e1)
        j4 = a2 * (xc * e2)
        A11, A21, A22 = _tsum(e1 * e1), _tsum(j2 * e1), _tsum(j2 * j2)
        A31, A32, A33 = _tsum(e2 * e1), _tsum(e2 * j2), _tsum(e2 * e2)
        A41, A42, A43, A44 = _tsum(j4 * e1), _tsum(j4 * j2), _tsum(j4 * e2), _tsum(j4 * j4)
        g1, g2, g3, g4 = _tsum(e1 * r), _tsum(j2 * r), _tsum(e2 * r), _tsum(j4 * r)
        A11 = A11 + lam * torch.clamp(A11, min=1e-12)
        A22 = A22 + lam * torch.clamp(A22, min=1e-12)
        A33 = A33 + lam * torch.clamp(A33, min=1e-12)
        A44 = A44 + lam * torch.clamp(A44, min=1e-12)

        tiny = 1e-30
        l11 = torch.sqrt(torch.clamp(A11, min=tiny))
        i11 = 1.0 / l11
        l21, l31, l41 = A21 * i11, A31 * i11, A41 * i11
        l22 = torch.sqrt(torch.clamp(A22 - l21 * l21, min=tiny))
        i22 = 1.0 / l22
        l32 = (A32 - l31 * l21) * i22
        l42 = (A42 - l41 * l21) * i22
        l33 = torch.sqrt(torch.clamp(A33 - l31 * l31 - l32 * l32, min=tiny))
        i33 = 1.0 / l33
        l43 = (A43 - l41 * l31 - l42 * l32) * i33
        l44 = torch.sqrt(torch.clamp(A44 - l41 * l41 - l42 * l42 - l43 * l43, min=tiny))
        i44 = 1.0 / l44
        z1 = g1 * i11
        z2 = (g2 - l21 * z1) * i22
        z3 = (g3 - l31 * z1 - l32 * z2) * i33
        z4 = (g4 - l41 * z1 - l42 * z2 - l43 * z3) * i44
        d4 = z4 * i44
        d3 = (z3 - l43 * d4) * i33
        d2 = (z2 - l32 * d3 - l42 * d4) * i22
        d1 = (z1 - l21 * d2 - l31 * d3 - l41 * d4) * i11

        na1, nb1, na2, nb2 = a1 - d1, b1 - d2, a2 - d3, b2 - d4
        new_cost, ne1, ne2 = cost_at(na1, nb1, na2, nb2)

        accept = (new_cost <= cost) & torch.isfinite(new_cost)
        pred = d1 * g1 + d2 * g2 + d3 * g3 + d4 * g4
        rel_decrease = pred <= ftol * torch.clamp(cost, min=1e-30)

        def ratio(d, p):
            return torch.abs(d) / torch.clamp(torch.abs(p), min=1e-12)

        step_ratio = torch.maximum(
            torch.maximum(ratio(d1, a1), ratio(d2, b1)),
            torch.maximum(ratio(d3, a2), ratio(d4, b2)),
        )
        newly = rel_decrease | (step_ratio <= xtol)

        take = active & accept
        a1, b1 = torch.where(take, na1, a1), torch.where(take, nb1, b1)
        a2, b2 = torch.where(take, na2, a2), torch.where(take, nb2, b2)
        e1, e2 = torch.where(take, ne1, e1), torch.where(take, ne2, e2)
        cost = torch.where(take, new_cost, cost)
        new_lam = torch.where(
            accept, torch.clamp(lam * 0.33, min=1e-12), torch.clamp(lam * 10.0, max=1e10)
        )
        lam = torch.where(active, new_lam, lam)
        latched = latched | (active & newly)

    r = a1 * e1 + a2 * e2 - yT
    ss_res = _tsum(r * r)
    d = yT - _tmean(yT)
    ss_tot = _tsum(d * d)
    r2 = 1.0 - ss_res / (ss_tot + 1e-8)
    finite = torch.isfinite(a1) & torch.isfinite(b1) & torch.isfinite(a2) & torch.isfinite(b2)
    converged = (latched & finite & ~bad_init).to(torch.float32)
    return torch.stack([a1, b1, a2, b2, r2, converged], dim=0)


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------
def _kernel_fn():
    from dosma_tpu_torch.ops._build import load_library

    fn = load_library("biexp_lm").dosma_biexp_lm
    if fn.argtypes is None:
        vp, ll, ci, cf = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, ll, ll, vp, ll, ll, vp, ll, ci, ci, cf, cf, ci, vp]
        fn.restype = ci
    return fn


def _packed_kernel(x, yT, p0, max_iter, ftol, xtol, uniform_x) -> torch.Tensor:
    """Launch ``csrc/biexp_lm.cu`` on the current stream: packed (6, N).

    ``p0`` is (4,) (one seed for every voxel) or (N, 4), read in place.
    ``uniform_x`` takes the e0 * q^t columns (see :func:`_uniform_path`).
    """
    T, N = yT.shape
    out = torch.empty((_OUT_ROWS, N), dtype=torch.float32, device=yT.device)
    fn = _kernel_fn()
    if p0.ndim == 1:
        p0_sp, p0_sn = p0.stride(0), 0
    else:
        p0_sp, p0_sn = p0.stride(1), p0.stride(0)
    with torch.cuda.device(yT.device):
        stream = torch.cuda.current_stream().cuda_stream
        count("biexp_lm.launches")
        err = fn(
            x.data_ptr(), yT.data_ptr(), yT.stride(0), yT.stride(1),
            p0.data_ptr(), p0_sp, p0_sn, out.data_ptr(), N, T,
            int(max_iter), float(ftol), float(xtol), int(bool(uniform_x)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"biexp_lm kernel launch failed: {torch.cuda.get_device_name(yT.device)} "
            f"reported CUDA error {err}"
        )
    return out


def _reference_rows(x, yT, p0, max_iter, ftol, xtol, uniform_x) -> torch.Tensor:
    N = yT.shape[1]
    p0m = p0[:, None].expand(4, N) if p0.ndim == 1 else p0.T
    return _packed_reference(x, yT, p0m, max_iter, ftol, xtol, uniform_x)


def _uniform_path(x) -> bool:
    """True when both versions build the columns as e0 * q^t: uniformly
    spaced echoes, 3 <= T <= 8 (beyond 8 the kernel rebuilds each column
    from its rate, so both take exact exponentials)."""
    return _detect_uniform_x(x) and np.asarray(x).size <= _MAX_REGISTER_ECHOES


# ----------------------------------------------------------------------
# Public wrappers
# ----------------------------------------------------------------------
def _fit(packed: Optional[Callable], x, y, p0, max_iter, ftol, xtol, y_bounds, nan_policy,
         y_layout):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()  # (T,) echo times: a few bytes
    x_host = np.asarray(x, np.float32)

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
            packed = _reference_rows
        else:
            raise ValueError(f"biexp_lm runs on cpu or cuda tensors, got {device}")
    T, N = yT.shape

    p0_t = torch.as_tensor(p0, dtype=torch.float32, device=device)
    if tuple(p0_t.shape) not in ((4,), (N, 4)):
        raise ValueError(f"p0 must be (4,) or ({N}, 4), got {tuple(p0_t.shape)}")

    if N == 0:
        out = torch.empty((_OUT_ROWS, 0), dtype=torch.float32, device=device)
    else:
        x_dev = torch.as_tensor(x_host, device=device)
        out = packed(x_dev, yT, p0_t, int(max_iter), float(ftol), float(xtol),
                     _uniform_path(x_host))

    return _apply_nan_policy(out, yT, 4, y_bounds, nan_policy)


def biexp_lm(
    x,
    y,
    p0,
    max_iter: int = 50,
    ftol: float = 1e-5,
    xtol: float = 1e-5,
    y_bounds: Optional[Tuple[float, float]] = None,
    nan_policy: str = "scipy",
    y_layout: str = "nt",
):
    """Per-voxel biexponential fit ``y = a1 e^{b1 x} + a2 e^{b2 x}``.

    Args:
        x: (T,) sample positions (host array or tensor).
        y: (N, T) data, or (T, N) with ``y_layout="tn"``; a CUDA tensor is
            fit by the kernel, a CPU tensor or numpy array by the plain
            version. Any strides are read in place.
        p0: (4,) or (N, 4) seeds ``[a1, b1, a2, b2]``.
        y_bounds: (lo, hi): voxels with any sample outside → NaN, r2 = 0.
        nan_policy: ``"scipy"`` also sets non-converged voxels to NaN, r2 = 0;
            any other value keeps their parameters.

    Returns:
        (popt (N, 4), r2 (N,), converged (N,) bool), on ``y``'s device.
        All-zero voxels are NaN with r2 = 0.
    """
    return _fit(None, x, y, p0, max_iter, ftol, xtol, y_bounds, nan_policy, y_layout)


def biexp_lm_reference(
    x,
    y,
    p0,
    max_iter: int = 50,
    ftol: float = 1e-5,
    xtol: float = 1e-5,
    y_bounds: Optional[Tuple[float, float]] = None,
    nan_policy: str = "scipy",
    y_layout: str = "nt",
):
    """:func:`biexp_lm` computed by the plain PyTorch version on any device."""
    return _fit(_reference_rows, x, y, p0, max_iter, ftol, xtol, y_bounds, nan_policy, y_layout)
