"""Analytic quantitative-MRI maps (counterpart of ``dosma_tpu/ops/qmri.py``).

The qDESS analytic T2 (Sveinsson et al., MRM 2017) and the two-echo
combinations are elementwise, so they are plain torch on the echoes'
device: tensors are computed where they lie and returned there; host
(numpy) echoes are computed on the default device (the first CUDA card
unless the caller asked for another, ``core/device.py``) and returned as
numpy arrays. The operations, their order and float32 follow the JAX
package (which computes float32 whatever the echoes' type), constants
included: each is rounded to float32 first. Rounding to ``decimals`` is
XLA's: ``round_half_even(x * 10**d) * (1 / 10**d)``, the division by a
constant taken as a product with its float32 reciprocal; numpy and
``torch.round(x, decimals=d)`` divide, which differs by an ulp on about a
fifth of the values.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from dosma_tpu_torch.core.device import as_tensor, compute_device

__all__ = ["qdess_t2_map", "rss_combine", "rms_combine", "around"]


def _echoes(echo_1, echo_2):
    """(e1, e2 as float32 tensors on the compute device, whether to return numpy)."""
    device = compute_device(echo_1, echo_2)
    e1, e2 = as_tensor(echo_1, device), as_tensor(echo_2, device)
    host = not isinstance(echo_1, torch.Tensor) and not isinstance(echo_2, torch.Tensor)
    return e1.to(torch.float32), e2.to(torch.float32), host


def around(x: torch.Tensor, decimals: int) -> torch.Tensor:
    """Round half to even at ``decimals`` as the JAX package's ``jnp.around``
    computes it: the scaled value rounded, times the reciprocal of the
    scale in ``x``'s dtype."""
    scale = torch.tensor(10.0 ** decimals, dtype=x.dtype, device=x.device)
    return torch.round(x * scale) * torch.reciprocal(scale)


def _out(t: torch.Tensor, host: bool):
    return t.cpu().numpy() if host else t


def qdess_t2_map(
    echo_1,
    echo_2,
    tr: float,
    te: float,
    tg: float,
    alpha: float,
    gl_area: float,
    t1: float,
    diffusivity: float = 1.25e-9,
    beta: float = 1.2,
    nan_bounds: Optional[Tuple[float, float]] = (0, 100),
    nan_to_num: Optional[float] = 0.0,
    decimals: Optional[int] = 1,
    suppress_fat: bool = False,
    suppress_fluid: bool = False,
):
    """Analytic qDESS T2 map (ms), shaped like ``echo_1``.

    ``tr``/``te``/``t1`` in ms, ``tg`` in microseconds, ``alpha`` in
    degrees, ``gl_area`` the spoiler area. The ratio ``echo_2 / echo_1``
    has its NaN and infinities replaced before the log; the map then has
    them replaced, values outside ``nan_bounds`` set to NaN, NaN replaced by
    ``nan_to_num``, and is rounded to ``decimals`` (half to even); fat and
    fluid suppression compare against the maximum of the whole volume.
    """
    TR = float(tr) * 1e-3
    TE = float(te) * 1e-3
    Tg = float(tg) * 1e-6
    T1 = float(t1) * 1e-3
    alpha_rad = math.radians(float(alpha))

    Gl = gl_area / (Tg * 1e6) * 100
    gamma = 4258 * 2 * math.pi  # rad / (G * s)
    dkL = gamma * Gl * Tg

    decay = math.exp(-TR / T1 - TR * (dkL**2) * diffusivity)
    k = (math.sin(alpha_rad / 2) ** 2) * (1 + decay) / (1 - math.cos(alpha_rad) * decay)
    c1 = (TR - Tg / 3) * (dkL**2) * diffusivity

    e1, e2, host = _echoes(echo_1, echo_2)

    def const(v):  # a 0-dim float32 tensor: every operation rounds like the JAX kernel's
        return torch.tensor(v, dtype=torch.float32, device=e1.device)

    ratio = torch.nan_to_num(e2 / e1)
    t2map = const(-2000.0) * const(TR - TE) / (torch.log(torch.abs(ratio) / const(k)) + const(c1))
    t2map = torch.nan_to_num(t2map)

    if nan_bounds is not None:
        lower, upper = const(nan_bounds[0]), const(nan_bounds[1])
        t2map = torch.where((t2map < lower) | (t2map > upper), const(float("nan")), t2map)
    if nan_to_num is not None:
        fill = float(nan_to_num) if not isinstance(nan_to_num, bool) else 0.0
        t2map = torch.nan_to_num(t2map, nan=fill)
    if decimals is not None:
        t2map = around(t2map, int(decimals))

    if suppress_fat:
        t2map = t2map * (e1 > const(0.15) * torch.max(e1))
    if suppress_fluid:
        vol_null_fluid = e1 - const(beta) * e2
        t2map = t2map * (vol_null_fluid > const(0.1) * torch.max(vol_null_fluid))
    return _out(t2map, host)


def rss_combine(echo_1, echo_2):
    """Root-sum-of-squares of two echoes, float32."""
    e1, e2, host = _echoes(echo_1, echo_2)
    return _out(torch.sqrt(e1 * e1 + e2 * e2), host)


def rms_combine(echo_1, echo_2):
    """Root-mean-square of two echoes, float32."""
    e1, e2, host = _echoes(echo_1, echo_2)
    return _out(torch.sqrt((e1 * e1 + e2 * e2) / 2), host)
