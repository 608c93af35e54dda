"""Cubic B-spline and nearest-neighbour image interpolation.

Counterpart of ``dosma_tpu/ops/interp.py``, in plain torch (none of it is a
kernel). Elastix resamples its final images with a cubic B-spline
interpolator (``FinalBSplineInterpolationOrder 3``) and may sample its
metric with one (``BSplineInterpolationOrder``):

- :func:`cubic_prefilter`: the Unser recursive B-spline coefficient
  transform along each axis, with the other axes batched (one causal and
  one anticausal sweep per axis, mirror boundary conditions);
- :func:`cubic_coeffs`: the prefilter plus a mirror pad by 2, so that every
  4x4x4 neighbourhood of an in-domain point is in range;
- :func:`cubic_sample_coeffs`: interpolation at fractional coordinates over
  the 4x4x4 coefficient neighbourhood, 64 gathers a point;
- :func:`nearest_sample`: order 0, for labels and masks.

The spline is interpolating: it reproduces the input at integer
coordinates and matches ``scipy.ndimage.map_coordinates(order=3,
mode="mirror")`` in the interior. Everything is differentiable with respect
to the coordinates (the registration metric samples through it).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "cubic_prefilter",
    "cubic_coeffs",
    "cubic_sample",
    "cubic_sample_coeffs",
    "cubic_map_coordinates",
    "nearest_sample",
]

# The single pole of the cubic B-spline direct filter (Unser 1993).
_POLE = float(np.sqrt(3.0) - 2.0)  # ~ -0.26795
# Truncation horizon of the causal-init geometric series: |z|^16 < 1e-9.
_INIT_HORIZON = 16
_PAD = 2
_POINT_CHUNK = 1 << 20  # points per gather pass (bounds the (N,) temporaries)


def _filter_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Cubic B-spline coefficient transform along ``axis``, mirror boundary
    conditions (``scipy.ndimage.spline_filter1d(mode="mirror")``). Every
    step of the two sweeps is one elementwise operation over the other
    axes."""
    z = _POLE
    n = a.shape[axis]
    if n == 1:
        return a
    gain = (1.0 - z) * (1.0 - 1.0 / z)  # = 6.0 for the cubic spline
    a = a * gain

    # Causal init: c+[0] = sum_{k>=0} z^k s~(k) over the mirror-extended
    # signal s~ (period 2n-2), truncated at the horizon. The fold is
    # modular, so short axes (horizon > one period) index the right samples.
    k = np.arange(1, _INIT_HORIZON)
    period = max(2 * (n - 1), 1)
    km = k % period
    idx = torch.as_tensor(np.minimum(km, period - km), device=a.device)
    w = torch.as_tensor((z ** k).astype(np.float32), device=a.device)
    taps = torch.index_select(a, axis, idx).movedim(axis, -1)
    c0 = a.select(axis, 0) + (taps * w).sum(-1)

    # Causal sweep c[k] = a[k] + z c[k-1].
    cp = [c0]
    for i in range(1, n):
        cp.append(a.select(axis, i) + z * cp[-1])
    # Anticausal init (Unser's mirror formula) and backward sweep:
    # d[n-1] = z/(z^2-1) (c[n-1] + z c[n-2]);  d[k] = z (d[k+1] - c[k]).
    d = [None] * n
    d[n - 1] = (z / (z * z - 1.0)) * (cp[n - 1] + z * cp[n - 2])
    for i in range(n - 2, -1, -1):
        d[i] = z * (d[i + 1] - cp[i])
    return torch.stack(d, dim=axis)


def _prefilter_axes(vol: torch.Tensor, axes) -> torch.Tensor:
    vol = vol.to(torch.float32)
    for ax in axes:
        vol = _filter_axis(vol, ax)
    return vol


def cubic_prefilter(vol) -> torch.Tensor:
    """B-spline coefficients of ``vol`` (any rank), filtered along every axis."""
    vol = torch.as_tensor(vol)
    return _prefilter_axes(vol, range(vol.ndim))


def _mirror_index(n: int, pad: int) -> np.ndarray:
    """Source indices of a length-``n`` axis mirror-padded (reflect about
    the edge samples, ``numpy.pad(mode="reflect")``) by ``pad``."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i > n - 1, period - i, i)


def _mirror_pad(vol: torch.Tensor, axes, pad: int = _PAD) -> torch.Tensor:
    for ax in axes:
        idx = torch.as_tensor(_mirror_index(vol.shape[ax], pad), device=vol.device)
        vol = torch.index_select(vol, ax, idx)
    return vol


def cubic_coeffs(vol) -> torch.Tensor:
    """Prefilter and mirror-pad by 2: the sampler's operand.

    Padding up front makes every 4x4x4 neighbourhood of an in-domain point
    interior, so the gathers need no boundary branches.
    """
    vol = torch.as_tensor(vol)
    return _mirror_pad(cubic_prefilter(vol), range(vol.ndim))


def cubic_coeffs_batch(vols: torch.Tensor) -> torch.Tensor:
    """:func:`cubic_coeffs` of each volume of a (NB, D0, D1, D2) stack."""
    return _mirror_pad(_prefilter_axes(vols, (1, 2, 3)), (1, 2, 3))


def _b3(t: torch.Tensor, six: torch.Tensor) -> torch.Tensor:
    """The cubic B-spline kernel B3(t), support |t| < 2.

    ``six`` is 6.0 as a tensor on ``t``'s device: a division by it rounds
    as the CUDA warp kernel's ``/ 6.0f`` does (torch divides a CUDA tensor
    by a Python number as a multiply by its reciprocal).
    """
    at = torch.abs(t)
    at2 = at * at
    near = (4.0 - 6.0 * at2 + 3.0 * (at2 * at)) / six
    u = 2.0 - at
    far = ((u * u) * u) / six
    return torch.where(at < 1.0, near, torch.where(at < 2.0, far, torch.zeros_like(at)))


def _cubic_weights4(t: torch.Tensor, six: torch.Tensor):
    """The four B3 weights at taps floor-1 .. floor+2 for the fractional
    offset t in [0, 1)."""
    return _b3(t + 1.0, six), _b3(t, six), _b3(t - 1.0, six), _b3(t - 2.0, six)


def _cubic_gather(cp: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """64 gathers a point from padded coefficients ``cp`` at clipped
    coordinates ``c`` (3, N): taps ``floor + 1 + a`` of the padded axes,
    summed a-major, weights ``(w0[a] * w1[b]) * w2[d]``."""
    P0, P1, P2 = cp.shape
    flat = cp.reshape(-1)
    six = torch.full((), 6.0, dtype=c.dtype, device=c.device)
    fl = torch.floor(c)
    fr = c - fl
    base = fl.to(torch.int64) + 1
    w0, w1, w2 = (_cubic_weights4(fr[i], six) for i in range(3))
    out = torch.zeros(c.shape[1], dtype=cp.dtype, device=cp.device)
    for a in range(4):
        for b in range(4):
            row = ((base[0] + a) * P1 + (base[1] + b)) * P2 + base[2]
            w01 = w0[a] * w1[b]
            for d in range(4):
                out = out + (w01 * w2[d]) * torch.take(flat, row + d)
    return out


def _trilinear_gather(vol: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Order-1 sample of ``vol`` (D0, D1, D2) at coordinates (3, N), 8
    gathers a point summed a-major with weights ``(wa * wb) * wc``. A corner
    outside the volume contributes 0 (``map_coordinates(mode="constant")``),
    so boundary points keep their partial sums; no clip, no mask."""
    d0, d1, d2 = vol.shape
    flat = vol.reshape(-1)
    fl = torch.floor(c)
    fr = c - fl
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    taps, weights = [], []
    for i, dim in enumerate((d0, d1, d2)):
        axis_taps, axis_w = [], []
        for s in (0, 1):
            at = fl[i] + s
            ok = (at >= 0.0) & (at <= float(dim - 1))
            axis_taps.append((ok, torch.where(ok, at, zero).to(torch.int64)))
            axis_w.append(1.0 - fr[i] if s == 0 else fr[i])
        taps.append(axis_taps)
        weights.append(axis_w)
    out = torch.zeros(c.shape[1], dtype=vol.dtype, device=vol.device)
    for a in (0, 1):
        ok_a, i_a = taps[0][a]
        for b in (0, 1):
            ok_b, i_b = taps[1][b]
            w_ab = weights[0][a] * weights[1][b]
            for k in (0, 1):
                ok_k, i_k = taps[2][k]
                v = torch.take(flat, (i_a * d1 + i_b) * d2 + i_k)
                out = out + torch.where(ok_a & ok_b & ok_k, (w_ab * weights[2][k]) * v, zero)
    return out


def _in_domain(coords: torch.Tensor, dims, tol: float) -> torch.Tensor:
    inside = torch.ones(coords.shape[1], dtype=torch.bool, device=coords.device)
    for i, dim in enumerate(dims):
        inside = inside & (coords[i] >= -tol) & (coords[i] <= (dim - 1) + tol)
    return inside


def _clip_to_domain(coords: torch.Tensor, dims) -> torch.Tensor:
    """Coordinates clipped to ``[0, D-1]``; NaN becomes 0 (such points lie
    outside the domain and are masked to 0, as in the CUDA kernel)."""
    c = torch.stack([torch.clamp(coords[i], 0.0, float(dim - 1)) for i, dim in enumerate(dims)])
    return torch.nan_to_num(c, nan=0.0)


def cubic_sample_coeffs(cp, coords) -> torch.Tensor:
    """Sample PADDED coefficients (from :func:`cubic_coeffs`) at fractional
    index coordinates (3, N).

    Coordinates are clipped to ``[0, D-1]``; points outside the domain by
    more than 1e-3 voxel give 0. The tolerance: warp matrices run
    index → world → index in float32, so a point exactly on the last voxel
    plane can land at D-1 + O(1e-6), and without it the hard cliff zeroes a
    whole boundary slice.
    """
    cp = torch.as_tensor(cp)
    coords = torch.as_tensor(coords, dtype=torch.float32, device=cp.device)
    dims = [s - 2 * _PAD for s in cp.shape]
    inside = _in_domain(coords, dims, 1e-3)
    c = _clip_to_domain(coords, dims)
    n = c.shape[1]
    if n <= _POINT_CHUNK:
        out = _cubic_gather(cp, c)
    else:
        out = torch.cat([_cubic_gather(cp, c[:, s:s + _POINT_CHUNK])
                         for s in range(0, n, _POINT_CHUNK)])
    return torch.where(inside, out, torch.zeros_like(out))


def cubic_sample(coeffs, coords) -> torch.Tensor:
    """Sample the UNPADDED coefficient volume (D0, D1, D2) at coordinates
    (3, N): mirror indexing at the borders, 0 outside ``[0, D-1]``."""
    coeffs = torch.as_tensor(coeffs)
    return cubic_sample_coeffs(_mirror_pad(coeffs, range(3)), coords)


def cubic_map_coordinates(vol, coords) -> torch.Tensor:
    """Prefilter and sample in one call."""
    vol = torch.as_tensor(vol)
    return cubic_sample_coeffs(cubic_coeffs(vol), coords)


def nearest_sample(vol, coords) -> torch.Tensor:
    """Order-0 (nearest-neighbour) sampling, 0 outside ``[0, D-1]`` by more
    than half a voxel: the order elastix uses for labels and masks."""
    vol = torch.as_tensor(vol)
    coords = torch.as_tensor(coords, dtype=torch.float32, device=vol.device)
    d0, d1, d2 = vol.shape
    inside = _in_domain(coords, vol.shape, 0.5)
    i = [torch.clamp(torch.round(coords[a]).to(torch.int64), 0, vol.shape[a] - 1)
         for a in range(3)]
    out = torch.take(vol.reshape(-1), (i[0] * d1 + i[1]) * d2 + i[2])
    return torch.where(inside, out, torch.zeros_like(out))
