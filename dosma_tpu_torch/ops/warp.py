"""Full-grid warps of same-grid volumes under an index-space affine.

Counterpart of ``dosma_tpu/ops/warp_pallas.py``: the final resample of
registration and of ``apply_warp``. Output point (i, j, k) takes the moving
coordinate ``B[:, :3] @ (i, j, k) + B[:, 3]`` and samples every volume of
the stack there:

- order 1: trilinear on the raw volume, each corner outside contributing 0
  (``map_coordinates(mode="constant")``), no clip and no mask;
- order 3: cubic B-spline on the prefiltered coefficients
  (:func:`dosma_tpu_torch.ops.interp.cubic_coeffs`, plain torch, as the
  prefilter is XLA work in ``dosma_tpu``), coordinates clipped to
  ``[0, D-1]``, 0 outside ``[-1e-3, D-1+1e-3]``.

:func:`warp_grid` launches the hand-written kernel ``csrc/warp_grid.cu`` for
CUDA tensors (a build or launch failure raises) and computes
:func:`warp_grid_reference`, the plain version with explicit gathers, for
CPU tensors. Unlike the TPU kernel there is no limit of 8 volumes, no
transform-span gate and no tiling constraint on the output shape: any B and
any shape go to the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

from dosma_tpu_torch.ops.interp import (
    _PAD,
    _clip_to_domain,
    _cubic_gather,
    _in_domain,
    _trilinear_gather,
    cubic_coeffs_batch,
)

__all__ = ["warp_grid", "warp_grid_reference", "warp_grid_batched", "prepare_sources"]

_POINT_CHUNK = 1 << 20  # grid points per pass of the plain version


def prepare_sources(vols: torch.Tensor, order: int) -> torch.Tensor:
    """Kernel operands from raw (NB, D0, D1, D2) volumes: the volumes
    themselves for order 1, their padded B-spline coefficients for order 3."""
    vols = vols.to(torch.float32)
    if order == 3:
        return cubic_coeffs_batch(vols)
    return vols.contiguous()


def _source_dims(srcs: torch.Tensor, order: int):
    pad = 2 * _PAD if order == 3 else 0
    return [int(s) - pad for s in srcs.shape[1:]]


def _groups_of(B: torch.Tensor, nb: int) -> torch.Tensor:
    """B as (G, 3, 4) with G dividing ``nb``: group g warps volumes
    ``g*nb/G .. (g+1)*nb/G - 1``."""
    if B.ndim == 2:
        B = B[None]
    B = B[:, :3, :4].to(torch.float32)
    if B.shape[0] == 0 or nb % B.shape[0]:
        raise ValueError(f"{B.shape[0]} transforms do not divide {nb} volumes into groups")
    return B


def _in_domain_hi(dims) -> list:
    """Order 3's inclusive upper limits (D-1) + 1e-3, rounded to float32."""
    return [float(np.float32((d - 1) + 1e-3)) for d in dims]


# ----------------------------------------------------------------------
# Plain PyTorch version (the kernel's reference, and the CPU path)
# ----------------------------------------------------------------------
def _grid_coords(b: torch.Tensor, start: int, stop: int, out_shape) -> torch.Tensor:
    """Moving coordinates (3, n) of flat output points ``start .. stop-1``,
    in the kernel's operation order."""
    _o0, o1, o2 = out_shape
    p = torch.arange(start, stop, dtype=torch.int64, device=b.device)
    fk = (p % o2).to(torch.float32)
    r = p // o2
    fj = (r % o1).to(torch.float32)
    fi = (r // o1).to(torch.float32)
    return torch.stack([b[a, 0] * fi + b[a, 1] * fj + b[a, 2] * fk + b[a, 3] for a in range(3)])


def warp_grid_reference(srcs: torch.Tensor, B: torch.Tensor, out_shape: Sequence[int],
                        order: int) -> torch.Tensor:
    """The warp on prepared sources (see :func:`prepare_sources`) in plain
    torch, on any device: the same arithmetic as the kernel, with explicit
    gathers, ``_POINT_CHUNK`` grid points at a time to bound memory."""
    out_shape = tuple(int(s) for s in out_shape)
    nb = int(srcs.shape[0])
    B = _groups_of(B.to(srcs.device), nb)
    per_group = nb // B.shape[0]
    dims = _source_dims(srcs, order)
    npts = int(np.prod(out_shape))
    out = torch.empty((nb, npts), dtype=torch.float32, device=srcs.device)
    zero = torch.zeros((), dtype=torch.float32, device=srcs.device)
    for g in range(B.shape[0]):
        for start in range(0, npts, _POINT_CHUNK):
            stop = min(npts, start + _POINT_CHUNK)
            c = _grid_coords(B[g], start, stop, out_shape)
            if order == 3:
                inside = _in_domain(c, dims, 1e-3)
                c = _clip_to_domain(c, dims)
            for v in range(g * per_group, (g + 1) * per_group):
                if order == 3:
                    vals = torch.where(inside, _cubic_gather(srcs[v], c), zero)
                else:
                    vals = _trilinear_gather(srcs[v], c)
                out[v, start:stop] = vals
    return out.reshape((nb,) + out_shape)


# ----------------------------------------------------------------------
# CUDA kernel
# ----------------------------------------------------------------------
def _kernel_fn():
    from dosma_tpu_torch.ops._build import load_library

    fn = load_library("warp_grid").dosma_warp_grid
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, vp, vp] + [ci] * 9 + [cf] * 3 + [vp]
        fn.restype = ci
    return fn


def _launch(srcs: torch.Tensor, B: torch.Tensor, out_shape, order: int) -> torch.Tensor:
    nb = int(srcs.shape[0])
    B = _groups_of(B.to(srcs.device), nb).contiguous()
    srcs = srcs.contiguous()
    out = torch.empty((nb,) + tuple(out_shape), dtype=torch.float32, device=srcs.device)
    hi = _in_domain_hi(_source_dims(srcs, order))
    fn = _kernel_fn()
    with torch.cuda.device(srcs.device):
        stream = torch.cuda.current_stream().cuda_stream
        warp_grid.launches += 1
        err = fn(srcs.data_ptr(), B.data_ptr(), out.data_ptr(), B.shape[0], nb // B.shape[0],
                 *(int(s) for s in srcs.shape[1:]), *out_shape, int(order), *hi, stream)
    if err != 0:
        raise RuntimeError(
            f"warp_grid kernel launch failed: {torch.cuda.get_device_name(srcs.device)} "
            f"reported CUDA error {err}"
        )
    return out


# ----------------------------------------------------------------------
# Public wrappers
# ----------------------------------------------------------------------
def warp_grid(srcs: torch.Tensor, B: torch.Tensor, out_shape: Sequence[int],
              order: int) -> torch.Tensor:
    """Warp prepared sources (NB, S0, S1, S2) onto ``out_shape``.

    ``B``: (3, 4) or (4, 4) rows of the output-index → moving-index map,
    or (G, 3|4, 4), one per group of NB/G consecutive volumes (each group's
    weights are shared across its volumes). Returns (NB, O0, O1, O2)
    float32 on ``srcs``' device: the kernel for a CUDA tensor, the plain
    version for a CPU tensor.
    """
    if order not in (1, 3):
        raise ValueError(f"warp_grid supports orders 1 and 3, got {order}")
    if srcs.ndim != 4 or srcs.dtype != torch.float32:
        raise ValueError(f"srcs must be (NB, S0, S1, S2) float32, got {tuple(srcs.shape)} "
                         f"{srcs.dtype}")
    out_shape = tuple(int(s) for s in out_shape)
    if srcs.device.type == "cuda":
        return _launch(srcs, B, out_shape, order)
    if srcs.device.type == "cpu":
        return warp_grid_reference(srcs, B, out_shape, order)
    raise ValueError(f"warp_grid runs on cpu or cuda tensors, got {srcs.device}")


warp_grid.launches = 0  # kernel launches; only _launch adds to it


def warp_grid_batched(vols, B, out_shape: Sequence[int], order: int) -> torch.Tensor:
    """Warp a stack of same-grid volumes (NB, D0, D1, D2) onto ``out_shape``
    under ``B`` (see :func:`warp_grid`); order 3 prefilters first."""
    vols = torch.as_tensor(vols)
    B = torch.as_tensor(B, dtype=torch.float32, device=vols.device)
    return warp_grid(prepare_sources(vols, order), B, out_shape, order)
