"""Gathers of masked voxels for regional analytics (counterpart of
``dosma_tpu/ops/analytics.py``).

A quantitative map on a card is read by region: the masked voxels are
gathered on the card with one torch index gather and only the compressed
vector crosses to the host, never the full map. (The JAX package pads the
index vector to a power of two so that XLA compiles few programs; torch
needs no such buckets.)
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["gather_voxels", "compressed_values"]


def gather_voxels(volume: torch.Tensor, flat_idx) -> torch.Tensor:
    """``volume.reshape(-1)[flat_idx]`` as one gather on ``volume``'s device.

    NaNs in ``volume`` pass through untouched: the caller applies its NaN
    policy to the gathered values.
    """
    flat_idx = torch.as_tensor(flat_idx, dtype=torch.int64, device=volume.device)
    return volume.reshape(-1)[flat_idx]


def compressed_values(volume, indices) -> np.ndarray:
    """``volume[iy, ix, iz]`` as a float64 host vector.

    ``indices`` is the ``(iy, ix, iz)`` tuple of ``np.nonzero(mask)``. A
    numpy volume gathers on the host; a tensor gathers on its device, so
    only ``len(iy)`` values cross to the host.
    """
    iy, ix, iz = indices
    if not isinstance(volume, torch.Tensor):
        return np.asarray(volume[iy, ix, iz], dtype=np.float64)
    _, w, s = volume.shape
    flat = (iy.astype(np.int64) * w + ix.astype(np.int64)) * s + iz.astype(np.int64)
    return gather_voxels(volume, flat).cpu().numpy().astype(np.float64)
