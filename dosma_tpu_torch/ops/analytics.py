"""Gathers and reductions of masked voxels for regional analytics
(counterpart of ``dosma_tpu/ops/analytics.py``).

A quantitative map on a card is read by region: the masked voxels are
gathered on the card with one torch index gather, and the statistics and
the per-bin means of the tissues' unrolled maps are float64 reductions on
the map's device (a host map's on the CPU). Only the statistics and the
small unrolled tables cross to the host, never the full map. (The JAX
package pads the index vector to a power of two so that XLA compiles few
programs; torch needs no such buckets.)
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from dosma_tpu_torch.core.device import as_tensor

__all__ = [
    "gather_voxels",
    "compressed_values",
    "volume_tensor",
    "flat_indices",
    "summary",
    "scatter_mean",
]


def gather_voxels(volume: torch.Tensor, flat_idx) -> torch.Tensor:
    """``volume.reshape(-1)[flat_idx]`` as one gather on ``volume``'s device.

    NaNs in ``volume`` pass through untouched: the caller applies its NaN
    policy to the gathered values.
    """
    flat_idx = torch.as_tensor(flat_idx, dtype=torch.int64, device=volume.device)
    return volume.reshape(-1)[flat_idx]


def flat_indices(indices, shape) -> np.ndarray:
    """Row-major flat int64 indices of the ``(iy, ix, iz)`` tuple of
    ``np.nonzero`` into a volume of ``shape``."""
    iy, ix, iz = (np.asarray(i, np.int64) for i in indices)
    _, w, s = shape
    return (iy * w + ix) * s + iz


def volume_tensor(volume) -> torch.Tensor:
    """A map's pixels as a tensor where they lie: a host array becomes a CPU
    tensor (no copy), a tensor stays on its device."""
    return as_tensor(volume, volume.device if isinstance(volume, torch.Tensor) else "cpu")


def compressed_values(volume, indices) -> np.ndarray:
    """``volume[iy, ix, iz]`` as a float64 host vector.

    ``indices`` is the ``(iy, ix, iz)`` tuple of ``np.nonzero(mask)``. A
    numpy volume gathers on the host; a tensor gathers on its device, so
    only ``len(iy)`` values cross to the host.
    """
    iy, ix, iz = indices
    if not isinstance(volume, torch.Tensor):
        return np.asarray(volume[iy, ix, iz], dtype=np.float64)
    flat = flat_indices(indices, volume.shape)
    return gather_voxels(volume, flat).cpu().numpy().astype(np.float64)


def summary(values: torch.Tensor, fns: Optional[Dict[str, Callable]] = None) -> dict:
    """Mean / population Std / Median / # Voxels of a 1-D tensor of valid
    values, reduced in float64 on its device (the median is the mean of
    the two middle values for an even count, as ``np.nanmedian``; no
    values give NaN statistics), and each of ``fns`` on the values as a
    host array."""
    n = values.numel()
    row = {"Mean": np.nan, "Std": np.nan, "Median": np.nan}
    if n:
        v = values.to(torch.float64)
        mean = v.mean()
        std = torch.sqrt(((v - mean) ** 2).mean())
        median = torch.sort(values).values[(n - 1) // 2: n // 2 + 1].to(torch.float64).mean()
        row = dict(zip(row, torch.stack([mean, std, median]).tolist()))
    row["# Voxels"] = n
    if fns:
        host = values.cpu().numpy()
        for fname, fn in fns.items():
            row[fname] = fn(host)
    return row


def scatter_mean(keys: torch.Tensor, values: torch.Tensor, nkeys: int) -> np.ndarray:
    """The mean of ``values`` at each key in ``[0, nkeys)``, summed in
    float64 on their device, as a float64 host vector; a key with no value
    gives NaN."""
    sums = torch.zeros(nkeys, dtype=torch.float64, device=values.device)
    sums.index_add_(0, keys, values.to(torch.float64))
    counts = torch.bincount(keys, minlength=nkeys).to(torch.float64)
    return (sums / counts).cpu().numpy()
