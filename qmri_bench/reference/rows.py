"""Plain regional statistics: the reference of ``metric_rows``.

For each label of the mask, and for every voxel of the mask (``total``),
the finite values of the map there: Mean, population Std, Median (the mean
of the two middle values for an even count) and the count, as upstream
DOSMA's ``QuantitativeValue.to_metrics`` gives them.
"""

from __future__ import annotations

import torch

__all__ = ["region_rows"]


def _summary(values: torch.Tensor, dtype) -> dict:
    n = values.numel()
    if not n:
        return {"Mean": float("nan"), "Std": float("nan"), "Median": float("nan"), "# Voxels": 0}
    v = values.to(dtype)
    mean = v.sum() / n
    std = torch.sqrt(((v - mean) ** 2).sum() / n)
    s = torch.sort(v).values
    median = (s[(n - 1) // 2] + s[n // 2]) / 2
    return {"Mean": float(mean), "Std": float(std), "Median": float(median), "# Voxels": n}


def region_rows(values_map: torch.Tensor, mask: torch.Tensor, labels: dict,
                dtype=torch.float64) -> list:
    """Rows of ``values_map`` on ``mask`` (same shape) for ``labels`` ({int: name})
    and ``total``, reduced in ``dtype``."""
    flat = values_map.reshape(-1)
    m = mask.reshape(-1).to(flat.device)
    keep = (m > 0) & torch.isfinite(flat)
    rows = [{"Category": name, **_summary(flat[keep & (m == int(label))], dtype)}
            for label, name in labels.items()]
    rows.append({"Category": "total", **_summary(flat[keep], dtype)})
    return rows
