"""The numbers that decide ``correct``, each computed from the program's
answer and the plain reference; the limits are in ``limits/<cell>.json``.

Maps: ``tc_off_share`` is the share of masked voxels whose time constant
differs from the reference's by more than one rounding step of the
configured decimals (and a float32 ulp); ``r2_off_share`` the share of
voxels whose r-squared differs by more than 1e-5. Shares and not widest
gaps: a voxel whose r-squared lies within float32 rounding of the
threshold may keep its time constant on one side and lose it on the other,
and that is rounding, not a fault. Rows:
``rows_gap`` the widest relative gap of Mean, Std or Median against the
reference's statistics of the program's own map, infinite where a category
or a count differs. Registration: ``warp_gap`` the widest gap of the
resampled volume against the reference's resample under the program's own
transform, over the reference's largest magnitude; ``shift_error_vox`` the
corner error of the transform against the recipe's roll.
"""

from __future__ import annotations

import math

import torch

from qmri_bench.reference.rows import region_rows

__all__ = ["map_numbers", "rows_gap", "merge", "as_flat64"]


def map_numbers(tc, r2, ref_tc, ref_r2, mask_flat, decimals) -> dict:
    """tc_off_share and r2_off_share of one fit's maps (flat float64)."""
    step = 10.0 ** -int(decimals)
    inside = mask_flat.reshape(-1) > 0
    off = (tc - ref_tc).abs() > 1.01 * step + 1e-6 * ref_tc.abs()
    return {
        "tc_off_share": float(off[inside].double().mean()) if bool(inside.any()) else 0.0,
        "r2_off_share": float(((r2 - ref_r2).abs() > 1e-5).double().mean()),
    }


def rows_gap(rows, values_map, mask, labels) -> float:
    """Widest relative gap of ``rows`` against the reference rows of ``values_map``."""
    ref = region_rows(values_map, mask, labels)
    if [r["Category"] for r in rows] != [r["Category"] for r in ref]:
        return math.inf
    worst = 0.0
    for got, want in zip(rows, ref):
        if int(got["# Voxels"]) != int(want["# Voxels"]):
            return math.inf
        for key in ("Mean", "Std", "Median"):
            g, w = float(got[key]), float(want[key])
            if math.isnan(g) and math.isnan(w):
                continue
            worst = max(worst, abs(g - w) / max(abs(w), 1e-30))
    return worst


def merge(per_request) -> dict:
    """The worst of each number over the checked requests (NaN counts as worst)."""
    out = {}
    for numbers in per_request:
        for k, v in numbers.items():
            v = math.inf if v != v else v
            out[k] = max(out.get(k, -math.inf), v)
    return out


def as_flat64(arr, device) -> torch.Tensor:
    """A map (tensor or host array) as a flat float64 tensor on ``device``."""
    return torch.as_tensor(arr).to(device=device, dtype=torch.float64).reshape(-1)
