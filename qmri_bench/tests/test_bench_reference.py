import numpy as np
import pytest
import torch

from qmri_bench.reference.monoexp import fit_rates, relaxation_maps
from qmri_bench.reference.rows import region_rows
from qmri_bench.reference.warp import corner_error_vox, cubic_coefficients, cubic_warp, index_map

FIT = {"bounds": [0, 100], "r2_threshold": 0.9, "decimal_precision": 1}


@pytest.mark.parametrize("x", [[10.0, 20.0, 30.0, 40.0], [1.0, 10.0, 30.0, 60.0]])
def test_noiseless_exponentials_are_recovered(x):
    g = torch.Generator().manual_seed(0)
    tc = torch.rand(5000, generator=g, dtype=torch.float64) * 70 + 10
    a = torch.rand(5000, generator=g, dtype=torch.float64) * 900 + 100
    y = a[None] * torch.exp(-torch.tensor(x, dtype=torch.float64)[:, None] / tc[None])
    fa, fb, r2 = fit_rates(x, y)
    assert torch.allclose(-1.0 / fb, tc, rtol=1e-9)
    assert torch.allclose(fa, a, rtol=1e-9)
    assert torch.allclose(r2, torch.ones_like(r2), atol=1e-12)


def test_map_semantics():
    x = [10.0, 20.0, 30.0, 40.0]
    tc = torch.tensor([5.0, 30.04, 30.06, 150.0, 50.0], dtype=torch.float64)
    y = torch.exp(-torch.tensor(x, dtype=torch.float64)[:, None] / tc[None])
    y[:, 4] = 0.0  # all zero: invalid
    mask = torch.tensor([1, 1, 1, 1, 1])
    out_tc, out_r2 = relaxation_maps(x, y, mask, FIT)
    assert out_tc.tolist() == [5.0, 30.0, 30.1, 0.0, 0.0]  # rounded; 150 out of bounds
    assert out_r2[4] == 0.0
    out_tc, out_r2 = relaxation_maps(x, y, torch.tensor([0, 1, 1, 1, 1]), FIT)
    assert out_tc[0] == 0.0 and out_r2[0] == 0.0


def test_region_rows():
    values = torch.tensor([1.0, 2.0, 3.0, 4.0, float("nan"), 7.0])
    mask = torch.tensor([1, 1, 2, 2, 2, 0])
    rows = region_rows(values, mask, {1: "a", 2: "b"})
    assert [r["Category"] for r in rows] == ["a", "b", "total"]
    assert rows[0] == {"Category": "a", "Mean": 1.5, "Std": 0.5, "Median": 1.5, "# Voxels": 2}
    assert rows[1]["# Voxels"] == 2 and rows[1]["Median"] == 3.5
    assert rows[2]["Mean"] == 2.5 and rows[2]["Median"] == 2.5


def test_cubic_coefficients_interpolate():
    g = torch.Generator().manual_seed(1)
    vol = torch.rand((9, 7, 5), generator=g, dtype=torch.float64)
    identity = np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    out, edge = cubic_warp(vol, identity, vol.shape)
    assert torch.allclose(out, vol, atol=1e-10)
    c = cubic_coefficients(vol)
    # (c[k-1] + 4 c[k] + c[k+1]) / 6 gives the samples back along the last axis inside.
    back = (c[..., :-2] + 4 * c[..., 1:-1] + c[..., 2:]) / 6
    assert not torch.allclose(back, vol[..., 1:-1])  # the filter runs on every axis
    assert not bool(edge.any())
    nudged = identity.copy()
    nudged[0, 3] = -1e-3  # row 0 lands on the domain's edge
    _, edge = cubic_warp(vol, nudged, vol.shape)
    assert bool(edge[0].all()) and not bool(edge[1:].any())


@pytest.mark.parametrize("shift", [(1, -1, 0), (3, -3, 0), (2, 1, -1)])
def test_known_roll(shift):
    g = torch.Generator().manual_seed(2)
    fixed = torch.rand((16, 14, 10), generator=g, dtype=torch.float64)
    moving = torch.roll(fixed, shift, dims=(0, 1, 2))
    affine = np.diag([0.5, 0.5, 1.0, 1.0])
    b = np.concatenate([np.eye(3), np.asarray(shift, float)[:, None]], axis=1)
    matrix = affine @ np.vstack([b, [0, 0, 0, 1]]) @ np.linalg.inv(affine)
    bm = index_map(matrix, affine, affine)
    assert corner_error_vox(bm, fixed.shape, shift) == pytest.approx(0.0, abs=1e-12)
    assert corner_error_vox(bm, fixed.shape, (0, 0, 0)) == pytest.approx(np.linalg.norm(shift))
    out, _ = cubic_warp(moving, bm, fixed.shape)
    inner = tuple(slice(3, n - 3) for n in fixed.shape)
    assert torch.allclose(out[inner], fixed[inner], atol=1e-10)
