"""The port's B-spline (FFD) stage against ``dosma_tpu``'s.

The same numpy inputs go through both packages on the CPU. Tolerances:

- ``make_control_grid`` and ``_bspline_stage_plan``: equal;
- ``bspline_displacement`` values and its gradient with respect to the
  control grid (``torch.autograd`` against ``jax.grad`` of the same sum):
  1e-5 relative, with K both under and over the 65,536-point slab size;
- ``subdivide_control_grid`` and ``bending_energy`` with its gradient:
  1e-6 relative;
- ``register_pair_bspline`` with JAX's draws injected into
  ``_bspline_draws``: the displacement fields at interior points within
  1e-3 mm, the loss traces within 1e-4 relative;
- the mixed ``warp_volume_chain`` at orders 0, 1 and 3: every voxel within
  1e-5 · max(1, |v|);
- recovery of a known FFD warp by the port alone (no injection): the
  interior displacement error under half a voxel on average, as
  ``tests/core/test_registration_recovery.py`` holds ``dosma_tpu``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dosma_tpu.ops import bspline as jbs
from dosma_tpu.ops import registration as jreg
from dosma_tpu_torch.ops import bspline as tbs
from dosma_tpu_torch.ops import registration as treg
from dosma_tpu_torch.ops import warp as twarp


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU, on one thread: their tensors are a few
    thousand elements, and the workers of a parallel run share the cores."""
    from dosma_tpu_torch.core.device import default_device

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with default_device("cpu"):
            yield
    finally:
        torch.set_num_threads(threads)


SHAPE = (32, 28, 12)
SPACING = (0.5, 0.6, 2.0)


def _affine(spacing=SPACING, origin=(-12.0, 8.0, -20.0)):
    aff = np.diag([*spacing, 1.0])
    aff[:3, 3] = origin
    return aff


def _blobs(shape=SHAPE, seed=1, n=24):
    rs = np.random.RandomState(seed)
    img = np.zeros(shape, np.float32)
    grid = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]].astype(np.float32)
    for _ in range(n):
        c = rs.rand(3) * (np.array(shape) - 1)
        s = 2 + rs.rand(3) * 4
        img += rs.rand() * np.exp(-(((grid[0] - c[0]) / s[0]) ** 2 + ((grid[1] - c[1]) / s[1]) ** 2
                                    + ((grid[2] - c[2]) / s[2]) ** 2))
    return img


def _rel_close(got, ref, rtol, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= rtol, f"{name}: relative error {err} > {rtol}"


def _jax_draws(seed, stage, iterations, num_samples, device):
    """dosma_tpu's per-stage draws (``_optimize_bspline_chain``), for the port."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), stage)
    u = jax.random.uniform(key, (iterations, 3, num_samples))
    return torch.from_numpy(np.array(u)).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(treg, "_bspline_draws", _jax_draws)


def _ctrl(grid_shape, seed, amp=2.0):
    rs = np.random.RandomState(seed)
    return ((rs.rand(3, *grid_shape) - 0.5) * 2 * amp).astype(np.float32)


# ----------------------------------------------------------------------
# The FFD model
# ----------------------------------------------------------------------
@pytest.mark.parametrize("shape,spacing,mm,vox", [
    (SHAPE, SPACING, 16.0, None),
    ((48, 48, 24), (0.5, 0.6, 2.0), 32.0, None),
    ((20, 9, 5), (1.0, 1.0, 1.0), 3.0, None),
    (SHAPE, SPACING, 16.0, 5.0),
    (SHAPE, SPACING, 16.0, (3.0, 7.5, 1.0)),
])
def test_make_control_grid_matches_jax(shape, spacing, mm, vox):
    A = _affine(spacing)
    gs_t, sp_t = tbs.make_control_grid(shape, A, mm, vox)
    gs_j, sp_j = jbs.make_control_grid(shape, A, mm, vox)
    assert gs_t == gs_j
    np.testing.assert_array_equal(sp_t, sp_j)


@pytest.mark.parametrize("K", [3000, 65536 + 4321], ids=["dense", "slabs"])
def test_bspline_displacement_and_gradient_match_jax(K):
    grid_shape, sp = jbs.make_control_grid(SHAPE, _affine(), 8.0)
    ctrl = _ctrl(grid_shape, seed=2)
    rs = np.random.RandomState(3)
    # points over the whole grid and beyond its edges (the clipped border)
    pts = np.stack([rs.uniform(-3.0, d + 2.0, K) for d in SHAPE]).astype(np.float32)
    w = rs.randn(3, K).astype(np.float32)
    sp32 = sp.astype(np.float32)

    def jf(c):
        return jnp.sum(jbs.bspline_displacement(c, jnp.asarray(pts), jnp.asarray(sp32)) * w)

    d_j = np.asarray(jbs.bspline_displacement(jnp.asarray(ctrl), jnp.asarray(pts),
                                              jnp.asarray(sp32)))
    g_j = np.asarray(jax.grad(jf)(jnp.asarray(ctrl)))
    ct = torch.from_numpy(ctrl).requires_grad_(True)
    d_t = tbs.bspline_displacement(ct, torch.from_numpy(pts), torch.from_numpy(sp32))
    (g_t,) = torch.autograd.grad(torch.sum(d_t * torch.from_numpy(w)), ct)
    assert d_t.shape == (3, K)
    _rel_close(d_t.detach().numpy(), d_j, 1e-5, "displacement")
    _rel_close(g_t.numpy(), g_j, 1e-5, "gradient")


@pytest.mark.parametrize("src_shape,new_shape", [
    ((5, 6, 4), (7, 9, 5)),       # the plan's usual refinement (2n - 1 or fewer)
    ((4, 4, 4), (9, 8, 4)),       # 9 > 2 * 4 - 1: the extra-replication branch
    ((6, 4, 5), (11, 7, 9)),
])
def test_subdivide_control_grid_matches_jax(src_shape, new_shape):
    ctrl = _ctrl(src_shape, seed=4)
    got = tbs.subdivide_control_grid(torch.from_numpy(ctrl), new_shape).numpy()
    ref = np.asarray(jbs.subdivide_control_grid(jnp.asarray(ctrl), new_shape))
    assert got.shape == ref.shape == (3, *new_shape)
    _rel_close(got, ref, 1e-6, "subdivided grid")


def test_subdivision_keeps_the_field():
    """Refinement by knot insertion represents the same displacement field
    away from the clipped border."""
    grid_shape, sp = tbs.make_control_grid(SHAPE, _affine(), 8.0)
    fine_shape, sp_fine = tbs.make_control_grid(SHAPE, _affine(), None, grid_spacing_vox=sp / 2)
    ctrl = torch.from_numpy(_ctrl(grid_shape, seed=5))
    fine = tbs.subdivide_control_grid(ctrl, fine_shape)
    pts = torch.from_numpy(np.stack(np.mgrid[4:28:3, 4:24:3, 2:10:2]).reshape(3, -1)
                           .astype(np.float32))
    coarse_d = tbs.bspline_displacement(ctrl, pts, sp.astype(np.float32))
    fine_d = tbs.bspline_displacement(fine, pts, sp_fine.astype(np.float32))
    np.testing.assert_allclose(fine_d.numpy(), coarse_d.numpy(), rtol=0, atol=1e-5)


def test_bending_energy_and_gradient_match_jax():
    ctrl = _ctrl((6, 7, 5), seed=6)
    v_j, g_j = jax.value_and_grad(jbs.bending_energy)(jnp.asarray(ctrl))
    ct = torch.from_numpy(ctrl).requires_grad_(True)
    v_t = tbs.bending_energy(ct)
    (g_t,) = torch.autograd.grad(v_t, ct)
    _rel_close(v_t.detach().numpy(), np.asarray(v_j), 1e-6, "energy")
    _rel_close(g_t.numpy(), np.asarray(g_j), 1e-6, "gradient")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(resolutions=2, grid_spacing_mm=8.0, learning_rate=0.05),
    dict(pyramid_schedule=(8.0, 4.0, 2.0, 1.0), grid_spacing_vox=(4.0, 3.0, 2.0)),
])
def test_bspline_stage_plan_matches_jax(kw):
    A = _affine()
    pt = treg._bspline_stage_plan(SHAPE, A, treg.RegistrationParams(transform="bspline", **kw))
    pj = jreg._bspline_stage_plan(SHAPE, A, jreg.RegistrationParams(transform="bspline", **kw))
    shapes_t, spacings_t, sigmas_t, lrs_t = pt
    shapes_j, spacings_j, sigmas_j, lrs_j = pj
    assert shapes_t == shapes_j and sigmas_t == sigmas_j and lrs_t == lrs_j
    for a, b in zip(spacings_t, spacings_j, strict=True):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# The optimization, with dosma_tpu's draws injected
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def deformed_pair():
    """A blob phantom and its warp by a known smooth FFD field."""
    A = _affine()
    fixed = _blobs()
    grid_shape, sp = jbs.make_control_grid(SHAPE, A, 8.0)
    ctrl_true = _ctrl(grid_shape, seed=7, amp=1.5)
    moving = np.asarray(jreg.warp_volume_chain(fixed, [("bspline", ctrl_true, sp)], A, A, SHAPE))
    return fixed, moving, A


_BSPLINE = dict(transform="bspline", resolutions=2, iterations=30, num_samples=1024,
                grid_spacing_mm=8.0, bending_weight=1e-3, learning_rate=0.02)
_EVAL = np.stack(np.mgrid[4:28:3, 4:24:3, 2:10:2]).reshape(3, -1).astype(np.float32)


def _field(ctrl, spacing):
    return np.asarray(jbs.bspline_displacement(jnp.asarray(ctrl, jnp.float32),
                                               jnp.asarray(_EVAL),
                                               jnp.asarray(spacing, jnp.float32)))


@pytest.mark.parametrize("cfg", [
    dict(metric="mse"),
    dict(metric="mi", iteration_schedule=(20, 30), sample_schedule=(512, 1024)),
    dict(metric="mse", interp_order=3, seed=5),
], ids=["mse", "mi_schedules", "mse_cubic"])
def test_register_pair_bspline_matches_jax(deformed_pair, jax_draws, cfg):
    fixed, moving, A = deformed_pair
    mask = (_blobs(seed=9) > 0.15).astype(np.float32)
    pj = jreg.RegistrationParams(**{**_BSPLINE, **cfg})
    pt = treg.RegistrationParams(**{**_BSPLINE, **cfg})
    c_j, s_j, info_j = jreg.register_pair_bspline(fixed, A, moving, A, pj, fixed_mask=mask,
                                                  moving_mask=mask)
    c_t, s_t, info_t = treg.register_pair_bspline(fixed, A, moving, A, pt, fixed_mask=mask,
                                                  moving_mask=mask)
    assert isinstance(c_t, np.ndarray) and c_t.shape == np.asarray(c_j).shape
    np.testing.assert_array_equal(s_t, np.asarray(s_j))
    assert set(info_t) == set(info_j)
    for lt, lj in zip(info_t["losses"], info_j["losses"], strict=True):
        _rel_close(lt, np.asarray(lj), 1e-4, "losses")
    # the fields at interior points, in mm
    err = np.abs(_field(c_t, s_t) - _field(c_j, s_j)).max()
    assert err <= 1e-3, f"displacement fields differ by {err} mm"
    assert np.abs(_field(c_j, s_j)).max() > 0.1  # the stage moved


def test_zero_iteration_stage_passes_the_grid_through(deformed_pair, jax_draws):
    """A 0 in the iteration schedule skips that stage: its grid is only
    subdivided, so the chain equals one without it (the reference's guard
    against the Polyak average's division by zero)."""
    fixed, moving, A = deformed_pair
    p0 = treg.RegistrationParams(**{**_BSPLINE, "metric": "mse",
                                    "iteration_schedule": (0, 30)})
    c0, s0, info = treg.register_pair_bspline(fixed, A, moving, A, p0)
    assert info["losses"][0].shape == (0,) and info["losses"][1].shape == (30,)
    cj, sj, _ = jreg.register_pair_bspline(
        fixed, A, moving, A, jreg.RegistrationParams(**{**_BSPLINE, "metric": "mse",
                                                         "iteration_schedule": (0, 30)}))
    assert np.abs(_field(c0, s0) - _field(cj, sj)).max() <= 1e-3
    # all stages at 0: the zero grid comes back
    pz = dataclasses.replace(p0, iteration_schedule=(0, 0))
    cz, _, _ = treg.register_pair_bspline(fixed, A, moving, A, pz)
    assert not cz.any()


# ----------------------------------------------------------------------
# The mixed chain warp
# ----------------------------------------------------------------------
@pytest.mark.parametrize("order", [0, 1, 3])
def test_mixed_warp_volume_chain_matches_jax(deformed_pair, order):
    fixed, moving, A = deformed_pair
    A_m = _affine(spacing=(0.6, 0.5, 2.2), origin=(-13.0, 7.5, -19.0))
    grid_shape, sp = jbs.make_control_grid(SHAPE, A, 8.0)
    cw = (A @ np.r_[(np.array(SHAPE) - 1) / 2.0, 1.0])[:3]
    a = np.deg2rad(3.0)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = cw - R @ cw + np.array([0.7, -0.4, 0.5])
    stages = [("matrix", M), ("bspline", _ctrl(grid_shape, seed=8, amp=1.0), sp),
              ("matrix", np.linalg.inv(M))]
    got = treg.warp_volume_chain(moving, stages, A, A_m, SHAPE, order=order)
    ref = np.asarray(jreg.warp_volume_chain(moving, stages, A, A_m, SHAPE, order=order))
    assert isinstance(got, np.ndarray) and got.shape == SHAPE
    assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(ref).max()), order


def test_mixed_chain_runs_in_chunks(deformed_pair, monkeypatch):
    """Chunks of the fixed grid give the same volume as one pass, and no
    warp-kernel launch (the point samplers, as in dosma_tpu)."""
    fixed, moving, A = deformed_pair
    grid_shape, sp = tbs.make_control_grid(SHAPE, A, 8.0)
    stages = [("bspline", _ctrl(grid_shape, seed=10, amp=1.0), sp)]
    whole = treg.warp_volume_chain(moving, stages, A, A, SHAPE, order=3)
    monkeypatch.setattr(treg, "_CHAIN_CHUNK", 1000)  # 11 chunks, the last partial
    before = twarp.warp_grid.launches
    chunked = treg.warp_volume_chain(moving, stages, A, A, SHAPE, order=3)
    assert twarp.warp_grid.launches == before
    np.testing.assert_array_equal(chunked, whole)
    t = treg.warp_volume_chain(torch.from_numpy(moving), stages, A, A, SHAPE, order=1)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32


# ----------------------------------------------------------------------
# Recovery (the port alone)
# ----------------------------------------------------------------------
def test_recovers_a_known_ffd_warp():
    """``tests/core/test_registration_recovery.py``'s case (48x48x24, a
    +-2 mm field on a 16 mm grid, MSE), at 2 levels of 150 iterations."""
    shape = (48, 48, 24)
    A = _affine()
    phantom = _blobs(shape, seed=1, n=40)
    grid_shape, sp = tbs.make_control_grid(shape, A, 16.0)
    ctrl_true = _ctrl(grid_shape, seed=3, amp=2.0)
    moving = treg.warp_volume_chain(phantom, [("bspline", ctrl_true, sp)], A, A, shape)
    params = treg.RegistrationParams(transform="bspline", metric="mse", resolutions=2,
                                     iterations=150, num_samples=2048, grid_spacing_mm=16.0,
                                     bending_weight=1e-3)
    ctrl, spv, info = treg.register_pair_bspline(phantom, A, moving, A, params)
    pts = torch.from_numpy(np.stack(np.mgrid[8:40:4, 8:40:4, 4:20:2]).reshape(3, -1)
                           .astype(np.float32))
    d_true = tbs.bspline_displacement(torch.from_numpy(ctrl_true), pts, sp.astype(np.float32))
    d_est = tbs.bspline_displacement(torch.from_numpy(ctrl), pts, spv.astype(np.float32))
    # the stage estimates the inverse field: d_est ~= -d_true
    err_mm = torch.linalg.norm(d_est + d_true, dim=0).numpy()
    assert err_mm.mean() < 0.5 * min(SPACING), f"mean FFD error {err_mm.mean():.3f} mm"
    assert not info["stalled"]
    back = treg.warp_volume_chain(moving, [("bspline", ctrl, spv)], A, A, shape)
    interior = (slice(6, -6), slice(6, -6), slice(3, -3))
    before = np.sqrt(np.mean((moving - phantom)[interior] ** 2))
    after = np.sqrt(np.mean((back - phantom)[interior] ** 2))
    assert after < before / 2.5, (before, after)
