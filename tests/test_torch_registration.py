"""The port's matrix registration against ``dosma_tpu``'s.

The same numpy inputs go through both packages on the CPU. The random
sample draws differ between ``jax.random`` and ``torch.Generator``, so the
tests that hold an optimization to ``dosma_tpu`` inject JAX's own draws
into the port (``_level_draws``). Tolerances:

- transforms, metrics, samplers and the smoothing pyramid, values and
  gradients: 1e-5 relative (float32 on both sides, summation orders
  differ);
- one Adam step under the cosine schedule against optax: 1e-6 relative;
- ``_pyramid_core`` (2 levels x 20 iterations, injected draws): the loss
  trace within 1e-4 relative, the normalized parameters within 1e-3;
- chains and ``register`` (injected draws): matrices within 1e-3, warped
  volumes within 1e-4 · max|v| where the final warp is order 1 and the
  map is shared;
- transform files written by either package, matrix and B-spline,
  warp identically (1e-5 · max|v|) in the other;
- recovery of a 12° rotation by the port alone: < 0.5 voxel at the
  corners, as ``tests/core/test_registration_recovery.py`` asks of
  ``dosma_tpu``.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import optax

import dosma_tpu
import dosma_tpu_torch as dt
from dosma_tpu.core import registration as jcore
from dosma_tpu.core.io import nifti as jnifti
from dosma_tpu.ops import registration as jreg
from dosma_tpu_torch.core import registration as tcore
from dosma_tpu_torch.core.io import nifti as tnifti
from dosma_tpu_torch.ops import registration as treg
from dosma_tpu_torch.utils.profiling import counters


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU, on one thread: their tensors are small,
    and the workers of a parallel run share the cores."""
    from dosma_tpu_torch.core.device import default_device

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with default_device("cpu"):
            yield
    finally:
        torch.set_num_threads(threads)


SHAPE = (24, 24, 12)
SPACING = (1.0, 1.2, 2.0)


def _affine(spacing=SPACING, origin=(-12.0, 8.0, -20.0)):
    aff = np.diag([*spacing, 1.0])
    aff[:3, 3] = origin
    return aff


def _blobs(shape=SHAPE, seed=1, n=16):
    """Smooth random blob phantom (structure at several scales)."""
    rs = np.random.RandomState(seed)
    img = np.zeros(shape, np.float32)
    grid = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]].astype(np.float32)
    for _ in range(n):
        c = rs.rand(3) * (np.array(shape) - 1)
        s = 2 + rs.rand(3) * 4
        img += rs.rand() * np.exp(-(((grid[0] - c[0]) / s[0]) ** 2 + ((grid[1] - c[1]) / s[1]) ** 2
                                    + ((grid[2] - c[2]) / s[2]) ** 2))
    return img


def _center_world(affine, shape=SHAPE):
    return (affine @ np.r_[(np.array(shape) - 1) / 2.0, 1.0])[:3]


def _rigid_M(deg, shift, affine, shape=SHAPE):
    cw = _center_world(affine, shape)
    a = np.deg2rad(deg)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = cw - R @ cw + np.asarray(shift)
    return M


@pytest.fixture(scope="module")
def pair():
    A = _affine()
    fixed = _blobs()
    M_true = _rigid_M(4.0, (1.0, -0.8, 1.5), A)
    moving = np.array(jreg.warp_volume(fixed, M_true, A, A, SHAPE, order=1))
    return fixed, moving, A


def _jax_draws(seed, level, iterations, num_samples, device):
    """dosma_tpu's per-level draws (``_pyramid_core``), for the port."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), level)
    u = jax.random.uniform(key, (iterations, 3, num_samples))
    return torch.from_numpy(np.array(u)).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(treg, "_level_draws", _jax_draws)


def _rel_close(got, ref, rtol, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= rtol, f"{name}: relative error {err} > {rtol}"


# ----------------------------------------------------------------------
# Transforms, samplers, metrics, smoothing
# ----------------------------------------------------------------------
@pytest.mark.parametrize("transform,theta", [
    ("translation", [1.5, -2.0, 0.3]),
    ("rigid", [0.1, -0.05, 0.2, 1.0, 2.0, -3.0]),
    ("affine", [0.05, -0.02, 0.01, 0.03, -0.04, 0.02, 0.0, 0.01, 0.06, 1.0, -1.0, 2.0]),
])
def test_params_to_matrix_matches_jax(transform, theta):
    theta = np.asarray(theta, np.float32)
    center = np.array([10.0, -5.0, 20.0], np.float32)
    ref = np.asarray(jreg._params_to_matrix(jnp.asarray(theta), jnp.asarray(center), transform))
    got = treg._params_to_matrix(torch.from_numpy(theta), torch.from_numpy(center), transform)
    _rel_close(got.numpy(), ref, 1e-5, transform)
    np.testing.assert_allclose(treg._params_to_matrix_np(theta, center, transform),
                               jreg._params_to_matrix_np(theta, center, transform), rtol=0, atol=0)


def _coords(shape, n, seed):
    rs = np.random.RandomState(seed)
    return np.stack([rs.uniform(-1.2, d + 0.2, n) for d in shape]).astype(np.float32)


def test_trilinear_sample_value_and_gradient_match_jax():
    vol = _blobs((9, 8, 7), seed=2)
    c = _coords(vol.shape, 400, seed=3)
    w = np.random.RandomState(4).randn(400).astype(np.float32)

    def jf(cc):
        return jnp.sum(jreg._trilinear_sample(jnp.asarray(vol), cc) * w)

    jv, jg = jax.value_and_grad(jf)(jnp.asarray(c))
    ct = torch.from_numpy(c).requires_grad_(True)
    tv = torch.sum(treg._trilinear_sample(torch.from_numpy(vol), ct) * torch.from_numpy(w))
    (tg,) = torch.autograd.grad(tv, ct)
    _rel_close(tv.detach().numpy(), np.asarray(jv), 1e-5, "value")
    _rel_close(tg.numpy(), np.asarray(jg), 1e-5, "gradient")


def _metric_inputs(seed=5, n=512):
    rs = np.random.RandomState(seed)
    f = rs.rand(n).astype(np.float32) * 3.0
    m = (0.7 * f + 0.3 * rs.rand(n) + 0.2).astype(np.float32)
    w = (0.01 + 0.99 * (rs.rand(n) > 0.1)).astype(np.float32)
    return f, m, w


@pytest.mark.parametrize("metric", ["mi_cubic", "mi_linear", "mse", "ncc"])
def test_metric_value_and_gradient_match_jax(metric):
    f, m, w = _metric_inputs()
    lims = (float(f.min()), float(f.max()), float(m.min()) - 0.1, float(m.max()) + 0.1)

    def call(mod, fv, mv, wv):
        if metric.startswith("mi"):
            return mod._soft_mi(fv, mv, wv, 32, *lims, kernel=metric[3:])
        return getattr(mod, f"_{metric}")(fv, mv, wv)

    jv, jg = jax.value_and_grad(lambda mv: call(jreg, jnp.asarray(f), mv, jnp.asarray(w)))(
        jnp.asarray(m))
    mt = torch.from_numpy(m).requires_grad_(True)
    tv = call(treg, torch.from_numpy(f), mt, torch.from_numpy(w))
    (tg,) = torch.autograd.grad(tv, mt)
    _rel_close(tv.detach().numpy(), np.asarray(jv), 1e-5, "value")
    _rel_close(tg.numpy(), np.asarray(jg), 1e-5, "gradient")


@pytest.mark.parametrize("sigma,radius", [(0.0, 8), (1.0, 8), (2.0, 8), (3.5, 11)])
def test_gauss_smooth3_matches_jax(sigma, radius):
    vol = _blobs((13, 11, 9), seed=6) + np.random.RandomState(7).rand(13, 11, 9).astype(np.float32)
    ref = np.asarray(jreg._gauss_smooth3(jnp.asarray(vol), jnp.float32(sigma), radius))
    got = treg._gauss_smooth3(torch.from_numpy(vol), np.float32(sigma), radius).numpy()
    _rel_close(got, ref, 1e-5, f"sigma {sigma}")


def test_sigma_schedules_and_radii_match_jax():
    for n in (1, 2, 3, 5):
        np.testing.assert_array_equal(treg._pyramid_sigmas(n), jreg._pyramid_sigmas(n))
        assert treg._smooth_radius_for_levels(n) == jreg._smooth_radius_for_levels(n)
    for cfg in (dict(resolutions=4), dict(pyramid_schedule=(8.0, 4.0, 2.0, 1.0))):
        np.testing.assert_array_equal(treg._stage_sigmas(treg.RegistrationParams(**cfg)),
                                      jreg._stage_sigmas(jreg.RegistrationParams(**cfg)))
    assert treg._smooth_radius_for_sigmas([0.0, 3.2]) == jreg._smooth_radius_for_sigmas([0.0, 3.2])


def test_adam_cosine_steps_match_optax():
    lr, iterations = 0.02, 10
    opt = optax.adam(optax.cosine_decay_schedule(lr, max(1, iterations), alpha=0.1))
    rs = np.random.RandomState(8)
    theta = rs.randn(6).astype(np.float32)
    jt, state = jnp.asarray(theta), opt.init(jnp.asarray(theta))
    tt = torch.from_numpy(theta)
    mu, nu = torch.zeros(6), torch.zeros(6)
    lrs = treg._cosine_lrs(lr, iterations)
    for step in range(iterations):
        # gradients from 1e-7 to 1e2: eps (1e-8, after the square root)
        # matters for the small ones
        g = (rs.randn(6) * np.logspace(-7, 2, 6) * (step + 1)).astype(np.float32)
        updates, state = opt.update(jnp.asarray(g), state)
        jt = optax.apply_updates(jt, updates)
        tt, mu, nu = treg._adam_step(tt, torch.from_numpy(g), mu, nu, step, lrs[step])
        _rel_close(tt.numpy(), np.asarray(jt), 1e-6, f"step {step}")


def test_level_budget_and_param_scale_match_jax():
    for kw in (dict(), dict(iteration_schedule=(10, 20)), dict(sample_schedule=(5, 6, 7, 8))):
        assert treg.RegistrationParams(**kw).level_budget(3) == \
            jreg.RegistrationParams(**kw).level_budget(3)
    for tf in ("translation", "rigid", "affine"):
        np.testing.assert_array_equal(treg._param_scale(tf, SHAPE, SPACING),
                                      jreg._param_scale(tf, SHAPE, SPACING))


# ----------------------------------------------------------------------
# The optimization, with dosma_tpu's draws injected
# ----------------------------------------------------------------------
_STAGE = dict(resolutions=2, iterations=20, num_samples=512)


@pytest.mark.parametrize("cfg", [
    dict(transform="rigid", metric="mi"),
    dict(transform="affine", metric="mse", interp_order=3),
    dict(transform="translation", metric="ncc", mi_kernel="linear"),
], ids=["rigid_mi", "affine_mse_cubic", "translation_ncc"])
def test_pyramid_core_matches_jax(pair, jax_draws, cfg):
    fixed, moving, A = pair
    params_j = jreg.RegistrationParams(**cfg, **_STAGE)
    params_t = treg.RegistrationParams(**cfg, **_STAGE)
    center = _center_world(A).astype(np.float32)
    spacing = np.sqrt((A[:3, :3] ** 2).sum(0))
    theta0 = np.zeros(params_t.nparams, np.float32)
    mask = (_blobs(seed=9) > 0.2).astype(np.float32)
    th_j, loss_j = jreg._run_pyramid_stage(
        jnp.asarray(fixed), A, jnp.asarray(mask), jnp.asarray(moving), A,
        theta0, center, spacing, params_j)
    th_t, loss_t = treg._run_pyramid_stage(
        torch.from_numpy(fixed), A, torch.from_numpy(mask), torch.from_numpy(moving), A,
        theta0, center, spacing, params_t)
    assert loss_t.shape == loss_j.shape == (2, 20)
    _rel_close(loss_t, loss_j, 1e-4, "loss trace")
    scale = treg._param_scale(params_t.transform, SHAPE, spacing)
    np.testing.assert_allclose(th_t / scale, th_j / scale, rtol=0, atol=1e-3)


_CHAIN = [dict(transform="rigid", metric="mi", final_interp_order=1, **_STAGE),
          dict(transform="affine", metric="mi", final_interp_order=1, seed=3, **_STAGE)]


def test_register_chain_matches_jax(pair, jax_draws):
    fixed, moving, A = pair
    extras = [moving * 2.0 + 1.0, np.sqrt(np.abs(moving))]
    Ms_j, w_j, e_j, info_j = jreg.register_chain(
        fixed, A, moving, A, [jreg.RegistrationParams(**c) for c in _CHAIN], extras=extras)
    Ms_t, w_t, e_t, info_t = treg.register_chain(
        fixed, A, moving, A, [treg.RegistrationParams(**c) for c in _CHAIN], extras=extras)
    assert isinstance(w_t, np.ndarray) and e_t.shape == (2,) + SHAPE
    for mt, mj in zip(Ms_t, Ms_j):
        np.testing.assert_allclose(mt, mj, rtol=0, atol=1e-3)
    for got, ref in ((w_t, w_j), (e_t[0], e_j[0]), (e_t[1], e_j[1])):
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
    assert set(info_t) == set(info_j)
    for lt, lj in zip(info_t["losses"], info_j["losses"]):
        _rel_close(lt, np.asarray(lj), 1e-4, "losses")


def test_register_chain_batch_warps_each_image_under_its_own_map(pair):
    fixed, moving, A = pair
    stack = np.stack([moving, np.roll(moving, 1, axis=0)])
    cfgs = [treg.RegistrationParams(**c) for c in _CHAIN]
    Ms, warped, info = treg.register_chain_batch(fixed, A, stack, A, cfgs)
    assert Ms.shape == (2, 2, 4, 4) and warped.shape == (2,) + SHAPE
    assert [l.shape for l in info["losses"]] == [(2, 2, 20), (2, 2, 20)]
    for i in range(2):
        one = treg.warp_volume(stack[i], Ms[i, -1], A, A, SHAPE, order=1)
        np.testing.assert_allclose(warped[i], one, rtol=0, atol=1e-5 * np.abs(one).max())


def test_register_pair_and_batch(pair):
    fixed, moving, A = pair
    p = treg.RegistrationParams(transform="rigid", metric="mse", **_STAGE)
    M, theta, info = treg.register_pair(fixed, A, moving, A, p)
    assert M.shape == (4, 4) and theta.shape == (6,) and "stalled" in info
    Ms, thetas, info_b = treg.register_pair_batch(fixed, A, np.stack([moving, moving]), A, p)
    np.testing.assert_allclose(Ms[0], M, rtol=0, atol=1e-6)  # image 0 uses seed 0
    assert len(info_b["losses"]) == 2 and info_b["losses"][0].shape == (2, 20)


def test_warp_volume_chain_matrix_only_and_bspline_raises(pair):
    """Matrix-only chains, and a chain with a B-spline stage (which once
    raised), warp as ``dosma_tpu``'s; an unknown stage kind raises."""
    fixed, moving, A = pair
    M1, M2 = _rigid_M(2.0, (0.5, 0, 0), A), _rigid_M(-1.0, (0, 0.3, 0.2), A)
    rs = np.random.RandomState(13)
    ctrl = ((rs.rand(3, 6, 6, 5) - 0.5) * 2.0).astype(np.float32)
    spacing = np.array([6.0, 6.0, 4.0])
    for stages in ([("matrix", M1), ("matrix", M2)],
                   [("matrix", M1), ("bspline", ctrl, spacing), ("matrix", M2)]):
        for order in (0, 1, 3):
            got = treg.warp_volume_chain(moving, stages, A, A, SHAPE, order=order)
            ref = np.asarray(jreg.warp_volume_chain(moving, stages, A, A, SHAPE, order=order))
            assert np.abs(got - ref).max() <= 1e-5 * max(1.0, np.abs(moving).max()), order
    with pytest.raises(ValueError, match="Unknown stage kind"):
        treg.warp_volume_chain(moving, [("spline", ctrl, spacing)], A, A, SHAPE)


# ----------------------------------------------------------------------
# The facade: register / apply_warp, transform files, NIfTI
# ----------------------------------------------------------------------
def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            out[rel] = os.path.join(dirpath, f)
    return out


def test_register_writes_what_dosma_tpu_writes(pair, jax_draws, tmp_path):
    fixed, moving, A = pair
    cj = [jreg.RegistrationParams(**c) for c in _CHAIN]
    ct = [treg.RegistrationParams(**c) for c in _CHAIN]
    rj = jcore.register(dosma_tpu.MedicalVolume(fixed, A), dosma_tpu.MedicalVolume(moving, A),
                        cj, output_path=str(tmp_path / "jax"), return_volumes=True)
    rt = dt.register(dt.MedicalVolume(fixed, A), dt.MedicalVolume(moving, A), ct,
                     output_path=str(tmp_path / "port"), return_volumes=True)
    tj, tt = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert sorted(tj) == sorted(tt) == [
        "moving-0/TransformParameters.0.json", "moving-0/TransformParameters.1.json",
        "moving-0/result.0.nii.gz", "moving-0/result.1.nii.gz"]
    for name in tj:
        if name.endswith(".json"):
            dj, dtt = json.load(open(tj[name])), json.load(open(tt[name]))
            assert sorted(dj) == sorted(dtt) and dtt["format"] == "dosma_tpu-transform-v1"
            np.testing.assert_allclose(dtt["matrix"], dj["matrix"], rtol=0, atol=1e-3)
        else:
            vj, _ = jnifti.read_nifti(tj[name])
            vt, _ = tnifti.read_nifti(tt[name])
            assert np.abs(vt - vj).max() <= 1e-4 * np.abs(vj).max()
    out_t, out_j = rt["outputs"][0], rj["outputs"][0]
    assert [os.path.basename(p) for p in out_t.transform] == \
        [os.path.basename(p) for p in out_j.transform]
    vol_t = rt["volumes"][0]
    assert isinstance(vol_t.A, np.ndarray) and vol_t.shape == SHAPE
    np.testing.assert_allclose(vol_t.affine, np.asarray(rj["volumes"][0].affine))


def test_transform_files_warp_the_same_in_both_packages(pair, tmp_path):
    fixed, moving, A = pair
    ct = [treg.RegistrationParams(**c) for c in _CHAIN]
    cj = [jreg.RegistrationParams(**dict(c, final_interp_order=3)) for c in _CHAIN]
    rt = dt.register(dt.MedicalVolume(fixed, A), dt.MedicalVolume(moving, A), ct,
                     output_path=str(tmp_path / "port"), save_volumes=False)
    rj = jcore.register(dosma_tpu.MedicalVolume(fixed, A), dosma_tpu.MedicalVolume(moving, A),
                        cj, output_path=str(tmp_path / "jax"), save_volumes=False)
    vol = (moving * 3.0 - 1.0).astype(np.float32)
    for files in (rt["outputs"][0].transform, rj["outputs"][0].transform):
        got = dt.apply_warp(dt.MedicalVolume(vol, A), transform=files)
        ref = jcore.apply_warp(dosma_tpu.MedicalVolume(vol, A), transform=files)
        assert isinstance(got.A, np.ndarray)
        assert np.abs(got.A - np.asarray(ref.A)).max() <= 1e-5 * np.abs(vol).max()
        np.testing.assert_allclose(got.affine, ref.affine)
        # the stacked same-grid path: one launch for the stack on a card
        stack_t = dt.apply_warp([dt.MedicalVolume(vol, A), dt.MedicalVolume(vol * 2, A)],
                                transform=files)
        np.testing.assert_allclose(stack_t[0].A, got.A, rtol=0, atol=1e-5 * np.abs(vol).max())
        np.testing.assert_allclose(stack_t[1].A, 2 * got.A, rtol=0,
                                   atol=2e-5 * np.abs(vol).max())


def test_bspline_transform_files_warp_the_same_in_both_packages(pair, tmp_path):
    """A rigid + B-spline chain registered by either package: its transform
    files warp a volume the same through both packages' ``apply_warp``."""
    fixed, moving, A = pair
    chain = [dict(transform="rigid", metric="mse", resolutions=2, iterations=10,
                  num_samples=512),
             dict(transform="bspline", metric="mse", resolutions=2, iterations=10,
                  num_samples=512, grid_spacing_mm=8.0)]
    rt = dt.register(dt.MedicalVolume(fixed, A), dt.MedicalVolume(moving, A),
                     [treg.RegistrationParams(**c) for c in chain],
                     output_path=str(tmp_path / "port"), save_volumes=False)
    rj = jcore.register(dosma_tpu.MedicalVolume(fixed, A), dosma_tpu.MedicalVolume(moving, A),
                        [jreg.RegistrationParams(**c) for c in chain],
                        output_path=str(tmp_path / "jax"), save_volumes=False)
    vol = (moving * 3.0 - 1.0).astype(np.float32)
    for files in (rt["outputs"][0].transform, rj["outputs"][0].transform):
        tj = json.load(open(files[1]))
        assert tj["format"] == "dosma_tpu-transform-v1" and tj["transform"] == "bspline"
        got = dt.apply_warp(dt.MedicalVolume(vol, A), transform=files)
        ref = jcore.apply_warp(dosma_tpu.MedicalVolume(vol, A), transform=files)
        assert isinstance(got.A, np.ndarray)
        assert np.abs(got.A - np.asarray(ref.A)).max() <= 1e-5 * np.abs(vol).max()
        np.testing.assert_allclose(got.affine, ref.affine)
    # the same keys in the files of both packages
    for name in ("TransformParameters.0.json", "TransformParameters.1.json"):
        kt = sorted(json.load(open(tmp_path / "port" / "moving-0" / name)))
        kj = sorted(json.load(open(tmp_path / "jax" / "moving-0" / name)))
        assert kt == kj


def test_register_across_grids(tmp_path):
    """Fixed and moving on different grids: the port's result agrees with
    dosma_tpu's warp of the port's own transform file."""
    A_f = _affine()
    A_m = _affine(spacing=(1.2, 1.0, 2.5), origin=(-14.0, 6.0, -21.0))
    m_shape = (20, 26, 10)
    fixed = _blobs()
    moving = np.asarray(jreg.warp_volume(fixed, np.eye(4), A_m, A_f, m_shape, order=1))
    ct = [treg.RegistrationParams(transform="rigid", metric="mse", final_interp_order=1,
                                  **_STAGE)]
    rt = dt.register(dt.MedicalVolume(fixed, A_f), dt.MedicalVolume(moving, A_m), ct,
                     output_path=str(tmp_path), return_volumes=True)
    got = rt["volumes"][0]
    assert got.shape == SHAPE
    np.testing.assert_allclose(got.affine, A_f)
    ref = jcore.apply_warp(dosma_tpu.MedicalVolume(moving, A_m),
                           transform=rt["outputs"][0].transform)
    assert np.abs(got.A - np.asarray(ref.A)).max() <= 1e-5 * np.abs(moving).max()
    # the result file holds the same volume
    on_disk = dt.core.io.nifti_io.NiftiReader().load(rt["outputs"][0].warped_file)
    np.testing.assert_allclose(on_disk.A, got.A, rtol=0, atol=0)


def test_register_options_masks_rtype_and_sequential(pair, tmp_path):
    fixed, moving, A = pair
    ct = [treg.RegistrationParams(**c) for c in _CHAIN]
    mask = dt.MedicalVolume((fixed > 0.1).astype(np.float32), A)
    outs, vols = dt.register(dt.MedicalVolume(fixed, A), [dt.MedicalVolume(moving, A)] * 2, ct,
                             output_path=str(tmp_path), target_mask=mask, rtype=tuple,
                             sequential=True, collate=False, save_volumes=False)
    assert vols is None and len(outs) == 2 and len(outs[0]) == 2  # per-stage specs
    assert all(len(spec.transform) == 1 for spec in outs[0])
    res = dt.register(dt.MedicalVolume(fixed, A), dt.MedicalVolume(moving, A), ct,
                      output_path=str(tmp_path / "m"), moving_masks=mask, use_mask=[True, False],
                      save_volumes=False)
    assert len(res["outputs"][0].transform) == 2
    # A chain with a B-spline stage takes the stage-by-stage path, moving
    # masks carried through it: per-stage specs, then collated, no volumes.
    bspline = treg.RegistrationParams(transform="bspline", metric="mse", resolutions=2,
                                      iterations=10, num_samples=512, grid_spacing_mm=8.0)
    chain = [ct[0], bspline]
    outs_b, _ = dt.register(dt.MedicalVolume(fixed, A), dt.MedicalVolume(moving, A), chain,
                            output_path=str(tmp_path / "b"), moving_masks=mask, rtype=tuple,
                            collate=False, save_volumes=False)
    assert len(outs_b) == 1 and len(outs_b[0]) == 2
    assert [spec.warped_file for spec in outs_b[0]] == [None, None]
    assert sorted(os.listdir(tmp_path / "b" / "moving-0")) == [
        "TransformParameters.0.json", "TransformParameters.1.json"]
    files = [spec.transform[0] for spec in outs_b[0]]
    assert "matrix" in json.load(open(files[0])) and "ctrl" in json.load(open(files[1]))
    res_b = dt.register(dt.MedicalVolume(fixed, A), dt.MedicalVolume(moving, A), chain,
                        output_path=str(tmp_path / "b2"), moving_masks=mask,
                        return_volumes=True)
    spec = res_b["outputs"][0]
    assert len(spec.transform) == 2 and spec.warped_file.endswith("result.1.nii.gz")
    assert len(spec.warped_files) == 2 and res_b["volumes"][0].shape == SHAPE
    back = dt.apply_warp(dt.MedicalVolume(moving, A), transform=spec.transform)
    np.testing.assert_allclose(back.A, res_b["volumes"][0].A, rtol=0,
                               atol=1e-5 * np.abs(moving).max())
    with pytest.raises(FileNotFoundError, match="series_dir"):  # read as a DICOM series
        dt.register(dt.MedicalVolume(fixed, A), str(tmp_path / "series_dir"), "rigid",
                    output_path=str(tmp_path / "c"))


def test_register_reads_nifti_paths(pair, tmp_path):
    fixed, moving, A = pair
    f_path, m_path = str(tmp_path / "f.nii.gz"), str(tmp_path / "m.nii")
    tnifti.write_nifti(f_path, fixed, A)
    tnifti.write_nifti(m_path, moving, A)
    ct = [treg.RegistrationParams(transform="translation", metric="mse", **_STAGE)]
    res = dt.register(f_path, m_path, ct, output_path=str(tmp_path / "out"), return_volumes=True)
    assert res["volumes"][0].shape == SHAPE
    warped = dt.apply_warp(m_path, transform=res["outputs"][0].transform,
                           output_path=str(tmp_path / "aw"), rtype=str)
    assert warped.endswith("result.nii.gz") and os.path.isfile(warped)


_PRESET_DIR = os.path.join(os.path.dirname(dosma_tpu.__file__), "resources", "registration")


@pytest.mark.parametrize("name", sorted(tcore.PRESETS))
def test_presets_equal_the_yaml_files(name):
    with open(os.path.join(_PRESET_DIR, name)) as f:
        assert tcore.PRESETS[name] == yaml.safe_load(f)
    assert tcore._load_stage_params(name) == treg.RegistrationParams(**tcore.PRESETS[name])


def test_preset_names_load_like_dosma_tpu():
    for name in ("rigid", "affine", "bspline", "translation"):
        assert tcore._load_stage_params(name).__dict__ == jcore._load_stage_params(name).__dict__
    p = treg.RegistrationParams(transform="affine", iterations=5)
    assert tcore._load_stage_params(p) is p
    with pytest.raises(FileNotFoundError):
        tcore._load_stage_params("no-such-file.txt")


_ELASTIX_FILES = {
    "affine_full": """// elastix affine
(Transform "AffineTransform")
(Metric "AdvancedMattesMutualInformation")
(NumberOfResolutions 4)
(MaximumNumberOfIterations 250 500 500 1000)
(NumberOfHistogramBins 48)
(NumberOfSpatialSamples 2000)
(ImagePyramidSchedule 8 8 4 4 4 2 2 2 1 1 1 1)
(BSplineInterpolationOrder 2)
(FinalBSplineInterpolationOrder 5)
(ImageSampler "Grid")
(NewSamplesEveryIteration "false")
(DefaultPixelValue 1)
(Registration "MultiResolutionRegistration")
(SomeUnknownKey 3)
(Optimizer)
""",
    "rigid_ncc": """(Transform "EulerTransform")
(Metric "AdvancedNormalizedCorrelation" "TransformBendingEnergyPenalty")
(FixedImagePyramid "FixedShrinkingImagePyramid")
(MovingImagePyramidSchedule 4 4 4 1 1 1)
(ImagePyramidSchedule 2 2 2 1 1 1)
(NumberOfSpatialSamples 1000 3000)
(ErodeMask "true")
(UseDirectionCosines "false")
(HowToCombineTransforms "Add")
""",
    "bspline_grid": """(Transform "BSplineTransform")
(Metric "AdvancedMeanSquares")
(FinalGridSpacingInPhysicalUnits 10 12 14)
(FinalGridSpacingInVoxels 4 5)
(MaximumNumberOfIterations 100 200)
(NumberOfSpatialSamples 500 600)
""",
    "quiet_translation": """(Transform "TranslationTransform")
(Metric "AdvancedMeanSquares")
(NumberOfResolutions 2)
(FinalBSplineInterpolationOrder 0)
""",
}


@pytest.mark.parametrize("name", sorted(_ELASTIX_FILES))
def test_parse_elastix_txt_matches_jax(name, tmp_path):
    path = tmp_path / f"{name}.txt"
    path.write_text(_ELASTIX_FILES[name])
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        pj = jcore._parse_elastix_txt(str(path))
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        pt = tcore._parse_elastix_txt(str(path))
    assert pt.__dict__ == pj.__dict__
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    assert tcore._load_stage_params(str(path)).__dict__ == pj.__dict__


@pytest.mark.parametrize("arr_dtype", [np.float32, np.int16, np.uint8])
def test_nifti_round_trips_between_packages(arr_dtype, tmp_path):
    rs = np.random.RandomState(12)
    arr = (rs.rand(7, 5, 4) * 100).astype(arr_dtype)
    A = _affine()
    R = _rigid_M(20.0, (1, 2, 3), A)
    aff = R @ A
    for writer, reader, ext in ((tnifti.write_nifti, jnifti.read_nifti, "nii.gz"),
                                (jnifti.write_nifti, tnifti.read_nifti, "nii")):
        path = str(tmp_path / f"{writer.__module__.split('.')[0]}.{ext}")
        writer(path, arr, aff)
        back, back_aff = reader(path)
        np.testing.assert_array_equal(back, arr)
        np.testing.assert_allclose(back_aff, aff, atol=1e-4)
    # the facades: a tensor-backed volume is written from the host
    path = str(tmp_path / "mv.nii.gz")
    dt.core.io.nifti_io.NiftiWriter().save(dt.MedicalVolume(torch.from_numpy(arr), aff), path)
    mv = dt.core.io.nifti_io.NiftiReader().load(path)
    np.testing.assert_array_equal(mv.A, arr)


# ----------------------------------------------------------------------
# Recovery (the port alone)
# ----------------------------------------------------------------------
def test_recovers_a_12_degree_rotation():
    shape = (48, 48, 24)
    A = _affine(spacing=(0.5, 0.6, 2.0))
    phantom = _blobs(shape, seed=1, n=40)
    M_true = _rigid_M(12.0, (1.5, -2.0, 3.0), A, shape)
    moving = treg.warp_volume(phantom, M_true, A, A, shape)
    params = treg.RegistrationParams(transform="rigid", metric="mi", resolutions=3,
                                     iterations=300, num_samples=2048)
    M, _, _ = treg.register_pair(phantom, A, moving, A, params)
    corners = np.array([[i, j, k, 1.0] for i in (0, shape[0] - 1) for j in (0, shape[1] - 1)
                        for k in (0, shape[2] - 1)]).T
    w = A @ corners
    err = np.linalg.norm((M @ w - np.linalg.inv(M_true) @ w)[:3], axis=0).max() / 0.5
    assert err < 0.5, f"rotation recovery error {err:.3f} voxels"


def test_kernel_wrapper_not_used_on_the_cpu(pair):
    fixed, moving, A = pair
    before = counters["warp_grid.launches"]
    treg.warp_volume(moving, np.eye(4), A, A, SHAPE, order=3)
    assert counters["warp_grid.launches"] == before
