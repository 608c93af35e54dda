"""The port's batched Levenberg–Marquardt engine against ``dosma_tpu.ops.nlls``.

The same numpy inputs (``numpy.random.RandomState``) go through
``dosma_tpu.ops.nlls`` on JAX's CPU backend and through
``dosma_tpu_torch.ops.nlls`` on CPU tensors; each model is written once in
``jax.numpy`` and once in ``torch``.

Tolerances:
  - ``_chol_solve_unrolled``: relative 1e-5 on well-conditioned random SPD
    systems (float32, the same operations in the same order).
  - ``lm_fit`` on noiseless data: |Δp| ≤ 1e-5 · max(1, |p|), r² within 1e-6.
    The JAX loop keeps polishing a latched voxel until all voxels have
    latched; the port freezes each voxel at its latch. Both latches stop
    within a relative step of ~1e-5 of the optimum, which noiseless data
    pins far tighter than that.
  - ``lm_fit`` on noisy data: |Δp| ≤ 1e-3 · max(1, |p|), r² within 1e-6:
    the same latch difference on a flatter cost surface moves parameters
    more and the cost (hence r²) almost not at all.
  - after a single step (``nan_policy="keep"``, ``max_iter=1``) r² within
    1e-5: away from the optimum the cost is not flat, and the two
    frameworks' float32 ``exp`` differ in the last bit.
  - NaN positions identical and converged flags equal on ≥ 99% of voxels:
    the NaN policy is the same predicate on the same data; a voxel on the
    edge of a latch test may latch one iteration apart.
  - ``batched_polyfit`` and ``r_squared``: 1e-4 absolute for deg ≤ 2 (the
    JAX deg-1 path is the same closed form; higher degrees solve by lstsq in
    both), 1e-3 for deg 3 (a worse-conditioned Vandermonde in float32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dosma_tpu.ops import nlls as jnlls
from dosma_tpu_torch.ops import nlls


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_X4 = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
_X5 = np.array([5.0, 15.0, 30.0, 50.0, 80.0], np.float32)
_X8 = np.linspace(0.0, 10.0, 8).astype(np.float32)

# name -> (jax model, torch model, x, p0, data maker)
_MODELS = {
    "monoexp": (
        lambda xc, p: p[0] * jnp.exp(p[1] * xc),
        lambda xc, p: p[0] * torch.exp(p[1] * xc),
        _X4,
        np.array([1.0, -1 / 30], np.float32),
    ),
    "offset_exp": (
        lambda xc, p: p[0] * jnp.exp(p[1] * xc) + p[2],
        lambda xc, p: p[0] * torch.exp(p[1] * xc) + p[2],
        _X5,
        np.array([1.0, -1 / 30, 0.0], np.float32),
    ),
    "biexp": (
        lambda xc, p: p[0] * jnp.exp(p[1] * xc) + p[2] * jnp.exp(p[3] * xc),
        lambda xc, p: p[0] * torch.exp(p[1] * xc) + p[2] * torch.exp(p[3] * xc),
        _X8,
        np.array([1.0, -0.5, 0.4, -0.04], np.float32),
    ),
}


def _data(model, N, seed, noise=0.0):
    rs = np.random.RandomState(seed)
    x = _MODELS[model][2]
    if model == "monoexp":
        b = -1 / (rs.rand(N) * 70 + 10)
        Y = np.exp(b[:, None] * x)
    elif model == "offset_exp":
        a, b, c = rs.rand(N) + 0.5, -1 / (rs.rand(N) * 70 + 10), rs.rand(N) * 0.2
        Y = a[:, None] * np.exp(b[:, None] * x) + c[:, None]
    else:
        a1, b1 = 0.8 + 0.4 * rs.rand(N), -(0.4 + 0.2 * rs.rand(N))
        a2, b2 = 0.3 + 0.3 * rs.rand(N), -(0.03 + 0.03 * rs.rand(N))
        Y = a1[:, None] * np.exp(b1[:, None] * x) + a2[:, None] * np.exp(b2[:, None] * x)
    if noise:
        Y = Y * (1 + noise * rs.randn(*Y.shape))
    return Y.astype(np.float32)


def _run_both(model, Y, p0, **kw):
    mj, mt, x, _ = _MODELS[model]
    pj, rj, cj = jnlls.lm_fit(mj, x, Y, p0, **kw)
    pt, rt, ct = nlls.lm_fit(mt, x, torch.from_numpy(Y), p0, **kw)
    return (np.asarray(pj), np.asarray(rj), np.asarray(cj)), (pt.numpy(), rt.numpy(), ct.numpy())


def _assert_close(jax_out, torch_out, ptol, r2tol=1e-6, conv_agree=0.99):
    (pj, rj, cj), (pt, rt, ct) = jax_out, torch_out
    assert pt.shape == pj.shape and rt.shape == rj.shape and ct.shape == cj.shape
    np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
    fin = np.isfinite(pj)
    assert (np.abs(pt - pj)[fin] <= ptol * np.maximum(1.0, np.abs(pj[fin]))).all()
    assert np.abs(rt - rj).max() <= r2tol
    assert (ct == cj).mean() >= conv_agree


@pytest.mark.parametrize("noise", [0.0, 0.02], ids=["clean", "noisy"])
@pytest.mark.parametrize("model", list(_MODELS))
def test_lm_fit_matches_jax(model, noise):
    Y = _data(model, 300, seed=len(model), noise=noise)
    jax_out, torch_out = _run_both(model, Y, _MODELS[model][3], max_iter=100)
    _assert_close(jax_out, torch_out, 1e-5 if noise == 0 else 1e-3)
    assert torch_out[2].mean() > 0.95


@pytest.mark.parametrize(
    "case", ["all_zero_voxel", "y_bounds", "keep_one_iter", "per_voxel_p0", "bad_init_voxel"]
)
def test_lm_fit_edge_cases_match_jax(case):
    model = "offset_exp"
    Y = _data(model, 200, seed=3)
    p0 = _MODELS[model][3]
    kw = {"max_iter": 60}
    if case == "all_zero_voxel":
        Y[7] = 0
    elif case == "y_bounds":
        kw["y_bounds"] = (0.2, 1.5)
    elif case == "keep_one_iter":
        kw.update(nan_policy="keep", max_iter=1)
    elif case == "per_voxel_p0":
        p0 = np.tile(p0, (200, 1)) * np.float32(1.1)
    elif case == "bad_init_voxel":
        p0 = np.tile(p0, (200, 1))
        p0[5, 1] = 100.0  # exp(100 * 80) overflows: the initial cost is inf
    jax_out, torch_out = _run_both(model, Y, p0, **kw)
    _assert_close(jax_out, torch_out, 1e-5, r2tol=1e-5 if case == "keep_one_iter" else 1e-6)
    pt, rt, ct = torch_out
    if case == "all_zero_voxel":
        assert np.isnan(pt[7]).all() and rt[7] == 0
    if case == "y_bounds":
        oob = ((Y < 0.2) | (Y > 1.5)).any(1)
        assert oob.any() and np.isnan(pt[oob]).all() and (rt[oob] == 0).all()
    if case == "keep_one_iter":
        assert (~ct).any() and np.isfinite(pt).all()
    if case == "bad_init_voxel":
        assert np.isnan(pt[5]).all() and not ct[5] and ct[:5].all()


def test_lm_fit_keeps_data_device_and_dtype():
    Y = _data("monoexp", 50, seed=9)
    _, mt, x, p0 = _MODELS["monoexp"]
    popt, r2, conv = nlls.lm_fit(mt, x, torch.from_numpy(Y.astype(np.float64)), p0)
    assert popt.dtype == torch.float64 and popt.shape == (50, 2) and conv.dtype == torch.bool
    popt_np, _, _ = nlls.lm_fit(mt, x, Y, p0)  # numpy in: fit on the CPU
    assert isinstance(popt_np, torch.Tensor) and popt_np.device.type == "cpu"


def test_jacobian_columns_match_jax_jvp():
    rs = np.random.RandomState(4)
    mj, mt, x, _ = _MODELS["biexp"]
    params = [rs.rand(16).astype(np.float32) - 0.5 for _ in range(4)]
    x_col = x[:, None]
    cols_j = []
    for i in range(4):
        tangents = tuple(jnp.ones(16) if j == i else jnp.zeros(16) for j in range(4))
        _, col = jax.jvp(lambda ps: mj(jnp.asarray(x_col), ps),
                         (tuple(map(jnp.asarray, params)),), (tangents,))
        cols_j.append(np.asarray(col))
    source = nlls._JvpSource(mt, torch.from_numpy(x_col), (x.size, 16))
    f, cols_t = source.value_and_jacobian([torch.from_numpy(p) for p in params])
    np.testing.assert_allclose(f.numpy(), np.asarray(mj(x_col, params)), rtol=1e-6, atol=1e-7)
    for cj, ct in zip(cols_j, cols_t):
        np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("P", [1, 2, 3, 4])
def test_chol_solve_matches_jax(P):
    rs = np.random.RandomState(P)
    N = 64
    M = rs.randn(N, P, P).astype(np.float32)
    A = M @ np.transpose(M, (0, 2, 1)) + P * np.eye(P, dtype=np.float32)
    b = rs.randn(N, P).astype(np.float32)
    lower = {(i, j): A[:, i, j] for i in range(P) for j in range(i + 1)}
    dj = jnlls._chol_solve_unrolled({k: jnp.asarray(v) for k, v in lower.items()},
                                    [jnp.asarray(b[:, i]) for i in range(P)], P)
    dt = nlls._chol_solve_unrolled({k: torch.from_numpy(v) for k, v in lower.items()},
                                   [torch.from_numpy(b[:, i]) for i in range(P)], P)
    for u, v in zip(dj, dt):
        np.testing.assert_allclose(v.numpy(), np.asarray(u), rtol=1e-5, atol=1e-6)
    solved = np.stack([v.numpy() for v in dt], axis=1)
    np.testing.assert_allclose(np.einsum("nij,nj->ni", A, solved), b, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("deg", [1, 2, 3])
def test_batched_polyfit_matches_jax(deg):
    rs = np.random.RandomState(deg)
    x = np.linspace(0.0, 5.0, 7).astype(np.float32)
    Y = rs.rand(7, 120).astype(np.float32)
    pj, rj = jnlls.batched_polyfit(x, Y, deg)
    pt, rt = nlls.batched_polyfit(x, torch.from_numpy(Y), deg)
    tol = 1e-4 if deg <= 2 else 1e-3
    assert pt.shape == (deg + 1, 120) and pt.dtype == torch.float32
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=tol)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=tol)
    np.testing.assert_allclose(pt.numpy(), np.polyfit(x, Y, deg), atol=tol)


def test_r_squared_matches_jax():
    rs = np.random.RandomState(0)
    y = rs.rand(6, 40).astype(np.float32)
    yhat = y + 0.05 * rs.randn(6, 40).astype(np.float32)
    for axis in (0, 1):
        rj = jnlls.r_squared(jnp.asarray(yhat), jnp.asarray(y), axis=axis)
        rt = nlls.r_squared(torch.from_numpy(yhat), torch.from_numpy(y), axis=axis)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-6)
