"""The port's biexponential fit against the JAX package's Pallas kernel.

The same numpy inputs (``numpy.random.RandomState``) go through
``dosma_tpu.ops.biexp_pallas.biexp_lm_pallas`` in Pallas interpret mode (as
``tests/ops/test_biexp_pallas.py`` runs it on the CPU) and through
``dosma_tpu_torch.ops.biexp`` on CPU tensors, which takes the plain PyTorch
version (``biexp_lm_reference``). The CUDA kernel is held against that plain
version on the card by ``chip_smoke.py``.

Tolerances:
  - noiseless data: |Δp| ≤ 2e-5 · max(1, |p|) on every parameter, r² within
    1e-6. The JAX kernel keeps polishing a latched voxel until its 8192-voxel
    block has latched; the port freezes each voxel at its own latch. Both
    latch within a predicted relative cost decrease of 1e-5, which noiseless
    data pins to a few 1e-6 in the parameters.
  - 2% noise: |Δp| ≤ 2e-3 · max(1, |p|) and fitted curves within 1e-4: the
    biexponential is ill-conditioned, so the same latch difference moves
    the parameters along the flat valley more than the curve.
  - one step (``nan_policy="keep"``, ``max_iter=1``): |Δp| ≤ 1e-4 ·
    max(1, |p|), r² within 1e-5: both versions take the same single damped
    step; the frameworks' float32 ``exp`` differ in the last bit.
  - NaN positions identical; converged flags equal on ≥ 99% of voxels.
  - the noisy fit agrees with ``scipy.optimize.curve_fit`` in curve space to
    2e-3, the bound the JAX package's own test uses.
  - ``T3``: three echoes do not determine four parameters, only the curve
    through them, so that case holds the fitted curves (1e-4, as every
    case), r² and the flags, and no parameter bound.

Uniformly spaced echoes with 3 <= T <= 8 take the port's e0 * q^t columns
(``T3``, ``T5``, the default 8), uneven ones exact exponentials
(``nonuniform_x``), as do more than 8 (``T11``): both are held to the JAX
kernel with the tolerances above.
"""

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from dosma_tpu.ops.biexp_pallas import biexp_lm_pallas
from dosma_tpu_torch.ops.biexp import _reference_rows, _uniform_path, biexp_lm, biexp_lm_reference
from dosma_tpu_torch.ops.monoexp import _exp_cols, _tmean, _tsum


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_P0 = np.array([1.0, -0.5, 0.4, -0.04], np.float32)


_UNEVEN_X = np.cumsum(np.linspace(0.5, 2.5, 8)).astype(np.float32)  # 0.5 ... 12.0


def _data(N=256, seed=0, noise=0.0, T=8, x=None):
    rs = np.random.RandomState(seed)
    x = np.linspace(0.0, 10.0, T).astype(np.float32) if x is None else x
    a1 = 0.8 + 0.4 * rs.rand(N).astype(np.float32)
    b1 = -(0.4 + 0.2 * rs.rand(N).astype(np.float32))
    a2 = 0.3 + 0.3 * rs.rand(N).astype(np.float32)
    b2 = -(0.03 + 0.03 * rs.rand(N).astype(np.float32))
    Y = a1[:, None] * np.exp(b1[:, None] * x) + a2[:, None] * np.exp(b2[:, None] * x)
    if noise:
        Y = Y * (1 + noise * rs.randn(N, x.size).astype(np.float32))
    return x, Y.astype(np.float32)


def _curve(x, p):
    return p[:, 0:1] * np.exp(p[:, 1:2] * x) + p[:, 2:3] * np.exp(p[:, 3:4] * x)


def _case(name):
    """(x, Y, p0, kwargs, parameter tolerance, r² tolerance)."""
    kw = {"max_iter": 100}
    if name == "noiseless":
        return (*_data(), _P0, kw, 2e-5, 1e-6)
    if name == "noisy":
        return (*_data(seed=1, noise=0.02), _P0, kw, 2e-3, 1e-6)
    if name == "all_zero_voxel":
        x, Y = _data(seed=2)
        Y[7] = 0
        return x, Y, _P0, kw, 2e-5, 1e-6
    if name == "y_bounds":
        x, Y = _data(seed=3)
        return x, Y, _P0, dict(kw, y_bounds=(0.3, 1.5)), 2e-5, 1e-6
    if name == "keep_one_iter":
        return (*_data(seed=4), _P0, {"nan_policy": "keep", "max_iter": 1}, 1e-4, 1e-5)
    if name == "n_not_multiple_of_block":
        return (*_data(N=300, seed=5), _P0, kw, 2e-5, 1e-6)
    if name == "per_voxel_p0":
        x, Y = _data(seed=6)
        p0 = np.tile(_P0, (256, 1)) * np.float32(1.05)
        return x, Y, p0, kw, 2e-5, 1e-6
    if name == "bad_init_voxel":
        x, Y = _data(seed=7)
        p0 = np.tile(_P0, (256, 1))
        p0[9, 1] = 100.0  # exp(100 * 10) overflows: the initial cost is inf
        return x, Y, p0, kw, 2e-5, 1e-6
    if name == "layout_tn":
        x, Y = _data(seed=8)
        return x, np.ascontiguousarray(Y.T), _P0, dict(kw, y_layout="tn"), 2e-5, 1e-6
    if name == "nonuniform_x":
        return (*_data(seed=12, x=_UNEVEN_X), _P0, kw, 2e-5, 1e-6)
    if name == "T3":
        return (*_data(seed=9, T=3), _P0, kw, None, 1e-6)
    if name.startswith("T"):
        return (*_data(seed=9, T=int(name[1:])), _P0, kw, 2e-5, 1e-6)
    raise KeyError(name)


_CASES = [
    "noiseless", "noisy", "all_zero_voxel", "y_bounds", "keep_one_iter",
    "n_not_multiple_of_block", "per_voxel_p0", "bad_init_voxel", "layout_tn", "T5", "T11",
    "nonuniform_x", "T3",
]


def _run_both(x, Y, p0, kw):
    with pltpu.force_tpu_interpret_mode():
        pj, rj, cj = biexp_lm_pallas(x, Y, p0, **kw)
    launches = biexp_lm.launches
    pt, rt, ct = biexp_lm(x, torch.from_numpy(Y), p0, **kw)
    assert biexp_lm.launches == launches  # a CPU tensor never reaches the kernel
    return (np.asarray(pj), np.asarray(rj), np.asarray(cj)), (pt.numpy(), rt.numpy(), ct.numpy())


@pytest.mark.parametrize("name", _CASES)
def test_matches_jax_kernel(name):
    x, Y, p0, kw, ptol, r2tol = _case(name)
    (pj, rj, cj), (pt, rt, ct) = _run_both(x, Y, p0, kw)

    assert pt.shape == pj.shape and rt.shape == rj.shape and ct.shape == cj.shape
    np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
    fin = np.isfinite(pj)
    if ptol is not None:
        assert (np.abs(pt - pj)[fin] <= ptol * np.maximum(1.0, np.abs(pj[fin]))).all()
    assert np.abs(rt - rj).max() <= r2tol
    assert (ct == cj).mean() >= 0.99

    ok = np.isfinite(pt).all(1)
    if name != "keep_one_iter":
        np.testing.assert_allclose(_curve(x, pt[ok]), _curve(x, pj[ok]), atol=1e-4)
    if name == "all_zero_voxel":
        assert np.isnan(pt[7]).all() and rt[7] == 0
    if name == "y_bounds":
        Yn = Y
        oob = ((Yn < 0.3) | (Yn > 1.5)).any(1)
        assert oob.any() and np.isnan(pt[oob]).all() and (rt[oob] == 0).all()
    if name == "keep_one_iter":
        assert (~ct).any() and np.isfinite(pt).all()
    if name == "bad_init_voxel":
        assert np.isnan(pt[9]).all() and not ct[9] and ct.mean() > 0.95


@pytest.mark.parametrize("name", ["noisy_uniform", "nonuniform_x", "one_iter", "T11"])
def test_r2_is_the_cost_at_the_returned_parameters(name):
    # The kernel's r² reads the raw cost carried from the accepted point's
    # evaluation: it must be 1 - c / (ss_tot + 1e-8), bit for bit, with c
    # the raw cost at the returned parameters, on every voxel whose cost is
    # finite.
    kw = {"max_iter": 1 if name == "one_iter" else 100}
    x, Y = (_data(seed=13, noise=0.02, x=_UNEVEN_X) if name == "nonuniform_x"
            else _data(seed=13, noise=0.02, T=11 if name == "T11" else 8))
    Y[5] = 0
    p0 = np.tile(_P0, (Y.shape[0], 1))
    p0[9, 1] = 100.0  # an infinite initial cost
    uniform = _uniform_path(x)
    assert uniform == (name in ("noisy_uniform", "one_iter"))
    xt, yT = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(Y.T))
    rows = _reference_rows(xt, yT, torch.from_numpy(p0), kw["max_iter"], 1e-5, 1e-5, uniform)
    a1, b1, a2, b2, r2 = rows[:5]
    r = a1 * _exp_cols(b1, xt, uniform) + a2 * _exp_cols(b2, xt, uniform) - yT
    c = _tsum(r * r)
    d = yT - _tmean(yT)
    expected = 1.0 - c / (_tsum(d * d) + 1e-8)
    fin = torch.isfinite(c)
    assert int(fin.sum()) >= Y.shape[0] - 2
    assert torch.equal(r2[fin], expected[fin])


def test_noisy_matches_scipy():
    import scipy.optimize

    x, Y = _data(N=48, seed=3, noise=0.02)
    popt, _, _ = biexp_lm(x, torch.from_numpy(Y), _P0, max_iter=150)
    popt = popt.numpy()

    def biexp(t, a1, b1, a2, b2):
        return a1 * np.exp(b1 * t) + a2 * np.exp(b2 * t)

    checked = 0
    for i in range(0, 48, 5):
        if not np.isfinite(popt[i]).all():
            continue
        ref, _ = scipy.optimize.curve_fit(biexp, np.float64(x), np.float64(Y[i]), p0=_P0,
                                          maxfev=2000)
        np.testing.assert_allclose(_curve(x, popt[i:i + 1])[0], biexp(x, *ref), atol=2e-3)
        checked += 1
    assert checked >= 8


def test_reference_entry_point_equals_cpu_dispatch():
    x, Y = _data(N=64, seed=10, noise=0.01)
    a = biexp_lm(x, torch.from_numpy(Y), _P0)
    b = biexp_lm_reference(x, torch.from_numpy(Y), _P0)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)


def test_frozen_voxel_does_not_depend_on_neighbours():
    # Each voxel stops at its own latch, so fitting it alone or among others
    # gives the same bits.
    x, Y = _data(N=40, seed=11, noise=0.02)
    together = biexp_lm(x, torch.from_numpy(Y), _P0)[0]
    alone = biexp_lm(x, torch.from_numpy(Y[13:14].copy()), _P0)[0]
    torch.testing.assert_close(together[13:14], alone, rtol=0, atol=0, equal_nan=True)


def test_rejects_wrong_shapes():
    x, Y = _data(N=16)
    with pytest.raises(ValueError):
        biexp_lm(x[:3], torch.from_numpy(Y), _P0)
    with pytest.raises(ValueError):
        biexp_lm(x, torch.from_numpy(Y), np.ones((5, 4), np.float32))
    with pytest.raises(ValueError):
        biexp_lm(x, torch.from_numpy(Y), np.ones(3, np.float32))
