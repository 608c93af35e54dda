"""The port's monoexponential fit against the JAX package's Pallas kernel.

The same numpy inputs (``numpy.random.RandomState``) go through
``dosma_tpu.ops.monoexp_pallas.monoexp_lm_pallas`` (in Pallas interpret mode,
as ``tests/ops/test_monoexp_pallas.py`` runs it on the CPU) and through
``dosma_tpu_torch.ops.monoexp.monoexp_lm`` on CPU tensors, which takes the
plain PyTorch version. The CUDA kernel is held against that plain version
on the card by ``chip_smoke.py``.

Tolerances:
  - |Δa|, |Δb| ≤ 1e-4 on noiseless data. The JAX kernel keeps polishing a
    latched voxel until its whole 8192-voxel block has latched; the port
    freezes each voxel at its own latch. Both latches stop within a step of
    relative size ~1e-5 of the optimum, so the two differ by far less.
  - NaN positions identical: they come from the NaN policy, which is the
    same predicate on the same data.
  - converged flags equal on ≥ 99% of voxels: a voxel on the edge of a
    latch test may latch one iteration apart in the two versions.
  - on 5% noise, agreement with ``scipy.optimize.curve_fit`` to 1e-3, the
    bound the JAX package's own test uses (same least-squares objective).
"""

import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from dosma_tpu.ops.monoexp_pallas import monoexp_lm_pallas
from dosma_tpu_torch.ops.monoexp import (
    _detect_uniform_x, _exp_cols, _packed_reference, _reduced_cost, _tmean, _tsum, monoexp_lm,
    monoexp_lm_reference,
)
from dosma_tpu_torch.utils.profiling import counters


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_X4 = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
_P0 = np.array([1.0, -1 / 30], np.float32)


def _data(N=1024, seed=0, noise=0.0, x=_X4):
    rs = np.random.RandomState(seed)
    b = -1 / (rs.rand(N).astype(np.float32) * 70 + 10)
    Y = np.exp(b[:, None] * x[None, :]).astype(np.float32)
    if noise:
        Y = Y * (1 + noise * rs.randn(N, x.size).astype(np.float32))
    return x, Y.astype(np.float32), b


def _case(name):
    """(x, Y (N, T), p0, kwargs, b_true or None) for one parity case."""
    if name == "noiseless_p0":
        x, Y, b = _data()
        return x, Y, _P0, {"max_iter": 50}, b
    if name == "all_zero_voxel":
        x, Y, _ = _data(N=256)
        Y[7] = 0
        return x, Y, _P0, {}, None
    if name == "constant_and_growing":
        x, Y, _ = _data(N=256)
        Y[3] = 0.7
        Y[11] = np.exp(0.02 * x)
        return x, Y, _P0, {}, None
    if name == "n_not_multiple_of_block":
        x, Y, b = _data(N=1000)
        return x, Y, _P0, {}, b
    if name == "per_voxel_p0":
        x, Y, b = _data(N=500)
        p0 = np.stack([np.ones(500, np.float32), np.full(500, -1 / 30, np.float32)], axis=1)
        return x, Y, p0, {"max_iter": 50}, b
    if name == "polyfit_seed":
        x, Y, b = _data(N=512, seed=1)
        return x, Y, None, {"max_iter": 50}, b
    if name == "nonuniform_x":
        x, Y, b = _data(N=512, seed=2, x=np.array([5.0, 12.0, 30.0, 47.0], np.float32))
        return x, Y, None, {}, b
    if name.startswith("T"):
        T = int(name[1:])
        x, Y, b = _data(N=256, seed=T, x=(10.0 * np.arange(1, T + 1)).astype(np.float32))
        return x, Y, None, {}, b
    if name == "layout_tn":
        x, Y, b = _data(N=300, seed=4)
        return x, np.ascontiguousarray(Y.T), None, {"y_layout": "tn"}, b
    if name == "y_bounds":
        x, Y, _ = _data(N=400, seed=5)
        return x, Y, _P0, {"y_bounds": (0.1, 1.0)}, None
    if name == "nan_policy_keep_one_iter":
        # One iteration leaves many voxels unconverged: "keep" must keep
        # their parameters, and both versions run the same single step.
        x, Y, _ = _data(N=256, seed=6)
        return x, Y, _P0, {"nan_policy": "keep", "max_iter": 1}, None
    raise KeyError(name)


_CASES = [
    "noiseless_p0", "all_zero_voxel", "constant_and_growing", "n_not_multiple_of_block",
    "per_voxel_p0", "polyfit_seed", "nonuniform_x", "T2", "T3", "T4", "T8", "layout_tn",
    "y_bounds", "nan_policy_keep_one_iter",
]


def _run_both(x, Y, p0, kwargs):
    with pltpu.force_tpu_interpret_mode():
        pj, rj, cj = monoexp_lm_pallas(x, Y, p0, **kwargs)
    launches = counters["monoexp_lm.launches"]
    pt, rt, ct = monoexp_lm(x, torch.from_numpy(Y), p0, **kwargs)
    assert counters["monoexp_lm.launches"] == launches  # a CPU tensor never reaches the kernel
    return (np.asarray(pj), np.asarray(rj), np.asarray(cj)), (pt.numpy(), rt.numpy(), ct.numpy())


@pytest.mark.parametrize("name", _CASES)
def test_matches_jax_kernel(name):
    x, Y, p0, kwargs, b_true = _case(name)
    (pj, rj, cj), (pt, rt, ct) = _run_both(x, Y, p0, kwargs)

    assert pt.shape == pj.shape and rt.shape == rj.shape and ct.shape == cj.shape
    np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
    fin = np.isfinite(pj)
    assert np.abs(pt[fin] - pj[fin]).max(initial=0.0) <= 1e-4
    assert np.abs(rt - rj).max() <= 1e-4
    assert (ct == cj).mean() >= 0.99
    if b_true is not None:
        assert ct.all()
        assert np.abs(pt[:, 1] - b_true).max() <= 1e-4

    if name == "all_zero_voxel":
        assert np.isnan(pt[7]).all() and rt[7] == 0
    if name == "constant_and_growing":
        assert abs(pt[3, 1]) < 1e-3 and abs(pt[3, 0] - 0.7) < 1e-3
        assert abs(pt[11, 1] - 0.02) < 1e-4
    if name == "y_bounds":
        oob = (Y < 0.1).any(1)
        assert oob.any() and np.isnan(pt[oob]).all() and (rt[oob] == 0).all()
    if name == "nan_policy_keep_one_iter":
        assert (~ct).any() and np.isfinite(pt[~ct]).all()


def test_noisy_matches_scipy_and_jax():
    import scipy.optimize

    x, Y, _ = _data(N=64, noise=0.05, seed=3)
    (pj, _, _), (pt, _, _) = _run_both(x, Y, _P0, {"max_iter": 50})
    for i in range(0, 64, 7):
        ref, _ = scipy.optimize.curve_fit(
            lambda t, a, bb: a * np.exp(bb * t), x, Y[i], p0=(1.0, -1 / 30)
        )
        assert np.abs(pt[i] - ref).max() < 1e-3, (i, pt[i], ref)
        assert np.abs(pj[i] - ref).max() < 1e-3, (i, pj[i], ref)


@pytest.mark.parametrize("name", ["uniform_seeded", "nonuniform_x", "one_iter", "T11"])
def test_r2_and_amplitude_are_the_reduced_cost_at_the_returned_rate(name):
    # The kernel writes a = t1 / s1 and r² from the reduced cost carried
    # with the final rate: both must be, bit for bit, what _reduced_cost
    # gives at the returned b, on every voxel whose cost is finite.
    x = {"nonuniform_x": np.array([5.0, 12.0, 30.0, 47.0], np.float32),
         "T11": (10.0 * np.arange(1, 12)).astype(np.float32)}.get(name, _X4)
    x, Y, _ = _data(N=512, seed=8, noise=0.02, x=x)
    Y[3] = 0
    Y[5] = np.exp(0.02 * x)
    uniform = _detect_uniform_x(x)
    xt, yT = torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(Y.T))
    max_iter = 1 if name == "one_iter" else 100
    a, b, r2 = _packed_reference(xt, yT, None, max_iter, 1e-5, 1e-5, uniform)[:3]
    e = _exp_cols(b, xt, uniform)
    c, t1 = _reduced_cost(e, yT)
    d = yT - _tmean(yT)
    fin = torch.isfinite(c)
    assert int(fin.sum()) >= 510
    assert torch.equal(r2[fin], (1.0 - c / (_tsum(d * d) + 1e-8))[fin])
    assert torch.equal(a[fin], (t1 / torch.clamp(_tsum(e * e), min=1e-30))[fin])


def test_reference_entry_point_equals_cpu_dispatch():
    x, Y, _ = _data(N=128, seed=7, noise=0.01)
    a = monoexp_lm(x, torch.from_numpy(Y))
    b = monoexp_lm_reference(x, torch.from_numpy(Y))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)


def test_rejects_wrong_shapes():
    x, Y, _ = _data(N=16)
    with pytest.raises(ValueError):
        monoexp_lm(x[:3], torch.from_numpy(Y))
    with pytest.raises(ValueError):
        monoexp_lm(x, torch.from_numpy(Y), np.ones((5, 2), np.float32))
