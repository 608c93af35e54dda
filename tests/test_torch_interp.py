"""The port's cubic B-spline interpolation against ``dosma_tpu.ops.interp``.

The same numpy inputs (``numpy.random.RandomState``) go through both
packages. Tolerance: |Δ| ≤ 1e-5 · max(1, max|v|). The two prefilters run
the same recursion in float32 and differ only in the summation order of the
16-term causal init; the samplers differ in formulation (``dosma_tpu``
reduces whole rows against dense weight profiles, the port gathers 64 taps)
but not in arithmetic beyond rounding. Axes of length 2 and 3 exercise the
modular mirror fold of the causal init (horizon 16 > one mirror period).
Interior points agree with ``scipy.ndimage.map_coordinates(order=3,
mode="mirror")`` to 1e-4 (float32 against scipy's float64).
"""

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

import jax.numpy as jnp

from dosma_tpu.ops import interp as jinterp
from dosma_tpu_torch.ops import interp


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


SHAPES = [(2, 3, 19), (3, 17, 2), (18, 5, 3), (1, 4, 17)]


def _vol(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32) * 3.0


def _close(got, ref, scale):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    tol = 1e-5 * max(1.0, float(scale))
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= tol, f"max |Δ| {err} > {tol}"


def _coords(shape, n, seed, lo=-1.5, hi_pad=1.5):
    rs = np.random.RandomState(seed)
    c = np.stack([rs.uniform(lo, d - 1 + hi_pad, n) for d in shape]).astype(np.float32)
    # exact grid points, the domain edges and points just inside the 1e-3 band
    extra = np.array([[0, 0, 0], [d - 1 for d in shape], [-5e-4, 0, 0],
                      [shape[0] - 1 + 5e-4, 0, 0], [-2e-3, 0, 0]], np.float32).T
    return np.concatenate([c, extra], axis=1)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cubic_prefilter_matches_jax(shape):
    v = _vol(shape)
    ref = np.asarray(jinterp.cubic_prefilter(jnp.asarray(v)))
    got = interp.cubic_prefilter(torch.from_numpy(v)).numpy()
    _close(got, ref, np.abs(ref).max())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_cubic_coeffs_matches_jax(shape):
    v = _vol(shape, seed=1)
    ref = np.asarray(jinterp.cubic_coeffs(jnp.asarray(v)))
    got = interp.cubic_coeffs(torch.from_numpy(v)).numpy()
    _close(got, ref, np.abs(ref).max())


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7])
def test_mirror_pad_is_numpy_reflect(n):
    a = np.arange(n, dtype=np.float32)
    want = np.pad(a, 2, mode="reflect") if n > 1 else np.full(5, a[0])
    np.testing.assert_array_equal(a[interp._mirror_index(n, 2)], want)


@pytest.mark.parametrize("shape", SHAPES + [(6, 7, 5)], ids=str)
def test_cubic_sample_coeffs_matches_jax(shape):
    v = _vol(shape, seed=2)
    c = _coords(shape, 300, seed=3)
    cp_j = jinterp.cubic_coeffs(jnp.asarray(v))
    ref = np.asarray(jinterp.cubic_sample_coeffs(cp_j, jnp.asarray(c)))
    got = interp.cubic_sample_coeffs(interp.cubic_coeffs(torch.from_numpy(v)),
                                     torch.from_numpy(c)).numpy()
    _close(got, ref, np.abs(v).max())
    assert (got[c.shape[1] - 1] == 0.0) and (ref[c.shape[1] - 1] == 0.0)  # outside by 2e-3


def test_cubic_sample_and_map_coordinates_match_jax():
    shape = (7, 6, 9)
    v = _vol(shape, seed=4)
    c = _coords(shape, 200, seed=5)
    coeffs = np.array(jinterp.cubic_prefilter(jnp.asarray(v)))
    ref = np.asarray(jinterp.cubic_sample(jnp.asarray(coeffs), jnp.asarray(c)))
    got = interp.cubic_sample(torch.from_numpy(coeffs), torch.from_numpy(c)).numpy()
    _close(got, ref, np.abs(v).max())
    ref = np.asarray(jinterp.cubic_map_coordinates(jnp.asarray(v), jnp.asarray(c)))
    got = interp.cubic_map_coordinates(torch.from_numpy(v), torch.from_numpy(c)).numpy()
    _close(got, ref, np.abs(v).max())


@pytest.mark.parametrize("shape", [(6, 7, 5), (2, 9, 3)], ids=str)
def test_nearest_sample_matches_jax(shape):
    v = _vol(shape, seed=6)
    c = _coords(shape, 400, seed=7, lo=-1.0, hi_pad=1.0)
    ref = np.asarray(jinterp.nearest_sample(jnp.asarray(v), jnp.asarray(c)))
    got = interp.nearest_sample(torch.from_numpy(v), torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_interior_matches_scipy_mirror_spline():
    shape = (12, 10, 9)
    v = _vol(shape, seed=8)
    rs = np.random.RandomState(9)
    c = np.stack([rs.uniform(1.0, d - 2.0, 500) for d in shape]).astype(np.float32)
    ref = ndi.map_coordinates(v.astype(np.float64), c.astype(np.float64), order=3, mode="mirror")
    got = interp.cubic_map_coordinates(torch.from_numpy(v), torch.from_numpy(c)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(v).max())


def test_spline_interpolates_the_grid():
    v = _vol((5, 6, 7), seed=10)
    grid = np.stack(np.meshgrid(*[np.arange(d) for d in v.shape], indexing="ij")).reshape(3, -1)
    got = interp.cubic_map_coordinates(torch.from_numpy(v), torch.from_numpy(grid.astype(np.float32)))
    np.testing.assert_allclose(got.numpy(), v.reshape(-1), atol=1e-5 * np.abs(v).max())


def test_cubic_sample_gradient_flows_to_coordinates():
    v = torch.from_numpy(_vol((6, 6, 6), seed=11))
    cp = interp.cubic_coeffs(v)
    c = torch.tensor([[2.3, 1.1], [3.7, 4.2], [0.4, 2.9]], requires_grad=True)
    interp.cubic_sample_coeffs(cp, c).sum().backward()
    assert c.grad is not None and torch.isfinite(c.grad).all() and c.grad.abs().sum() > 0
