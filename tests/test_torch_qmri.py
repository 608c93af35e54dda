"""The port's ``qdess_t2_map``, ``rss_combine`` and ``rms_combine`` against
the JAX package's (XLA on the CPU) on the same echoes.

Tolerances: unrounded maps agree to rtol 1e-5 with identical NaN and zero
placement (float32; the log and division may differ by an ulp between
XLA and torch). Rounded maps (``decimals=1``) are equal, except where the
JAX map's unrounded value lies within 1e-4 of a rounding boundary (a value
an ulp from half way may round to either side). The port returns numpy
for numpy echoes and a tensor on the echoes' device for tensors.
"""

import numpy as np
import pytest
import torch

from dosma_tpu.ops import qmri as jq
from dosma_tpu_torch.ops import qmri as tq


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_PHYSICS = dict(tr=25.0, te=8.0, tg=1560.0, alpha=30.0, gl_area=3132.0, t1=1200.0)


def _echoes(dtype=np.float32, seed=0):
    rs = np.random.RandomState(seed)
    e1 = rs.rand(16, 16, 8) * 900 + 100
    e2 = e1 * (rs.rand(16, 16, 8) * 0.7 + 0.2)
    e1[0, 0, :2] = 0  # ratio inf / NaN: replaced before the log
    e2[1, 1, 1] = 0  # log(0)
    e2[2, 2, 2] = e1[2, 2, 2] * 1.5  # a negative T2, outside the bounds
    e1[3, 3, 3] = e2[3, 3, 3] = 0
    return e1.astype(dtype), e2.astype(dtype)


_CASES = {
    "defaults_unrounded": dict(decimals=None),
    "no_bounds": dict(decimals=None, nan_bounds=None),
    "keep_nan": dict(decimals=None, nan_to_num=None),
    "nan_fill": dict(decimals=None, nan_to_num=-1.0, nan_bounds=(5, 60)),
    "suppress_fat": dict(decimals=None, suppress_fat=True),
    "suppress_fluid": dict(decimals=None, suppress_fluid=True, beta=1.1),
    "both_suppressed": dict(decimals=None, suppress_fat=True, suppress_fluid=True),
    "diffusivity": dict(decimals=None, diffusivity=2.0e-9),
}


def _jax(e1, e2, **kw):
    return np.asarray(jq.qdess_t2_map(e1, e2, **_PHYSICS, **kw))


def _assert_unrounded(got, ref):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_array_equal(got == 0, ref == 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0, equal_nan=True)


@pytest.mark.parametrize("name", list(_CASES))
def test_unrounded_map_matches_jax(name):
    e1, e2 = _echoes()
    got = tq.qdess_t2_map(e1, e2, **_PHYSICS, **_CASES[name])
    assert isinstance(got, np.ndarray)
    _assert_unrounded(got, _jax(e1, e2, **_CASES[name]))


@pytest.mark.parametrize("dtype", [np.uint16, np.float64, np.int16])
def test_echo_dtypes(dtype):
    e1, e2 = _echoes(np.float64)
    e1, e2 = np.round(e1).astype(dtype), np.round(e2).astype(dtype)
    got = tq.qdess_t2_map(e1, e2, **_PHYSICS, decimals=None)
    _assert_unrounded(got, _jax(e1, e2, decimals=None))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rounded_map_matches_jax_off_the_boundaries(seed):
    e1, e2 = _echoes(seed=seed)
    got = tq.qdess_t2_map(e1, e2, **_PHYSICS)  # decimals=1
    ref = _jax(e1, e2)
    unrounded = _jax(e1, e2, decimals=None)
    frac = np.abs(unrounded * 10 - np.floor(unrounded * 10) - 0.5) / 10
    near = frac < 1e-4
    assert near.mean() < 0.01
    np.testing.assert_array_equal(got[~near], ref[~near])
    assert np.all(np.abs(got[near] - ref[near]) <= 0.1 + 1e-5)


@pytest.mark.parametrize("decimals", [0, 1, 2, -1])
def test_rounding_is_jax_around(decimals):
    """The port rounds as XLA computes ``jnp.around`` (times the float32
    reciprocal of the scale), bit for bit, half-way values included (they
    go to even); ``torch.round(x, decimals=d)`` divides instead and differs
    by an ulp on about a fifth of these values."""
    import jax.numpy as jnp

    rs = np.random.RandomState(decimals + 7)
    x = np.concatenate([(rs.rand(20000) * 200 - 50),
                        [0.25, 0.35, 0.45, 2.5, 12.25, 33.75, -0.05, 1.15, 7.05, 0.5, 1.5,
                         -2.5]]).astype(np.float32)
    ref = np.asarray(jnp.around(x, decimals))
    np.testing.assert_array_equal(tq.around(torch.from_numpy(x), decimals).numpy(), ref)
    if decimals == 1:
        divided = torch.round(torch.from_numpy(x), decimals=1).numpy()
        assert 0.05 < np.mean(divided != ref) < 0.5


def test_tensor_echoes_stay_tensors():
    e1, e2 = _echoes()
    got = tq.qdess_t2_map(torch.from_numpy(e1), torch.from_numpy(e2), **_PHYSICS, decimals=None)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    _assert_unrounded(got.numpy(), _jax(e1, e2, decimals=None))


@pytest.mark.parametrize("fn", ["rss_combine", "rms_combine"])
@pytest.mark.parametrize("dtype", [np.float32, np.uint16, np.float64])
def test_combinations_match_jax(fn, dtype):
    e1, e2 = _echoes(np.float64, seed=3)
    e1, e2 = e1.astype(dtype), e2.astype(dtype)
    ref = np.asarray(getattr(jq, fn)(e1, e2))
    got = getattr(tq, fn)(e1, e2)
    assert got.dtype == np.float32 == ref.dtype
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=0)
    on_tensors = getattr(tq, fn)(torch.from_numpy(e1), torch.from_numpy(e2))
    assert isinstance(on_tensors, torch.Tensor)
    np.testing.assert_array_equal(on_tensors.numpy(), got)
