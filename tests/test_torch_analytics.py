"""The port's masked-voxel gathers against the JAX package's: the same
values, NaNs passed through, for numpy volumes and for tensors (a CPU
tensor here; a card's tensor takes the same torch gather). The region
statistics' plain version against the sort-based summary of the same
regions and against the JAX package's to_metrics."""

import warnings

import numpy as np
import pytest
import torch

from dosma_tpu.ops import analytics as ja
from dosma_tpu_torch.ops import analytics as ta


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


@pytest.mark.parametrize("n", [0, 1, 3, 1023, 1024, 1025, 2000])
def test_gather_voxels_matches_jax(n):
    """Every index count, including those around the JAX package's
    power-of-two buckets (which the port does not need)."""
    import jax.numpy as jnp

    rs = np.random.RandomState(0)
    vol = rs.rand(9, 7, 5).astype(np.float32)
    idx = rs.randint(0, vol.size, size=n)
    ref = np.asarray(ja.gather_voxels(jnp.asarray(vol), jnp.asarray(idx)))
    got = ta.gather_voxels(torch.from_numpy(vol), idx)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(ta.gather_voxels(torch.from_numpy(vol), torch.from_numpy(idx)),
                                  ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int16, np.uint16])
@pytest.mark.parametrize("backing", ["numpy", "tensor"])
def test_compressed_values_match_jax(dtype, backing):
    import jax.numpy as jnp

    rs = np.random.RandomState(2)
    vol = (rs.rand(8, 6, 4) * 1000).astype(dtype)
    if vol.dtype.kind == "f":
        vol[vol < 100] = np.nan  # NaNs pass through untouched
    nz = np.nonzero(rs.rand(8, 6, 4) > 0.6)
    ref_host = ja.compressed_values(vol, nz)
    ref_dev = ja.compressed_values(jnp.asarray(vol), nz)
    src = torch.from_numpy(vol) if backing == "tensor" else vol
    got = ta.compressed_values(src, nz)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ref_host)
    if dtype != np.float64:  # JAX's device arrays hold float64 data as float32
        np.testing.assert_array_equal(got, ref_dev)


# ----------------------------------------------------------------------
# region_stats: the plain version (a CPU tensor) against the sort-based
# summary of the same regions and against the JAX package's to_metrics
# ----------------------------------------------------------------------
_SHAPE = (6, 7, 8)


def _region_map(recipe, dtype, seed):
    """A map of _SHAPE for a recipe: "normal" (negatives, ±0.0, NaN, ±inf),
    "ties" (rounded to 1 decimal, few distinct values), "positive"."""
    rs = np.random.RandomState(seed)
    arr = rs.randn(*_SHAPE) * 30 + 20
    if recipe == "ties":
        arr = np.round(rs.rand(*_SHAPE) * 2, 1)
    elif recipe == "positive":
        arr = rs.rand(*_SHAPE) * 90 + 5
    if recipe == "normal":
        flat = arr.reshape(-1)
        flat[::17] = np.nan
        flat[3::29] = np.inf
        flat[5::31] = -np.inf
        flat[7::13] = 0.0
        flat[9::23] = -0.0
        flat[11::37] = 100.0  # on an upper bound
    return arr.astype(dtype)


def _region_mask(kind, dtype, seed):
    """"labels": 0 .. 3 (label 3 listed by no case); "meniscus": 0 .. 12."""
    rs = np.random.RandomState(seed + 1)
    m = rs.randint(0, 13 if kind == "meniscus" else 4, _SHAPE)
    if dtype is bool:
        return m > 0
    return m.astype(dtype)


# name: (map recipe, map dtype, mask kind, mask dtype, labels, bounds, closed)
_REGION_CASES = {
    "right": ("normal", np.float32, "labels", np.uint8, {1: "a", 2: "b"}, (0, 100), "right"),
    "left": ("normal", np.float32, "labels", np.uint8, {1: "a", 2: "b"}, (0, 100), "left"),
    "both": ("normal", np.float32, "labels", np.uint8, {1: "a", 2: "b"}, (-20, 100), "both"),
    "neither": ("normal", np.float32, "labels", np.uint8, {1: "a", 2: "b"}, (0, 100),
                "neither"),
    "no_bounds_negatives": ("normal", np.float32, "labels", np.int16, {2: "b"}, None, "right"),
    "infinite_bound": ("normal", np.float64, "labels", np.int64, {1: "a"}, (0, np.inf),
                       "neither"),
    "ties": ("ties", np.float32, "labels", np.uint8, {1: "a", 2: "b", 3: "c"}, None, "right"),
    "absent_label": ("positive", np.float32, "labels", np.uint8, {1: "a", 9: "absent"}, None,
                     "right"),
    "labels_none": ("normal", np.float32, "labels", np.uint8, None, (0, 100), "right"),
    "meniscus_like": ("positive", np.float32, "meniscus", np.uint8,
                      {i: f"r{i}" for i in range(1, 13)}, (0, np.inf), "neither"),
    "float64_map": ("normal", np.float64, "labels", np.uint8, {1: "a", 2: "b"}, (0, 100),
                    "right"),
    **{f"mask_{np.dtype(t).name}": ("positive", np.float32, "labels", t, {1: "a", 2: "b"},
                                    (0, 100), "right")
       for t in (np.uint16, np.uint32, np.int16, np.int64, np.float32, bool)},
}


def _region_rows_jax(arr, mask, labels, bounds, closed):
    from dosma_tpu.core import quant_vals as jqv

    import dosma_tpu

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        df = jqv.T2(dosma_tpu.MedicalVolume(arr, np.eye(4))).to_metrics(
            dosma_tpu.MedicalVolume(mask, np.eye(4)), labels=labels, bounds=bounds,
            closed=closed)
    return df.to_dict("records")


def _assert_stats_match(stats, summaries, jax_rows):
    """Counts and medians equal to the sort's (the same elements), mean and
    std within 1e-12 of its float64 sums (another order); the JAX package's
    numpy rows to rtol 1e-6 (it reduces a float32 map in float32)."""
    assert stats.shape == (len(summaries), 4)
    for (n, mean, std, median), want, jrow in zip(stats.tolist(), summaries, jax_rows):
        assert n == want["# Voxels"] == jrow["# Voxels"]
        if not n:
            assert np.isnan([mean, std, median]).all()
            continue
        assert median == want["Median"]
        np.testing.assert_allclose([mean, std], [want["Mean"], want["Std"]], rtol=1e-12,
                                   atol=1e-12 * max(1.0, abs(want["Mean"])))
        np.testing.assert_allclose([mean, std, median],
                                   [jrow["Mean"], jrow["Std"], jrow["Median"]], rtol=1e-6)


@pytest.mark.parametrize("chunk", [None, 50], ids=["one_chunk", "chunks_of_50"])
@pytest.mark.parametrize("name", list(_REGION_CASES))
def test_region_stats_match_the_sort_and_jax(name, chunk, monkeypatch):
    recipe, map_dtype, kind, mask_dtype, labels, bounds, closed = _REGION_CASES[name]
    if chunk:
        monkeypatch.setattr(ta, "_chunk", lambda: chunk)
    arr = _region_map(recipe, map_dtype, seed=len(name))
    mask = _region_mask(kind, mask_dtype, seed=len(name))
    jax_rows = _region_rows_jax(arr, mask, labels, bounds, closed)
    if labels is None:
        labels = {int(v): None for v in np.unique(mask[mask > 0])}
    mask_t = torch.from_numpy(mask)
    stats = ta.region_stats(torch.from_numpy(arr), mask_t, list(labels), bounds, closed)
    regions = ta.region_values(torch.from_numpy(arr), mask_t, list(labels), bounds, closed)
    _assert_stats_match(stats, [ta.summary(v) for v in regions], jax_rows)
    torch.testing.assert_close(stats, ta.region_stats_reference(
        torch.from_numpy(arr), mask_t, list(labels), bounds, closed), rtol=0, atol=0,
        equal_nan=True)


@pytest.mark.parametrize("n_valid", [0, 1, 2, 3, 4, 5])
def test_region_stats_of_few_voxels(n_valid):
    """Odd and even counts down to one and no valid voxel: the median of an
    even count is the mean of the two middle values."""
    arr = np.full(_SHAPE, np.nan, np.float32)
    values = np.array([7.5, -2.0, 7.5, 1e-3, 40.0], np.float32)[:n_valid]
    arr.reshape(-1)[5:5 + n_valid] = values
    mask = np.ones(_SHAPE, np.uint8)
    stats = ta.region_stats(torch.from_numpy(arr), torch.from_numpy(mask), [1])
    for n, mean, std, median in stats.tolist():
        assert n == n_valid
        if n_valid:
            ordered = np.sort(values.astype(np.float64))
            assert median == (ordered[(n_valid - 1) // 2] + ordered[n_valid // 2]) / 2
            np.testing.assert_allclose([mean, std], [ordered.mean(), ordered.std()],
                                       rtol=1e-12)
        else:
            assert np.isnan([mean, std, median]).all()


def test_region_stats_without_a_mask_take_every_valid_voxel():
    arr = _region_map("normal", np.float32, seed=3)
    v = torch.from_numpy(arr)
    (row,) = ta.region_stats(v, None, [], (0, 100), "both").tolist()
    want = ta.summary(v.reshape(-1)[torch.isfinite(v.reshape(-1)) & (v.reshape(-1) >= 0)
                                    & (v.reshape(-1) <= 100)])
    assert row[0] == want["# Voxels"] and row[3] == want["Median"]
    np.testing.assert_allclose(row[1:3], [want["Mean"], want["Std"]], rtol=1e-12)


def test_region_stats_refuse_bad_input():
    v, m = torch.zeros(4), torch.ones(4, dtype=torch.uint8)
    with pytest.raises(ValueError, match="lower"):
        ta.region_stats(v, m, [1], (5, 1))
    with pytest.raises(ValueError, match="closed"):
        ta.region_stats(v, m, [1], (0, 1), "sideways")
    with pytest.raises(ValueError, match="integer"):
        ta.region_stats(v, m, [1.5])
    with pytest.raises(ValueError, match="does not match"):
        ta.region_stats(v, torch.ones(5, dtype=torch.uint8), [1])
