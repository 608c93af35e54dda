"""The port's masked-voxel gathers against the JAX package's: the same
values, NaNs passed through, for numpy volumes and for tensors (a CPU
tensor here; a card's tensor takes the same torch gather)."""

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
