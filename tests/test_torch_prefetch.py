"""The port's ``load_to_device`` against ``DicomReader`` and the JAX package.

On the CPU (``device="cpu"``) each group becomes a CPU tensor equal to what
both packages' readers give, uint16 widened to int32. The group parse stays
lazy: group k+1's pixels are parsed only after group k was handed over, so
a copy issued for group k overlaps it. The pinned, side-stream copies to a
card run only on a card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
phase 9 (at full width). With ``sharding=`` each rank of a world places its
own block of every volume (a 2-rank gloo world here).
"""

import numpy as np
import pytest
import torch

import dosma_tpu
import dosma_tpu_torch as dt
from tests.util import write_dicom_series


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


def _check_against_readers(vols, path, **kw):
    host = dt.DicomReader().load(path, **kw)
    jax_vols = dosma_tpu.DicomReader().load(path, **kw)
    assert len(vols) == len(host) == len(jax_vols)
    for v, h, j in zip(vols, host, jax_vols):
        assert isinstance(v.A, torch.Tensor)
        assert v.A.dtype == torch.int32  # uint16 pixels, widened
        np.testing.assert_array_equal(v.A.cpu().numpy(), h.A.astype(np.int32))
        np.testing.assert_array_equal(v.A.cpu().numpy(), np.asarray(j.A).astype(np.int32))
        np.testing.assert_array_equal(v.affine, j.affine)
        assert v.headers().shape == h.headers().shape
        assert v.get_metadata("EchoTime") == j.get_metadata("EchoTime")


@pytest.mark.parametrize("num_workers", [0, 3])
@pytest.mark.parametrize("group_by", ["EchoNumbers", "EchoTime"])
def test_groups_land_on_the_cpu(tmp_path, num_workers, group_by):
    write_dicom_series(str(tmp_path), shape=(12, 10, 3), n_echos=3)
    vols = dt.load_to_device(str(tmp_path), group_by=group_by, device="cpu",
                             num_workers=num_workers)
    _check_against_readers(vols, str(tmp_path), group_by=group_by)


def test_default_device_and_arithmetic(tmp_path):
    write_dicom_series(str(tmp_path), shape=(8, 8, 2), n_echos=2)
    vols = dt.load_to_device(str(tmp_path))  # the default device: the CPU, as asked
    assert all(v.device == dt.cpu_device for v in vols)
    total = vols[0] + vols[1]
    ref = dosma_tpu.DicomReader().load(str(tmp_path))
    np.testing.assert_array_equal(total.A.numpy(),
                                  np.asarray(ref[0].A, np.int64) + np.asarray(ref[1].A))


def test_raises_without_a_card(tmp_path):
    write_dicom_series(str(tmp_path), shape=(8, 8, 2), n_echos=1)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.load_to_device(str(tmp_path), device="cuda")
    dt.set_default_device(None)  # the first card, which this machine lacks
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.load_to_device(str(tmp_path))


def test_sharding_places_a_series_over_two_ranks(tmp_path):
    """``sharding=`` on a gloo world of 2 CPU processes: each rank holds its
    block of every echo along the slices (``torch.chunk``'s split of 5), a
    ``DTensor`` whose whole array equals the readers' volume."""
    from dosma_tpu_torch.parallel.dryrun import launch
    from tests import torch_worlds

    write_dicom_series(str(tmp_path), shape=(12, 10, 5), n_echos=2)
    ranks = launch(torch_worlds.place_series, 2, "gloo", (str(tmp_path),))
    host = dt.DicomReader().load(str(tmp_path))
    for rank, (vols, block) in enumerate(zip(ranks, (slice(0, 3), slice(3, 5)))):
        assert len(vols) == len(host) == 2
        for (placements, local, whole, affine, echo_time), h in zip(vols, host):
            assert placements == [("Shard", 2)]
            assert local.dtype == whole.dtype == np.int32  # uint16 pixels, widened
            np.testing.assert_array_equal(whole, h.A.astype(np.int32))
            np.testing.assert_array_equal(local, h.A[..., block].astype(np.int32))
            np.testing.assert_array_equal(affine, h.affine)
            assert echo_time == h.get_metadata("EchoTime")


def test_group_parse_is_deferred(tmp_path, monkeypatch):
    """Group k+1's pixel parse happens only after group k was yielded."""
    import dosma_tpu_torch.core.io.dicom_io as dio
    from dosma_tpu_torch.core.io.dicom import read_dicom_bytes as real_read

    n_echos, n_slices = 3, 4
    write_dicom_series(str(tmp_path), shape=(10, 10, n_slices), n_echos=n_echos)
    full_parses = []

    def counting_read(data, stop_before_pixels=False):
        if not stop_before_pixels:
            full_parses.append(1)
        return real_read(data, stop_before_pixels=stop_before_pixels)

    monkeypatch.setattr(dio, "read_dicom_bytes", counting_read)
    gen = dio.DicomReader(num_workers=0).iter_groups(str(tmp_path), group_by="EchoNumbers")
    assert full_parses == []
    for k in range(1, n_echos + 1):
        next(gen)
        assert sum(full_parses) == k * n_slices
