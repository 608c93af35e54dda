"""Tests of the port that need a CUDA card; each skips without one.

This file imports neither jax nor the JAX package, so that it runs on the
machine with the card, which has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports jax).
"""

import os

import numpy as np
import pytest
import torch

import dosma_tpu_torch as dt
from dosma_tpu_torch.utils.profiling import counters


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _write_series(path, shape=(64, 48, 6), echo_times=(10.0, 20.0, 30.0, 40.0)):
    """A uint16 multi-echo series written by the port's DicomWriter; the
    pixels, (rows, cols, slices, echoes)."""
    from dosma_tpu_torch.core.io.dicom import Dataset
    from dosma_tpu_torch.core.io.dicom.writer import generate_uid

    rs = np.random.RandomState(0)
    pixels = (rs.rand(*shape, len(echo_times)) * 60000).astype(np.uint16)
    headers = np.empty((1, 1, shape[2], len(echo_times)), dtype=object)
    series = generate_uid()
    for e, te in enumerate(echo_times):
        for s in range(shape[2]):
            ds = Dataset()
            ds.SOPInstanceUID = generate_uid()
            ds.SeriesInstanceUID = series
            ds.Modality = "MR"
            ds.InstanceNumber = e * shape[2] + s + 1
            ds.EchoNumbers = e + 1
            ds.EchoTime = te
            ds.Rows, ds.Columns = shape[0], shape[1]
            ds.BitsAllocated, ds.BitsStored, ds.HighBit = 16, 16, 15
            ds.PixelRepresentation = 0
            ds.SamplesPerPixel = 1
            ds.PhotometricInterpretation = "MONOCHROME2"
            ds.PixelSpacing = [0.5, 0.5]
            ds.SliceThickness = 2.0
            ds.ImagePositionPatient = [0.0, 0.0, 2.0 * s]
            ds.ImageOrientationPatient = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
            headers[0, 0, s, e] = ds
    from dosma_tpu_torch.core.io.dicom_io import to_RAS_affine

    affine = to_RAS_affine(list(headers[0, 0, :, 0]))
    dt.DicomWriter().save(dt.MedicalVolume(pixels, affine, headers=headers), path)
    return pixels


@pytest.mark.cuda
def test_load_to_device_lands_on_the_card(tmp_path, card):
    pixels = _write_series(str(tmp_path))
    host = dt.DicomReader().load(str(tmp_path))
    # The second load reuses the pinned buffers the first one dropped.
    for vols in [dt.load_to_device(str(tmp_path), device=card) for _ in range(2)]:
        assert len(vols) == len(host) == pixels.shape[-1]
        for e, (v, h) in enumerate(zip(vols, host)):
            assert v.A.device == card and v.A.dtype == torch.int32
            # usable on the caller's stream at once
            assert torch.equal(v.A, torch.from_numpy(pixels[..., e]).to(card).to(torch.int32))
            np.testing.assert_array_equal(v.affine, h.affine)
            assert v.get_metadata("EchoTime") == h.get_metadata("EchoTime")


@pytest.mark.cuda
def test_card_volumes_fit_reduce_and_write(tmp_path, card):
    """uint16 pixels arrive widened, and the ops that raised on unsigned
    tensors (flip, comparison, arithmetic) work on the card."""
    pixels = _write_series(str(tmp_path / "series"))
    vols = dt.load_to_device(str(tmp_path / "series"), device=card)
    flipped = vols[0].reformat(vols[0].orientation[::-1])
    back = flipped.reformat(vols[0].orientation)
    assert torch.equal(back.A, vols[0].A)
    assert int((vols[0] > 30000).A.sum()) == int((pixels[..., 0] > 30000).sum())
    total = vols[0] + vols[1]
    assert torch.equal(total.A.cpu(), torch.from_numpy(pixels[..., 0].astype(np.int32)
                                                       + pixels[..., 1]))
    mask = dt.MedicalVolume((pixels[..., 0] > 20000).astype(np.uint16), vols[0].affine)
    tc, _ = dt.MonoExponentialFit(tc0="polyfit").fit(
        [v.get_metadata("EchoTime") for v in vols], vols)
    rows = dt.T2(tc).metric_rows(mask)
    assert rows[-1]["# Voxels"] <= int(mask.A.sum())
    dt.DicomWriter().save(vols[1], str(tmp_path / "echo2"))
    again = dt.DicomReader().load(str(tmp_path / "echo2"))[0]
    np.testing.assert_array_equal(again.A, pixels[..., 1])
    assert os.path.isdir(tmp_path / "echo2")


def _unet_probs(net, x, device, dtype):
    from dosma_tpu_torch.models.unet2d import cudnn_exact

    net = net.to(device=device, dtype=dtype)
    with torch.inference_mode(), cudnn_exact():
        return net(x.to(device=device, dtype=dtype)).to(torch.float64).cpu()


@pytest.mark.cuda
def test_unet_float32_forward_is_cudnn_exact_with_tf32_allowed(card):
    """With the process-wide cudnn.allow_tf32 True (PyTorch's default), the
    card's float32 probabilities stay within 1e-4 of a float64 CPU forward:
    the forward scopes TF32 off. A mask may differ only within 1e-4 of 0.5."""
    from dosma_tpu_torch.models.unet2d import UNet2D, init_unet2d_params

    params = init_unet2d_params(torch.Generator().manual_seed(0), num_classes=4)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 1, 128, 128).astype(np.float32))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = _unet_probs(UNet2D.from_params(params), x, card, torch.float32)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    want = _unet_probs(UNet2D.from_params(params), x, "cpu", torch.float64)
    assert float((got - want).abs().max()) <= 1e-4
    flips = (got > 0.5) != (want > 0.5)
    assert bool(((want[flips] - 0.5).abs() <= 1e-4).all())


@pytest.mark.cuda
def test_generate_mask_of_a_card_volume_equals_the_host_volume(card):
    """A host volume (float32 or uint16) goes to the card once; the same
    volume already on the card gives the same host uint8 masks."""
    from dosma_tpu_torch.models import IWOAIOAIUnet2DNormalized, OAIUnet2D
    from dosma_tpu_torch.models.unet2d import init_unet2d_params

    rs = np.random.RandomState(2)
    for cls, classes in ((IWOAIOAIUnet2DNormalized, 4), (OAIUnet2D, 1)):
        model = cls((96, 96, 1), None, force_weights=True)
        model.seg_model.params = init_unet2d_params(torch.Generator().manual_seed(3),
                                                    num_classes=classes,
                                                    features=[8, 16, 32, 64, 128, 256])
        for arr in (rs.rand(96, 96, 7).astype(np.float32) * 1000,
                    (rs.rand(96, 96, 7) * 4000).astype(np.uint16)):
            host = dt.MedicalVolume(arr, dt.to_affine(dt.SAGITTAL)).reformat(dt.AXIAL)
            want = model.generate_mask(host)
            got = model.generate_mask(host.to(card))
            pairs = [(want, got)] if classes == 1 else [(want[k], got[k]) for k in want]
            for w, g in pairs:
                assert isinstance(g.volume, np.ndarray) and g.volume.dtype == np.uint8
                assert g.orientation == host.orientation
                np.testing.assert_array_equal(g.volume, w.volume)


@pytest.mark.cuda
def test_copy_to_host_async_of_a_card_volume(card):
    """The copy goes to a pinned buffer; ``cpu()`` waits on its event and
    hands the buffer over once; writing the pixels drops the copy."""
    arr = np.random.RandomState(1).rand(32, 24, 8).astype(np.float32)
    mv = dt.MedicalVolume(torch.from_numpy(arr).to(card), np.eye(4))
    assert mv.copy_to_host_async() is mv
    pending = mv._host_copy
    assert pending[0] is mv.volume and pending[1].is_pinned()
    assert mv.copy_to_host_async()._host_copy is pending  # already under way
    host = mv.cpu()
    assert isinstance(host.volume, np.ndarray) and mv._host_copy is None
    np.testing.assert_array_equal(host.volume, arr)
    assert host.volume.ctypes.data == pending[1].data_ptr()  # the buffer, not a new copy
    mv.copy_to_host_async()
    mv[0] = 5.0
    assert mv._host_copy is None and float(mv.cpu().volume[0, 0, 0]) == 5.0
    mv.copy_to_host_async()
    mv += 1.0
    assert mv._host_copy is None and float(mv.cpu().volume[0, 0, 0]) == 6.0
    mv.copy_to_host_async()
    flipped = mv.reformat(mv.orientation[::-1], inplace=True)
    assert flipped._host_copy[0] is not flipped.volume  # stale: a fresh copy is made
    np.testing.assert_array_equal(flipped.cpu().volume, flipped.volume.cpu().numpy())


def _write_qdess_series(path, shape=(48, 40, 6)):
    """A two-echo sagittal qDESS series (uint16) with TR, TE, the flip angle
    and the private spoiler tags, written by the port's DicomWriter."""
    from dosma_tpu_torch.core.io.dicom import Dataset, Tag
    from dosma_tpu_torch.core.io.dicom.writer import generate_uid
    from dosma_tpu_torch.core.io.dicom_io import to_RAS_affine

    rs = np.random.RandomState(2)
    e1 = (rs.rand(*shape) * 900 + 100).astype(np.uint16)
    pixels = np.stack([e1, (e1 * rs.uniform(0.2, 0.6, shape)).astype(np.uint16)], axis=-1)
    headers = np.empty((1, 1, shape[2], 2), dtype=object)
    series = generate_uid()
    for e, te in enumerate((8.0, 42.0)):
        for s in range(shape[2]):
            ds = Dataset()
            ds.SOPInstanceUID = generate_uid()
            ds.SeriesInstanceUID = series
            ds.Modality = "MR"
            ds.InstanceNumber = e * shape[2] + s + 1
            ds.EchoNumbers = e + 1
            ds.EchoTime = te
            ds.RepetitionTime = 25.0
            ds.FlipAngle = 30.0
            ds.Rows, ds.Columns = shape[0], shape[1]
            ds.BitsAllocated, ds.BitsStored, ds.HighBit = 16, 16, 15
            ds.PixelRepresentation = 0
            ds.SamplesPerPixel = 1
            ds.PhotometricInterpretation = "MONOCHROME2"
            ds.PixelSpacing = [0.3, 0.3]
            ds.SliceThickness = 0.7
            ds.ImagePositionPatient = [0.7 * s, 0.0, 0.0]
            ds.ImageOrientationPatient = [0.0, 1.0, 0.0, 0.0, 0.0, -1.0]
            ds[Tag(0x0019, 0x10B6)] = 3132.0
            ds[Tag(0x0019, 0x10B7)] = 1560.0
            headers[0, 0, s, e] = ds
    affine = to_RAS_affine(list(headers[0, 0, :, 0]))
    dt.DicomWriter().save(dt.MedicalVolume(pixels, affine, headers=headers), path)
    return pixels, affine


def _arc(shape):
    h, w, d = shape
    yv, xv = np.mgrid[0:h, 0:w]
    rad = np.sqrt((yv - h * 0.45) ** 2 + (xv - w * 0.5) ** 2)
    arc = (rad > h * 0.24) & (rad < h * 0.315) & (yv > h * 0.45)
    return np.repeat(arc[..., None], d, axis=2).astype(np.uint8)


@pytest.mark.cuda
def test_qdess_femoral_rows_on_the_card_equal_the_cpu(tmp_path, card):
    """from_dicom(to_device=True) -> generate_t2_map -> femoral cartilage's
    rows on the card, against the same on the CPU: categories and counts
    exactly, statistics and unrolled maps within rtol 1e-9. The map stays
    on the card."""
    pixels, affine = _write_qdess_series(str(tmp_path / "series"))
    arc = dt.MedicalVolume(_arc(pixels.shape[:3]), affine)

    def rows(device):
        with dt.default_device(device):
            scan = dt.QDess.from_dicom(str(tmp_path / "series"), to_device=True)
            fc = dt.FemoralCartilage()
            fc.set_mask(arc, use_largest_cc=False)
            qv = scan.generate_t2_map(tissue=fc)
            assert qv.volumetric_map.volume.device.type == torch.device(device).type
            return fc.quant_rows(qv.volumetric_map, qv.qv_type)

    (header, got, maps), (_, want, maps_cpu) = rows(card), rows("cpu")
    stats = [header.index(c) for c in ("Mean", "Std", "Median")]
    assert len(got) == 18 and 0 < sum(r[-1] for r in got[12:]) <= int(arc.volume.sum())
    for r, w in zip(got, want):
        assert [v for i, v in enumerate(r) if i not in stats] == \
            [v for i, v in enumerate(w) if i not in stats]
        np.testing.assert_allclose([r[i] for i in stats], [w[i] for i in stats],
                                   rtol=1e-9, atol=0, equal_nan=True)
    for m, w in zip(maps, maps_cpu):
        np.testing.assert_array_equal(np.isnan(m["data"]), np.isnan(w["data"]))
        np.testing.assert_allclose(m["data"], w["data"], rtol=1e-9, atol=0, equal_nan=True)


def _write_cubequant_series(path, shape=(48, 48, 16), times=(1.0, 10.0, 30.0, 60.0)):
    """bench.py's config 3 at a small size (a bright box plus noise, spin
    lock i rolled by (i, -i, 0)) as a uint16 sagittal series with EchoTime
    = the spin-lock time; returns the affine."""
    from dosma_tpu_torch.core.io.dicom import Dataset
    from dosma_tpu_torch.core.io.dicom.writer import generate_uid
    from dosma_tpu_torch.core.io.dicom_io import to_RAS_affine

    rs = np.random.RandomState(3)
    relax = rs.rand(*shape).astype(np.float32) * 80 + 20
    base = np.zeros(shape, np.float32)
    base[shape[0] // 4: -(shape[0] // 4), shape[1] // 4: -(shape[1] // 4), 2:-2] = 1000.0
    base += 50.0 * rs.rand(*shape).astype(np.float32)
    pixels = np.stack([np.rint(np.roll(base * np.exp(-t / relax), (i, -i, 0), axis=(0, 1, 2)))
                       .astype(np.uint16) for i, t in enumerate(times)], axis=-1)
    series = generate_uid()
    headers = np.empty((1, 1, shape[2], len(times)), dtype=object)
    for e, t in enumerate(times):
        for s in range(shape[2]):
            ds = Dataset()
            ds.SOPInstanceUID = generate_uid()
            ds.SeriesInstanceUID = series
            ds.Modality = "MR"
            ds.InstanceNumber = e * shape[2] + s + 1
            ds.EchoNumbers = e + 1
            ds.EchoTime = t
            ds.Rows, ds.Columns = shape[0], shape[1]
            ds.BitsAllocated, ds.BitsStored, ds.HighBit = 16, 16, 15
            ds.PixelRepresentation = 0
            ds.SamplesPerPixel = 1
            ds.PhotometricInterpretation = "MONOCHROME2"
            ds.PixelSpacing = [0.5, 0.5]
            ds.SliceThickness = 1.0
            ds.ImagePositionPatient = [1.0 * s, 0.0, 0.0]
            ds.ImageOrientationPatient = [0.0, 1.0, 0.0, 0.0, 0.0, -1.0]
            headers[0, 0, s, e] = ds
    affine = to_RAS_affine(list(headers[0, 0, :, 0]))
    dt.DicomWriter().save(dt.MedicalVolume(pixels, affine, headers=headers), path)
    return affine


@pytest.mark.cuda
def test_cubequant_path_on_the_card(tmp_path, card):
    """from_dicom(to_device=True) -> intraregister -> interregister ->
    generate_t1_rho_map on the card: one warp_grid launch per registration
    and one monoexp_lm launch for the map, which stays on the card and
    equals the CPU's fit of the same registered volumes."""

    affine = _write_cubequant_series(str(tmp_path / "series"))
    scan = dt.CubeQuant.from_dicom(str(tmp_path / "series"), to_device=True)
    assert scan.spin_lock_times == [1.0, 10.0, 30.0, 60.0]
    target = np.roll(scan.volumes[0].cpu().A.astype(np.float32), (2, -1, 1), axis=(0, 1, 2))
    target_path = str(tmp_path / "target.nii.gz")
    dt.MedicalVolume(target, affine).save_volume(target_path)
    scan.temp_path = str(tmp_path / "scan")

    counters["warp_grid.launches"] = 0
    scan.intraregister()
    assert counters["warp_grid.launches"] == 1
    scan.interregister(target_path)
    assert counters["warp_grid.launches"] == 2
    assert all(v.volume.is_cuda for v in scan.volumes)
    counters["monoexp_lm.launches"] = 0
    qv = scan.generate_t1_rho_map()
    assert counters["monoexp_lm.launches"] == 1 and qv.volumetric_map.volume.is_cuda

    with dt.default_device("cpu"):
        host = dt.CubeQuant([v.cpu() for v in scan.volumes], scan.spin_lock_times)
        want = host.generate_t1_rho_map()
    # The card's exp and log differ from the CPU's by ulps, so the two LM
    # runs stop apart: the port's tolerance for fits of noisy data (the
    # registered volumes are interpolated, not exact exponentials), 1e-3
    # relative, plus the rounding to 3 decimals, on the box's voxels. The
    # background's integer signals of 0..50 make ill-conditioned fits, which
    # those ulps move further (43 of 36,864 voxels, up to 0.171, in this
    # test's first card run); there only the zeros are compared.
    got, ref = qv.volumetric_map.cpu().A, want.volumetric_map.A
    np.testing.assert_array_equal(got == 0, ref == 0)
    box = host.volumes[0].A >= 500  # an amplitude of 1000 against 0..50
    assert box.sum() > 0.15 * box.size
    excess = np.abs(got - ref)[box] - (1e-3 + 1e-3 * np.abs(ref[box]))
    assert (excess <= 0).all(), (int((excess > 0).sum()), float(excess.max()))
    np.testing.assert_allclose(qv.additional_volumes["r2"].cpu().A[box],
                               want.additional_volumes["r2"].A[box], rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_sharded_lm_fit_launches_the_kernel_once(card):
    """At a world of one rank the sharded fit is one monoexp_lm launch on
    the card, whose rows equal the unsharded kernel's bit for bit."""
    from dosma_tpu_torch.ops import monoexp
    from dosma_tpu_torch.parallel.sharding import sharded_lm_fit

    rs = np.random.RandomState(0)
    x = np.array([10.0, 20.0, 30.0, 40.0], np.float32)
    b = -1 / (rs.rand(1001).astype(np.float32) * 70 + 10)
    Y = np.exp(b[:, None] * x[None, :]).astype(np.float32)
    p0 = np.array([1.0, -1 / 30], np.float32)
    before = counters["monoexp_lm.launches"]
    popt, r2, conv = sharded_lm_fit(dt.monoexponential, x, Y, p0, max_iter=50)
    assert counters["monoexp_lm.launches"] == before + 1
    ref = monoexp.monoexp_lm(x, torch.from_numpy(Y).to(card), p0, max_iter=50)
    np.testing.assert_array_equal(popt, ref[0].cpu().numpy())
    np.testing.assert_array_equal(r2, ref[1].cpu().numpy())
    assert conv.mean() > 0.95


@pytest.mark.cuda
def test_sharded_fit_under_a_gloo_group_runs_on_the_card(card):
    """A rank of a gloo world whose default device is the first card fits a
    card ``Y`` and a host ``Y`` with one monoexp_lm launch each, on the
    card, with the unsharded kernel's rows."""
    from dosma_tpu_torch.ops import monoexp
    from dosma_tpu_torch.parallel.dryrun import launch
    from tests import torch_worlds

    (got,) = launch(torch_worlds.card_default_fits, 1, "gloo", timeout=300)
    x, Y, p0 = torch_worlds._mono_case()
    want = monoexp.monoexp_lm(x, torch.from_numpy(Y).to(card), p0)[0].cpu().numpy()
    assert got["card"][:2] == (1, "cuda:0") and got["host"][:2] == (1, "numpy"), got
    np.testing.assert_array_equal(got["card"][2], want)
    np.testing.assert_array_equal(got["host"][2], want)


@pytest.mark.cuda
def test_trainer_steps_on_the_card(card):
    """A narrow U-Net trains on the card at a world of one rank: finite,
    falling losses, gradients equal to the CPU's to 1e-4 of each leaf."""
    from dosma_tpu_torch.models.unet2d import init_unet2d_params
    from dosma_tpu_torch.models.weights import params_from_state_dict, state_dict_from_params
    from dosma_tpu_torch.train import SegTrainer

    params = params_from_state_dict(state_dict_from_params(init_unet2d_params(
        torch.Generator().manual_seed(0), features=(8, 16, 256))))
    rs = np.random.RandomState(0)
    images = rs.rand(4, 32, 32, 1).astype(np.float32)
    labels = (images > 0.5).astype(np.float32)
    trainer = SegTrainer(params=params)
    assert trainer.params["final.bias"].device.type == "cuda"
    _, g_card = trainer.loss_and_grads(images, labels)
    with dt.default_device("cpu"):
        _, g_cpu = SegTrainer(params=params).loss_and_grads(images, labels)
    for blk_c, blk_h in zip(g_card["down"] + g_card["up"], g_cpu["down"] + g_cpu["up"]):
        for a, b in ((blk_c["conv1"]["w"], blk_h["conv1"]["w"]),
                     (blk_c["bn"]["mean"], blk_h["bn"]["mean"])):
            assert np.linalg.norm(a - b) <= 1e-4 * np.linalg.norm(b)
    losses = [trainer.step(images, labels) for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.cuda
def test_train_step_counts_the_batch_crossing(card):
    """``SegTrainer.step`` moves the batch through ``as_tensor``: the float32
    images and labels count once in ``h2d.bytes``, and the placed batch is
    the host arrays' values in NCHW."""
    from dosma_tpu_torch.models.unet2d import init_unet2d_params
    from dosma_tpu_torch.train import SegTrainer

    params = init_unet2d_params(torch.Generator().manual_seed(0), num_classes=2,
                                features=(8, 16, 32))
    rs = np.random.RandomState(0)
    images = rs.rand(4, 32, 32, 1).astype(np.float32)
    labels = (rs.rand(4, 32, 32, 2) > 0.5).astype(np.uint8)
    trainer = SegTrainer(num_classes=2, features=(8, 16, 32), params=params)
    before = dict(counters)
    x, y = trainer._step.place_batch(images, labels)
    assert x.device.type == y.device.type == "cuda"
    assert counters["h2d.bytes"] - before.get("h2d.bytes", 0) == 4 * 32 * 32 * (1 + 2) * 4
    np.testing.assert_array_equal(x.cpu().numpy(), images.transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(y.cpu().numpy(), labels.transpose(0, 3, 1, 2))
    before = dict(counters)
    assert np.isfinite(trainer.step(images, labels))
    assert counters["h2d.bytes"] - before.get("h2d.bytes", 0) == 4 * 32 * 32 * (1 + 2) * 4


_IOPS = ("__iadd__", "__isub__", "__imul__", "__itruediv__", "__ifloordiv__", "__ipow__")
_BINOPS = ("__add__", "__sub__", "__mul__", "__truediv__", "__floordiv__", "__pow__")


@pytest.mark.cuda
@pytest.mark.parametrize("operand", ["host array", "host volume"])
@pytest.mark.parametrize("iop,op", list(zip(_IOPS, _BINOPS)), ids=_IOPS)
def test_card_volume_inplace_with_a_host_operand(iop, op, operand, card):
    """A card volume's in-place operators take host operands: the operand
    moves to the card, and the result equals the CPU tensor volume's binary
    operator on the same values, on the card."""
    rs = np.random.RandomState(3)
    arr = rs.uniform(1, 2, (6, 5, 4)).astype(np.float32)
    other = rs.uniform(1, 2, (6, 5, 4)).astype(np.float32)
    mv = dt.MedicalVolume(torch.from_numpy(arr).to(card), np.eye(4))
    host_other = other if operand == "host array" else dt.MedicalVolume(other, np.eye(4))
    want = getattr(dt.MedicalVolume(torch.from_numpy(arr), np.eye(4)), op)(
        dt.MedicalVolume(torch.from_numpy(other), np.eye(4)))
    assert getattr(mv, iop)(host_other) is mv
    assert mv.A.device == card and mv.dtype == want.dtype
    torch.testing.assert_close(mv.A.cpu(), want.A, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_host_volume_inplace_with_a_card_operand_raises_the_device_error(card):
    host = dt.MedicalVolume(np.ones((2, 3, 4), np.float32), np.eye(4))
    on_card = dt.MedicalVolume(torch.ones(2, 3, 4, device=card), np.eye(4))
    with pytest.raises(RuntimeError, match="Expected device"):
        host + on_card
    with pytest.raises(RuntimeError, match="Expected device"):
        host += on_card
    assert isinstance(host.A, np.ndarray) and float(host.A[0, 0, 0]) == 1.0


@pytest.mark.cuda
def test_to_torch_and_from_torch_stay_on_the_card(card):
    t = torch.rand(4, 5, 6, device=card)
    mv = dt.MedicalVolume.from_torch(t, torch.eye(4))
    assert mv.A.device == card and mv.A.data_ptr() == t.data_ptr()
    assert mv.to_torch().data_ptr() == t.data_ptr()
    c = dt.MedicalVolume.from_torch(torch.rand(4, 5, 6, 2, device=card), np.eye(4),
                                    to_complex=True)
    assert c.A.device == card and c.dtype == torch.complex64
    with pytest.raises(RuntimeError, match="cpu"):
        dt.MedicalVolume.from_torch(t, torch.eye(4, device=card))
    img = mv.to_sitk(headless=True)  # copied to the host once
    np.testing.assert_array_equal(img.array_from_image(), t.cpu().numpy().transpose(2, 1, 0))


@pytest.mark.cuda
def test_device_at_sends_host_data_to_the_card(card):
    host = dt.MedicalVolume(np.ones((2, 3, 4), np.float32), np.eye(4))
    with dt.cpu_device.at():
        with dt.Device("cuda").at() as dev:
            assert dev == dt.Device(0) and dev.xp is torch and dev.to_torch() == card
            assert host.device_put().A.device == card
        assert host.device_put().A.device.type == "cpu"
        with dt.Device("cuda:0"):
            assert host.device_put().A.device == card
    assert dt.get_array_module(host.device_put(card)) is torch


@pytest.mark.cuda
def test_viewer_copies_a_card_volume_once(card, monkeypatch):
    from dosma_tpu_torch.gui.im_viewer import ImageViewer

    copies = []
    original = torch.Tensor.cpu

    def counting(self, *a, **k):
        if self.is_cuda:
            copies.append(self.numel())
        return original(self, *a, **k)

    arr = np.random.RandomState(0).rand(8, 6, 5).astype(np.float32)
    vol = dt.MedicalVolume(torch.from_numpy(arr).to(card), np.eye(4))
    viewer = ImageViewer.__new__(ImageViewer)
    viewer._volume = viewer._mask = viewer._volume_arr = viewer._mask_arr = None
    viewer._index, viewer._alpha = 0, 0.3

    class Slider:
        def configure(self, **kw):
            pass

        def set(self, v):
            pass

    class Up:
        button = "up"

    viewer.slider, viewer._draw = Slider(), lambda: None
    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    viewer.set_volume(vol)
    for _ in range(4):
        viewer._on_scroll(Up())
    assert copies == [arr.size]
    np.testing.assert_array_equal(viewer._volume_arr, arr)


def _region_inputs(n, map_dtype, mask_dtype, nlabels, seed):
    """A map with heavy ties (most values rounded to 1 decimal), NaN, ±inf,
    ±0 and negative values, and a mask of 0 .. nlabels + 1 (the last value
    listed by no caller), as tensors on the CPU."""
    rs = np.random.RandomState(seed)
    values = rs.randn(n) * 20 + 30
    tied = rs.rand(n) < 0.8
    values[tied] = np.round(values[tied], 1)
    for special, share in ((np.nan, 0.02), (np.inf, 0.01), (-np.inf, 0.01), (0.0, 0.02),
                           (-0.0, 0.02)):
        values[rs.rand(n) < share] = special
    mask = rs.randint(0, nlabels + 2, n)
    if mask_dtype == torch.bool:
        mask = mask > 0
    return (torch.from_numpy(values).to(map_dtype),
            torch.from_numpy(mask.astype(np.int64)).to(mask_dtype))


def _assert_stats_agree(got, want):
    """Counts and medians bit for bit (the same elements); mean and std to
    1e-12 relative: their float64 sums run in another order."""
    got, want = got.cpu(), want.cpu()
    assert torch.equal(got[:, 0], want[:, 0])
    assert torch.equal(got[:, 3].isnan(), want[:, 3].isnan())
    assert torch.equal(got[:, 3].nan_to_num(), want[:, 3].nan_to_num())
    torch.testing.assert_close(got[:, 1:3], want[:, 1:3], rtol=1e-12, atol=1e-12 * 100,
                               equal_nan=True)


_REGION_CASES = {
    # name: (voxels, map dtype, mask dtype, labels, bounds, closed)
    "f32_u8_two_labels": (300_001, torch.float32, torch.uint8, [1, 2], (0, 100), "right"),
    "f64_u8_two_labels": (300_001, torch.float64, torch.uint8, [1, 2], (0, 100), "right"),
    "f32_bool": (70_000, torch.float32, torch.bool, [1], None, "right"),
    "f32_i16_left": (70_000, torch.float32, torch.int16, [2, 1, 9], (-10, 50), "left"),
    "f32_u16_both": (70_000, torch.float32, torch.uint16, [1, 3], (0, 50), "both"),
    "f32_u32_neither": (70_000, torch.float32, torch.uint32, [3], (0, float("inf")), "neither"),
    "f32_i32": (70_000, torch.float32, torch.int32, [1, 2, 3, 4, 5], None, "right"),
    "f64_i64": (70_000, torch.float64, torch.int64, [4, 2], (-1e3, 1e3), "both"),
    "f32_f32_mask": (70_000, torch.float32, torch.float32, [1, 2], None, "right"),
    "f64_f64_mask": (70_000, torch.float64, torch.float64, [2], (0, 60), "right"),
    "meniscus_like": (200_000, torch.float32, torch.uint8, list(range(1, 13)), (0, float("inf")),
                      "neither"),
    "most_labels": (50_000, torch.float32, torch.int32, list(range(1, 129)), None, "right"),
    "one_voxel": (1, torch.float32, torch.uint8, [1], None, "right"),
    "no_voxel": (0, torch.float32, torch.uint8, [1], None, "right"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_REGION_CASES))
def test_region_stats_kernel_matches_its_plain_version(name, card):
    from dosma_tpu_torch.ops.analytics import region_stats, region_stats_reference

    n, map_dtype, mask_dtype, labels, bounds, closed = _REGION_CASES[name]
    values, mask = _region_inputs(n, map_dtype, mask_dtype, max(*labels, 3), seed=n)
    want = region_stats_reference(values, mask, labels, bounds, closed)
    got = region_stats(values.to(card), mask.to(card), labels, bounds, closed)
    assert got.device == card and got.shape == (len(labels) + 1, 4)
    _assert_stats_agree(got, want)
    no_mask = region_stats(values.to(card), None, [], bounds, closed)
    _assert_stats_agree(no_mask, region_stats_reference(values, None, [], bounds, closed))


@pytest.mark.cuda
def test_region_stats_twice_gives_the_same_bits(card):
    """No floating-point atomics: the partial sums reduce in a fixed order."""
    from dosma_tpu_torch.ops.analytics import region_stats

    values, mask = _region_inputs(2_000_003, torch.float32, torch.uint8, 3, seed=5)
    values, mask = values.to(card), mask.to(card)
    first = region_stats(values, mask, [1, 2, 3], (0, 100))
    second = region_stats(values, mask, [1, 2, 3], (0, 100))
    assert torch.equal(first.view(torch.int64), second.view(torch.int64))


@pytest.mark.cuda
def test_region_stats_refuses_more_labels_than_the_kernel_holds(card):
    from dosma_tpu_torch.ops.analytics import region_stats

    values, mask = _region_inputs(1000, torch.float32, torch.int32, 3, seed=1)
    with pytest.raises(ValueError, match="at most 128 labels"):
        region_stats(values.to(card), mask.to(card), list(range(1, 130)))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["host map, cpu default", "host map, card default",
                                   "card map"])
def test_metric_rows_launch_the_kernel_once_on_a_card_map(where, card):
    """metric_rows computes a card map on the card and a host map on the
    default device: one region_stats launch on a card, none on the CPU. A
    host map on a card crosses once, with its mask (``h2d.bytes``), and
    counts in ``region_stats.host_maps``; a card map crosses nothing but
    its host mask. The rows equal the plain version's on the host (fns from
    the host values)."""
    from dosma_tpu_torch.ops.analytics import region_stats_reference

    values, mask = _region_inputs(64 * 48 * 6, torch.float32, torch.uint8, 2, seed=3)
    affine = np.eye(4)
    map_mv = dt.MedicalVolume(values.reshape(64, 48, 6).numpy(), affine)
    mask_mv = dt.MedicalVolume(mask.reshape(64, 48, 6).numpy(), affine)
    labels, bounds = {1: "a", 2: "b"}, (0, 100)
    fns = {"Max": lambda v: float(np.max(v)) if v.size else np.nan}
    if where == "card map":
        map_mv = map_mv.to(card)
    names = ("region_stats.launches", "region_stats.host_maps", "h2d.bytes")
    before = [counters[name] for name in names]
    with dt.default_device("cpu" if where == "host map, cpu default" else card):
        rows = dt.T2(map_mv).metric_rows(mask_mv, labels, bounds, fns=fns)
    added = [counters[name] - b for name, b in zip(names, before)]
    map_bytes, mask_bytes = values.numel() * 4, mask.numel()
    assert added == {"host map, cpu default": [0, 0, 0],
                     "host map, card default": [1, 1, map_bytes + mask_bytes],
                     "card map": [1, 0, mask_bytes]}[where]

    want = region_stats_reference(values, mask, list(labels), bounds).tolist()
    valid = torch.isfinite(values) & (values > 0) & (values <= 100)
    regions = [valid & (mask == 1), valid & (mask == 2), valid & (mask > 0)]
    assert [row["Category"] for row in rows] == ["a", "b", "total"]
    for row, (n, mean, std, median), region in zip(rows, want, regions):
        assert row["# Voxels"] == n and row["Median"] == median
        assert row["Max"] == float(values[region].max())
        np.testing.assert_allclose([row["Mean"], row["Std"]], [mean, std], rtol=1e-12)


def _maps_echoes(T, uniform, N, seed, device):
    """(x (T,) host, yT (T, N) on ``device``): config1-like noisy decays with
    the edge voxels up front: all zero, constant, growing, negated, one zero
    echo, time constants far outside the echoes, a NaN and an inf echo."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = ((10.0 * np.arange(1, T + 1)) if uniform
         else np.sort(np.random.RandomState(T).rand(T) * 60 + 3)).astype(np.float32)
    xt = torch.from_numpy(x).to(device)
    b = -1.0 / (torch.rand(N, generator=gen, device=device) * 70 + 10)
    yT = torch.exp(b[None] * xt[:, None]) + 0.005 * torch.randn((T, N), generator=gen,
                                                                 device=device)
    yT[:, 0] = 0
    yT[:, 1] = 0.7
    yT[:, 2] = torch.exp(0.02 * xt)
    yT[:, 3] = -yT[:, 3]
    yT[T // 2, 4] = 0
    yT[:, 5:9] = torch.exp(-xt[:, None] / torch.tensor([0.5, 2.0, 400.0, 5e4], device=device))
    yT[1, 9] = float("nan")
    yT[1, 10] = float("inf")
    return x, yT.contiguous()


_MAPS_CASES = {
    # name: (T, uniform, N, tc0, r2_threshold, decimals, mask dtype, nan_fill, max_iter)
    "config1": (4, True, 512 * 512 * 64, "polyfit", 0.9, 1, "uint8", 0.0, 100),
    "T4_edges": (4, True, 70_000, "polyfit", "data", 1, "uint8", 0.0, 100),
    "T3_nonuniform": (3, False, 70_000, 30.0, "data", 3, "int32", -2.5, 100),
    "T8": (8, True, 70_000, "polyfit", None, 0, "bool", 0.0, 100),
    "T9_nonuniform": (9, False, 70_000, "polyfit", "data", -1, "float32", 1.5, 100),
    "unconverged": (4, False, 70_000, 25.0, None, None, None, float("nan"), 2),
    "tc_inf": (4, True, 70_000, float("inf"), None, 1, None, 0.0, 100),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_MAPS_CASES))
def test_maps_entry_equals_its_plain_version_and_the_unfused_composition(name, card):
    """One launch of the maps entry gives, bit for bit, the maps of its plain
    version on the card and of the packed kernel followed by the torch
    epilogue; rows are read in place. Bounds and the r² threshold are taken
    at the data's own values, so voxels lie exactly at each of them."""
    from dosma_tpu_torch.ops.monoexp import (
        _nan_policy, _packed_kernel, maps_epilogue, monoexp_maps, monoexp_maps_reference,
    )

    T, uniform, N, tc0, thr, decimals, mask_kind, fill, max_iter = _MAPS_CASES[name]
    x, yT = _maps_echoes(T, uniform, N, seed=len(name), device=card)
    p0 = None if tc0 == "polyfit" else np.array([1.0, -1.0 / tc0], np.float32)
    p0b = None if p0 is None else torch.tensor([p0[1]], device=card)
    xt = torch.from_numpy(x).to(card)
    packed = _packed_kernel(xt, yT, p0b, max_iter, 1e-5, 1e-5, uniform)
    popt, r2, _ = _nan_policy(packed, yT, None, "scipy")
    tc_raw = 1.0 / torch.abs(popt[:, 1])
    kept = torch.sort(tc_raw[torch.isfinite(tc_raw)]).values
    bounds = ((float(kept[kept.numel() // 6]), float(kept[5 * kept.numel() // 6]))
              if name != "tc_inf" else (0.0, float("inf")))
    if thr == "data":
        thr = float(torch.sort(r2).values[N // 3])
    mask = None
    if mask_kind is not None:
        m = torch.randint(-2, 3, (N,), generator=torch.Generator(device=card).manual_seed(9),
                          device=card)
        m[:20] = 1
        mask = (m > 0) if mask_kind == "bool" else m.to(getattr(torch, mask_kind))
    mask_f = None if mask is None else mask.to(torch.float32)
    epilogue = dict(bounds=bounds, r2_threshold=thr, decimals=decimals, nan_fill=fill)

    rows = [r for r in yT]
    before = dict(counters)
    got = monoexp_maps(x, rows, p0, max_iter=max_iter, mask=mask, **epilogue)
    torch.cuda.synchronize()
    assert counters["monoexp_lm.launches"] == before.get("monoexp_lm.launches", 0) + 1
    in_place = 1 if T <= 8 else 0
    assert counters["fit.echoes_in_place"] == before.get("fit.echoes_in_place", 0) + in_place
    plain = monoexp_maps_reference(x, yT, p0, max_iter=max_iter, mask=mask, **epilogue)
    unfused = maps_epilogue(popt[:, 1], r2, bounds, thr, decimals, mask_f, fill)
    for g, p, u in zip(got, plain, unfused):
        assert g.is_cuda and g.shape == (N,)
        assert torch.equal(g.view(torch.int32), p.view(torch.int32))
        assert torch.equal(g.view(torch.int32), u.view(torch.int32))
    tc = got[0]
    if name == "tc_inf":
        assert float(tc[1]) == float("inf")  # b = -0: tc inf -> FLT_MAX -> rounded past it
    if thr is not None and name != "config1":
        assert bool((r2 == thr).any())
    if name != "tc_inf":
        assert all(bool((tc_raw == bound).any()) for bound in bounds)


@pytest.mark.cuda
def test_a_card_fit_reads_its_echoes_in_place(card):
    """MonoExponentialFit.fit of float32 card volumes: one monoexp_lm launch
    and one fit.echoes_in_place; the maps equal the plain version's on the
    same card; host volumes are stacked and not counted."""
    from dosma_tpu_torch.ops.monoexp import monoexp_maps_reference

    x, yT = _maps_echoes(4, True, 32 * 40 * 16, seed=4, device=card)
    shape = (32, 40, 16)
    affine = np.eye(4)
    labels = torch.zeros(shape, dtype=torch.uint8, device=card)
    labels[4:28, 4:36, :8] = 1
    ys = [dt.MedicalVolume(yT[t].reshape(shape), affine) for t in range(4)]
    fitter = dt.MonoExponentialFit(tc0="polyfit", bounds=(0, 100))
    before = dict(counters)
    tc, r2 = fitter.fit(x, ys, mask=dt.MedicalVolume(labels, affine))
    torch.cuda.synchronize()
    assert counters["monoexp_lm.launches"] == before.get("monoexp_lm.launches", 0) + 1
    assert counters["fit.echoes_in_place"] == before.get("fit.echoes_in_place", 0) + 1
    want = monoexp_maps_reference(x, yT, None, bounds=(0, 100), r2_threshold=0.9, decimals=1,
                                  mask=labels.reshape(-1))
    assert torch.equal(tc.A.reshape(-1).view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(r2.A.reshape(-1).view(torch.int32), want[1].view(torch.int32))

    host = [dt.MedicalVolume(v.A.cpu().numpy(), affine) for v in ys]
    with dt.default_device(card):
        tc_h, _ = fitter.fit(x, host, mask=dt.MedicalVolume(labels.cpu().numpy(), affine))
    assert counters["fit.echoes_in_place"] == before.get("fit.echoes_in_place", 0) + 1
    np.testing.assert_array_equal(tc_h.A, tc.A.cpu().numpy())
