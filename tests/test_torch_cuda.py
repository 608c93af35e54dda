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
    from dosma_tpu_torch.ops.monoexp import monoexp_lm
    from dosma_tpu_torch.ops.warp import warp_grid

    affine = _write_cubequant_series(str(tmp_path / "series"))
    scan = dt.CubeQuant.from_dicom(str(tmp_path / "series"), to_device=True)
    assert scan.spin_lock_times == [1.0, 10.0, 30.0, 60.0]
    target = np.roll(scan.volumes[0].cpu().A.astype(np.float32), (2, -1, 1), axis=(0, 1, 2))
    target_path = str(tmp_path / "target.nii.gz")
    dt.MedicalVolume(target, affine).save_volume(target_path)
    scan.temp_path = str(tmp_path / "scan")

    warp_grid.launches = 0
    scan.intraregister()
    assert warp_grid.launches == 1
    scan.interregister(target_path)
    assert warp_grid.launches == 2
    assert all(v.volume.is_cuda for v in scan.volumes)
    monoexp_lm.launches = 0
    qv = scan.generate_t1_rho_map()
    assert monoexp_lm.launches == 1 and qv.volumetric_map.volume.is_cuda

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
    before = monoexp.monoexp_lm.launches
    popt, r2, conv = sharded_lm_fit(dt.monoexponential, x, Y, p0, max_iter=50)
    assert monoexp.monoexp_lm.launches == before + 1
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
