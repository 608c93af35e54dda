"""The port's registered scans (``CubeQuant``, ``Mapss``, ``Cones`` and
``NonTargetSequence``) against ``dosma_tpu``'s.

Both packages get volumes built from the arrays of
``tests/scan_sequences/mri/test_cubequant.py::_mock_relaxometry_volumes``
(EchoTime headers), with the same rolls. The JAX fit runs its Pallas path
in interpret mode (as ``tests/test_torch_fitting.py``); the port fits on
the CPU with its plain version. Registrations run with the presets cut to
2 levels x 20 iterations x 512 samples in both packages, and with JAX's
draws injected into the port (``ops/registration.py::_level_draws``).
Tolerances:

- maps: rounded to 3 decimals, within 1e-3 plus one float32 ulp of the
  value (a value near a rounding boundary may round either way, and its
  float32 representation may differ by an ulp), zeros at the same voxels;
  r2 within 1e-4 (``tests/test_torch_fitting.py``'s);
- registration matrices within 1e-3 (``test_register_chain_matches_jax``'s)
  and the registered volumes within 1e-4 · max|v|. The registration cases
  take the mock's forward model with a smooth amplitude (a blob phantom):
  the mock's own volumes are white noise (amplitude and tc drawn per
  voxel), on which ``dosma_tpu``'s affine stage moves by 0.03 when its
  fixed image is scaled by 1 + 1e-6, so no two implementations agree
  there;
- ``__dilate_mask__``: bit-equal.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
from jax.experimental.pallas import tpu as pltpu

import dosma_tpu
import dosma_tpu_torch as dt
from dosma_tpu.core import registration as jcore
from dosma_tpu.ops import monoexp_pallas
from dosma_tpu.scan_sequences.mri.cones import Cones as JCones
from dosma_tpu.scan_sequences.mri.cube_quant import CubeQuant as JCubeQuant
from dosma_tpu.scan_sequences.mri.mapss import Mapss as JMapss
from dosma_tpu.tissues.femoral_cartilage import FemoralCartilage as JFemoralCartilage
from dosma_tpu_torch.core import registration as tcore
from dosma_tpu_torch.ops import registration as treg
from dosma_tpu_torch.ops.monoexp import monoexp_lm
from dosma_tpu_torch.scan_sequences.mri.cones import Cones
from dosma_tpu_torch.scan_sequences.mri.cube_quant import CubeQuant
from dosma_tpu_torch.scan_sequences.mri.mapss import Mapss
from dosma_tpu_torch.scan_sequences.scans import NonTargetSequence
from tests.scan_sequences.mri.test_cubequant import _mock_relaxometry_volumes


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU, on one thread: their tensors are small,
    and the workers of a parallel run share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with dt.default_device("cpu"):
            yield
    finally:
        torch.set_num_threads(threads)


_SMALL = dict(resolutions=2, iterations=20, num_samples=512)


@pytest.fixture
def small_presets(monkeypatch):
    """Both packages' stage configs cut to a CPU test's size."""
    for mod in (jcore, tcore):
        load = mod._load_stage_params
        monkeypatch.setattr(
            mod, "_load_stage_params",
            lambda p, load=load: dataclasses.replace(load(p), **_SMALL))


def _jax_draws(seed, level, iterations, num_samples, device):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), level)
    u = jax.random.uniform(key, (iterations, 3, num_samples))
    return torch.from_numpy(np.array(u)).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(treg, "_level_draws", _jax_draws)


@pytest.fixture
def jax_pallas(monkeypatch):
    """dosma_tpu's fit down its Pallas path, in interpret mode."""
    monkeypatch.setattr(monoexp_pallas, "pallas_supported", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        yield


def _port_volumes(jvols, headers=True):
    """The port's volumes of the same arrays, affines and echo times."""
    out = []
    for v in jvols:
        mv = dt.MedicalVolume(np.asarray(v.A), np.asarray(v.affine))
        if headers:
            mv.set_metadata("EchoTime", float(v.get_metadata("EchoTime")), force=True)
        out.append(mv)
    return out


def _structured_volumes(n, shape=(24, 24, 8), times=None, seed=7):
    """``_mock_relaxometry_volumes``'s forward model y = a * exp(-t / tc)
    with a smooth amplitude a (a blob phantom) in place of white noise."""
    from dosma_tpu.core.orientation import SAGITTAL, to_affine
    from tests.test_torch_registration import _blobs

    rs = np.random.RandomState(seed)
    times = [1.0 + 10.0 * i for i in range(n)] if times is None else times
    tc = rs.rand(*shape) * 70 + 10
    a = 0.2 + _blobs(shape, seed=1, n=16)
    affine = to_affine(SAGITTAL, (0.5, 0.5, 1.0))
    vols = []
    for t in times:
        mv = dosma_tpu.MedicalVolume((a * np.exp(-t / tc)).astype(np.float32), affine)
        mv.set_metadata("EchoTime", float(t), force=True)
        vols.append(mv)
    return vols, times, tc


def _pair(n, shift=None, structured=False, **kw):
    """(JAX volumes, port volumes, times, tc); volumes 1.. rolled by
    ``shift`` voxels when given."""
    make = _structured_volumes if structured else _mock_relaxometry_volumes
    jvols, times, tc = make(n, **kw)
    if shift is not None:
        rolled = [jvols[0]]
        for v in jvols[1:]:
            mv = dosma_tpu.MedicalVolume(np.roll(np.asarray(v.A), shift, axis=(0, 1, 2)),
                                         v.affine)
            mv.set_metadata("EchoTime", float(v.get_metadata("EchoTime")), force=True)
            rolled.append(mv)
        jvols = rolled
    return jvols, _port_volumes(jvols), times, tc


def _check_map(qv_t, qv_j, decimals=3):
    a_t, a_j = qv_t.volumetric_map.A, np.asarray(qv_j.volumetric_map.A)
    assert isinstance(a_t, np.ndarray) and a_t.shape == a_j.shape
    np.testing.assert_array_equal(qv_t.volumetric_map.affine, qv_j.volumetric_map.affine)
    np.testing.assert_array_equal(a_t == 0, a_j == 0)
    # 10^-decimals (either side of a rounding boundary) plus one float32 ulp
    # of the value: the rounded values' float32 representations may differ
    # by an ulp (7.6e-6 between 64 and 128, above the 1e-6 slack of
    # tests/test_torch_fitting.py, whose maps keep 1 decimal).
    ulp = np.spacing(np.maximum(np.abs(a_t), np.abs(a_j)))
    assert (np.abs(a_t - a_j) <= 10.0 ** -decimals + ulp).all()
    r2_t = qv_t.additional_volumes["r2"].A
    r2_j = np.asarray(qv_j.additional_volumes["r2"].A)
    np.testing.assert_allclose(r2_t, r2_j, rtol=0, atol=1e-4)
    assert type(qv_t).__name__ == type(qv_j).__name__


def _check_volumes(scan_t, scan_j, rtol=1e-4):
    assert len(scan_t.volumes) == len(scan_j.volumes)
    for vt, vj in zip(scan_t.volumes, scan_j.volumes):
        a_j = np.asarray(vj.A)
        assert vt.shape == vj.shape
        np.testing.assert_allclose(vt.affine, np.asarray(vj.affine), rtol=0, atol=1e-6)
        assert np.abs(np.asarray(vt.A) - a_j).max() <= rtol * np.abs(a_j).max()


def _check_transform_dirs(dir_t, dir_j):
    """The transform files each package writes: same names and keys, the
    matrices within 1e-3."""
    names_t = sorted(os.path.relpath(os.path.join(d, f), dir_t)
                     for d, _, fs in os.walk(dir_t) for f in fs if f.endswith(".json"))
    names_j = sorted(os.path.relpath(os.path.join(d, f), dir_j)
                     for d, _, fs in os.walk(dir_j) for f in fs if f.endswith(".json"))
    assert names_t == names_j and names_t
    for name in names_t:
        t = json.load(open(os.path.join(dir_t, name)))
        j = json.load(open(os.path.join(dir_j, name)))
        assert sorted(t) == sorted(j) and t["format"] == "dosma_tpu-transform-v1"
        assert t["transform"] == j["transform"] and t["fixed_shape"] == j["fixed_shape"]
        np.testing.assert_allclose(t["matrix"], j["matrix"], rtol=0, atol=1e-3)
    return names_t


# ----------------------------------------------------------------------
# Times and maps
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cls,jcls,attr,n", [
    (CubeQuant, JCubeQuant, "spin_lock_times", 4),
    (Cones, JCones, "echo_times", 4),
    (Mapss, JMapss, "echo_times", 7),
])
def test_times_from_headers_and_explicit(cls, jcls, attr, n):
    jvols, vols, times, _ = _pair(n)
    assert getattr(cls(vols), attr) == getattr(jcls(jvols), attr) == times
    bare = _port_volumes(jvols, headers=False)
    assert getattr(cls(bare), attr) is None
    explicit = [1.0 + 3 * i for i in range(n)]
    assert getattr(cls(bare, explicit), attr) == explicit


def test_times_from_headers_without_echo_time_raise():
    jvols, vols, _, _ = _pair(4)
    for v, mv_cls in ((vols, dt.MedicalVolume), (jvols, dosma_tpu.MedicalVolume)):
        v[2] = mv_cls(np.asarray(v[2].A), np.asarray(v[2].affine))
        v[2].set_metadata("RepetitionTime", 10.0, force=True)
    with pytest.raises(ValueError, match="spin_lock_times"):
        CubeQuant(vols)
    with pytest.raises(ValueError, match="spin_lock_times"):
        JCubeQuant(jvols)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_cubequant_t1rho_matches_jax(jax_pallas, masked):
    jvols, vols, times, tc = _pair(4)
    mask_t = mask_j = None
    if masked:
        m = np.zeros(tc.shape, np.float32)
        m[5:15] = 1
        mask_t = dt.MedicalVolume(m, vols[0].affine)
        mask_j = dosma_tpu.MedicalVolume(m, jvols[0].affine)
    before = monoexp_lm.launches
    qv_t = CubeQuant(vols).generate_t1_rho_map(mask_path=mask_t)
    assert monoexp_lm.launches == before  # the plain version on the CPU
    qv_j = JCubeQuant(jvols).generate_t1_rho_map(mask_path=mask_j)
    _check_map(qv_t, qv_j)
    valid = (tc > 1) & (tc < 500)
    if masked:
        assert (qv_t.volumetric_map.A[m == 0] == 0).all()
        valid &= m > 0
    assert np.abs(qv_t.volumetric_map.A[valid] - tc[valid]).mean() < 1.0


def test_mapss_maps_and_validation_match_jax(jax_pallas):
    jvols, vols, times, tc = _pair(7, times=[0, 10, 20, 30, 12.8, 25.6, 51.2])
    scan, jscan = Mapss(vols), JMapss(jvols)
    assert scan.__validate_scan__() and jscan.__validate_scan__()
    assert not Mapss(vols[:6]).__validate_scan__()
    with pytest.raises(ValueError, match="sequence"):
        Mapss(vols[0])
    _check_map(scan.generate_t1_rho_map(), jscan.generate_t1_rho_map())
    _check_map(scan.generate_t2_map(), jscan.generate_t2_map())


def test_cones_t2star_matches_jax(jax_pallas, tmp_path):
    jvols, vols, times, tc = _pair(4, times=[0.05, 5, 10, 20])
    m = np.zeros(tc.shape, np.uint8)
    m[:, 4:20] = 1
    path = str(tmp_path / "mask.nii.gz")
    dt.MedicalVolume(m, vols[0].affine).save_volume(path)
    _check_map(Cones(vols).generate_t2_star_map(), JCones(jvols).generate_t2_star_map())
    qv_t = Cones(vols).generate_t2_star_map(mask_path=path)  # a mask file
    _check_map(qv_t, JCones(jvols).generate_t2_star_map(mask_path=path))
    assert (qv_t.volumetric_map.A[m == 0] == 0).all()


def test_fit_adds_the_value_to_the_tissue(jax_pallas):
    jvols, vols, times, tc = _pair(4)
    m = np.zeros(tc.shape, np.uint8)
    m[4:20, 4:20, 1:5] = 1
    fc, jfc = dt.FemoralCartilage(), JFemoralCartilage()
    fc.set_mask(dt.MedicalVolume(m, vols[0].affine))
    jfc.set_mask(dosma_tpu.MedicalVolume(m, jvols[0].affine))
    qv_t = CubeQuant(vols).generate_t1_rho_map(tissue=fc)
    qv_j = JCubeQuant(jvols).generate_t1_rho_map(tissue=jfc)
    assert fc.quantitative_values == [qv_t] and len(jfc.quantitative_values) == 1
    _check_map(qv_t, qv_j)
    assert (qv_t.volumetric_map.A[m == 0] == 0).all()


# ----------------------------------------------------------------------
# Registration, with JAX's draws injected
# ----------------------------------------------------------------------
def test_cubequant_intraregister_matches_jax(small_presets, jax_draws, tmp_path):
    jvols, vols, _, _ = _pair(4, shift=(1, -1, 0), structured=True)
    scan, jscan = CubeQuant(vols), JCubeQuant(jvols)
    scan.temp_path, jscan.temp_path = str(tmp_path / "port"), str(tmp_path / "jax")
    scan.intraregister()
    jscan.intraregister()
    _check_volumes(scan, jscan)
    assert scan.volumes[0] is vols[0]
    for v, orig in zip(scan.volumes[1:], vols[1:]):
        # the originals' headers, not the anchor's
        assert v.get_metadata("EchoTime") == orig.get_metadata("EchoTime")
    names = _check_transform_dirs(str(tmp_path / "port" / "intraregister"),
                                  str(tmp_path / "jax" / "intraregister"))
    assert len(names) == 3


def test_mapss_intraregister_matches_jax(small_presets, jax_draws, tmp_path):
    times = [1, 10, 40, 80, 10, 30, 50]
    jvols, vols, _, _ = _pair(7, shift=(1, -1, 0), structured=True, times=times)
    scan, jscan = Mapss(vols), JMapss(jvols)
    scan.temp_path, jscan.temp_path = str(tmp_path / "port"), str(tmp_path / "jax")
    scan.intraregister()
    jscan.intraregister()
    _check_volumes(scan, jscan)
    for v, orig in zip(scan.volumes, vols):
        np.testing.assert_array_equal(v.affine, orig.affine)
        assert v.headers() is not orig.headers()  # copies
        assert v.get_metadata("EchoTime") == orig.get_metadata("EchoTime")
    np.testing.assert_array_equal(scan.volumes[0].A, vols[0].A)
    _check_transform_dirs(str(tmp_path / "port" / "intraregistered"),
                          str(tmp_path / "jax" / "intraregistered"))
    with pytest.raises(TypeError):
        scan.__intraregister__(scan.volumes[:3])


def _target_files(tmp_path, jvols, anchor, shift=(3, -2, 1), masked=False):
    """A target: the anchor volume rolled by ``shift``, as NIfTI; with a box
    mask on its grid."""
    target = dt.MedicalVolume(np.roll(np.asarray(jvols[anchor].A), shift, axis=(0, 1, 2)),
                              np.asarray(jvols[anchor].affine))
    tpath = str(tmp_path / "target.nii.gz")
    target.save_volume(tpath)
    mpath = None
    if masked:
        m = np.zeros(target.shape, np.uint8)
        m[6:18, 6:18, 2:6] = 1
        mpath = str(tmp_path / "target_mask.nii.gz")
        dt.MedicalVolume(m, target.affine).save_volume(mpath)
    return tpath, mpath


@pytest.mark.parametrize("cls,jcls,masked,times", [
    (CubeQuant, JCubeQuant, False, None),
    (CubeQuant, JCubeQuant, True, None),
    (Cones, JCones, False, [0.5, 2.0, 5.0, 10.0]),
    (Cones, JCones, True, [0.5, 2.0, 5.0, 10.0]),
], ids=["cubequant_first", "cubequant_first_masked", "cones_last", "cones_last_masked"])
def test_interregister_same_grid_matches_jax(small_presets, jax_draws, tmp_path, cls, jcls,
                                             masked, times):
    jvols, vols, _, _ = _pair(4, structured=True, times=times)
    anchor = 0 if cls is CubeQuant else 3
    tpath, mpath = _target_files(tmp_path, jvols, anchor, masked=masked)
    scan, jscan = cls(vols), jcls(jvols)
    scan.temp_path, jscan.temp_path = str(tmp_path / "port"), str(tmp_path / "jax")
    scan.interregister(tpath, mpath)
    jscan.interregister(tpath, mpath)
    _check_volumes(scan, jscan)
    out_t = tmp_path / "port" / "interregistered"
    names = _check_transform_dirs(str(out_t), str(tmp_path / "jax" / "interregistered"))
    assert names == ["moving-0/TransformParameters.0.json",
                     "moving-0/TransformParameters.1.json"]
    if masked:
        assert os.path.isfile(out_t / "dilated-mask.nii.gz")
    # the written files warp each original volume onto what the scan holds
    files = [str(out_t / n) for n in names]
    for v, orig in zip(scan.volumes, vols):
        back = dt.apply_warp(orig, transform=files)
        np.testing.assert_allclose(back.A, v.A, rtol=0, atol=1e-5 * np.abs(v.A).max())


def test_interregister_across_grids_matches_jax(small_presets, jax_draws, tmp_path):
    """Volumes on two grids: the anchor through ``register``, the others
    through ``apply_warp`` of its files."""
    jvols, _vols, _, _ = _pair(4, structured=True)
    # the last spin lock on a cropped grid (its origin moved by the crop)
    last = jvols[3]
    affine = np.asarray(last.affine).copy()
    affine[:3, 3] = affine[:3, 3] + affine[:3, :3] @ np.array([2.0, 1.0, 0.0])
    cropped = dosma_tpu.MedicalVolume(np.asarray(last.A)[2:-2, 1:-1], affine)
    cropped.set_metadata("EchoTime", float(last.get_metadata("EchoTime")), force=True)
    jvols = jvols[:3] + [cropped]
    vols = _port_volumes(jvols)
    tpath, _ = _target_files(tmp_path, jvols, 0)
    scan, jscan = CubeQuant(vols), JCubeQuant(jvols)
    scan.temp_path, jscan.temp_path = str(tmp_path / "port"), str(tmp_path / "jax")
    scan.interregister(tpath)
    jscan.interregister(tpath)
    _check_volumes(scan, jscan)
    assert all(v.shape == vols[0].shape for v in scan.volumes)
    _check_transform_dirs(str(tmp_path / "port" / "interregistered"),
                          str(tmp_path / "jax" / "interregistered"))


# ----------------------------------------------------------------------
# Masks, reload, actions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kw", [dict(), dict(dil_rate=1.5, dil_threshold=0.2)])
def test_dilate_mask_is_bit_equal(tmp_path, kw):
    rs = np.random.RandomState(21)
    m = (rs.rand(20, 18, 7) > 0.9).astype(np.uint8)
    affine = np.diag([0.5, 0.5, 1.0, 1.0])
    path = str(tmp_path / "m.nii.gz")
    dt.MedicalVolume(m, affine).save_volume(path)
    _jvols, vols, _, _ = _pair(4)
    out_t = CubeQuant(vols).__dilate_mask__(path, str(tmp_path / "t"), **kw)
    out_j = JCubeQuant(_jvols).__dilate_mask__(path, str(tmp_path / "j"), **kw)
    a_t = dt.NiftiReader().load(out_t).A
    a_j = np.asarray(dosma_tpu.NiftiReader().load(out_j).A)
    assert a_t.dtype == a_j.dtype and np.array_equal(a_t, a_j) and a_t.any()
    # a volume, on a tensor (one host copy for scipy)
    vol = dt.MedicalVolume(torch.from_numpy(m), affine)
    out_v = CubeQuant(vols).__dilate_mask__(vol, str(tmp_path / "v"), **kw)
    assert np.array_equal(dt.NiftiReader().load(out_v).A, a_j)
    with pytest.raises(ValueError, match="range"):
        CubeQuant(vols).__dilate_mask__(path, str(tmp_path / "x"), dil_threshold=2.0)
    with pytest.raises(FileNotFoundError):
        CubeQuant(vols).__dilate_mask__(str(tmp_path / "none.nii.gz"), str(tmp_path / "x"))


@pytest.mark.parametrize("cls,jcls", [(CubeQuant, JCubeQuant), (Cones, JCones)])
def test_from_dict_reloads_interregistered_files(tmp_path, cls, jcls):
    jvols, vols, times, _ = _pair(3)
    interreg = tmp_path / "interregistered"
    os.makedirs(interreg)
    for i, v in enumerate(vols):
        v.save_volume(str(interreg / f"{i:03d}.nii.gz"))
    attr = "spin_lock_times" if cls is CubeQuant else "echo_times"

    def data(mv_cls):
        return {"volumes": [mv_cls(np.zeros((4, 4, 2)), np.eye(4))] * 3, attr: times,
                "subvolumes": [str(interreg / f"{i:03d}.nii.gz") for i in range(3)]}

    scan = cls.from_dict(data(dt.MedicalVolume), force=True)
    jscan = jcls.from_dict(data(dosma_tpu.MedicalVolume), force=True)
    assert getattr(scan, attr) == times
    for v, jv, orig in zip(scan.volumes, jscan.volumes, vols, strict=True):
        np.testing.assert_array_equal(v.A, np.asarray(jv.A))
        np.testing.assert_allclose(v.A, orig.A, rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="Invalid path"):
        scan.__load_interregistered_files__(str(tmp_path))


def test_save_load_round_trip(tmp_path):
    _jvols, vols, times, _ = _pair(4)
    scan = CubeQuant(vols)
    scan.temp_path = str(tmp_path / "tmp")
    scan.save(str(tmp_path / "save"), save_custom=True)
    loaded = CubeQuant.load(str(tmp_path / "save"))
    assert loaded.spin_lock_times == times and len(loaded.volumes) == 4
    for a, b in zip(scan.volumes, loaded.volumes):
        np.testing.assert_allclose(a.A, b.A, rtol=1e-6)


@pytest.mark.parametrize("cls,jcls", [(CubeQuant, JCubeQuant), (Mapss, JMapss),
                                      (Cones, JCones)])
def test_cmd_line_actions_match_jax(cls, jcls):
    got = [(fn.__name__, w.name, w.aliases, w.help) for fn, w in cls.cmd_line_actions()]
    ref = [(fn.__name__, w.name, w.aliases, w.help) for fn, w in jcls.cmd_line_actions()]
    assert got == ref
    params = [w._param_help for _fn, w in cls.cmd_line_actions()]
    assert params == [w._param_help for _fn, w in jcls.cmd_line_actions()]


def test_scans_are_exported():
    assert dt.CubeQuant is CubeQuant and dt.Mapss is Mapss and dt.Cones is Cones
    assert dt.scan_sequences.NonTargetSequence is NonTargetSequence
    assert issubclass(CubeQuant, NonTargetSequence) and issubclass(Cones, NonTargetSequence)
    assert not issubclass(Mapss, NonTargetSequence)
