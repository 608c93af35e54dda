"""The port's command line held against ``dosma_tpu``'s along the documented
chains, on the same DICOM series, at small sizes on the CPU: CubeQuant's
``intraregister`` -> ``interregister`` -> ``t1_rho`` -> ``knee`` and qDESS's
``segment`` -> ``t2`` -> ``knee``.

Each call is made through both packages' ``parse_args`` with the same
arguments. Tolerances (those of ``tests/test_torch_scans.py`` and
``tests/test_torch_cli.py``):

- registration: both packages' presets cut to 2 levels x 20 iterations x
  512 samples, with JAX's draws injected into the port; the transform
  matrices within 1e-3, the registered volumes within 1e-4 * max|v|;
- the T1rho map (JAX's fit down its Pallas path in interpret mode): zeros
  at the same voxels, within 1e-3 of the value (the registered series is no
  exact exponential, and there the two LM paths stop up to 2.7e-4 apart;
  on exact exponentials ``tests/test_torch_scans.py`` holds them within
  1e-3 absolute); r2 within 1e-4; and bit-equal to the port's API on the
  same volumes;
- the qDESS T2 map: rounded to 0.1, within one float32 ulp off a rounding
  boundary and 0.1 plus one ulp within 1e-3 of one (as
  ``test_torch_cli.py``'s);
- the segmentation masks: exact;
- the knee tables: each package's ``knee`` runs on its own copy of one save
  directory (the same maps and masks), so categories and counts are exact
  and the statistics within rtol 1e-9, or 1e-6 where ``dosma_tpu`` reduces
  in float32 (patellar cartilage and the meniscus; see
  ``tests/test_torch_tissues.py``).
"""

import os
import shutil

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import dosma_tpu
import dosma_tpu_torch as dt
from dosma_tpu import cli as jcli
from dosma_tpu.ops import monoexp_pallas
from dosma_tpu_torch import cli
from dosma_tpu_torch.utils.io_utils import load_tables
from tests.test_torch_cli import QDESS_TAGS, _condyle_arc, _load
from tests.test_torch_tissues import RTOL_F32, RTOL_F64
from tests.test_torch_scans import (  # noqa: F401  (fixtures)
    _check_transform_dirs,
    _check_volumes,
    jax_draws,
    small_presets,
)
from tests.util import write_dicom_series


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU, on one thread (many small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with dt.default_device("cpu"):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def temp_dirs(tmp_path, monkeypatch):
    """Each package writes a call's transform files under a temp directory
    of its own; ``temp_dirs.scan_dir(name)`` is the one directory that a
    call's scan made there (named by the second it started)."""

    class TempDirs:
        def __call__(self, name):
            monkeypatch.setenv("DOSMA_TEMP_DIR", str(tmp_path / "temp" / name))

        def scan_dir(self, name):
            (ts,) = os.listdir(tmp_path / "temp" / name / "cubequant")
            return str(tmp_path / "temp" / name / "cubequant" / ts)

    return TempDirs()


def _both(argv_fmt, temp_dirs=None, step="", **paths):
    """One call through the port's CLI and the same call through JAX's:
    ``paths`` maps a placeholder to its (port, JAX) values; with
    ``temp_dirs``, each package's temp directory is ``<package>-<step>``."""
    for k, (pkg_cli, name) in enumerate(((cli, "port"), (jcli, "jax"))):
        if temp_dirs is not None:
            temp_dirs(f"{name}-{step}")
        argv = argv_fmt.format(**{key: v[k] for key, v in paths.items()}).split()
        if pkg_cli is jcli:
            with pltpu.force_tpu_interpret_mode():
                pkg_cli.parse_args(argv)
        else:
            pkg_cli.parse_args(argv)


def _check_tables(path_t, path_j, rtol=1e-9):
    """The sheets of two ``data.xlsx``: same names, headers, categories and
    counts; statistics within ``rtol``."""
    got, want = load_tables(str(path_t)), load_tables(str(path_j))
    assert sorted(got) == sorted(want) and got
    for sheet, (header, rows) in want.items():
        header_t, rows_t = got[sheet]
        assert header_t == header and len(rows_t) == len(rows) > 0
        for r, w in zip(rows_t, rows):
            assert len(r) == len(w)
            for a, b in zip(r, w):
                if b is None or isinstance(b, str) or isinstance(b, int):
                    assert a == b, (sheet, header, r, w)
                elif np.isnan(b):
                    assert np.isnan(a)
                else:
                    np.testing.assert_allclose(a, b, rtol=rtol, err_msg=f"{sheet} {header} {w}")


def _check_t2_map(a, b, raw):
    """Two qDESS T2 maps rounded to 0.1 (``raw``: JAX's unrounded map):
    within one float32 ulp, and within 0.1 plus one ulp where the unrounded
    value lies within 1e-3 of a rounding boundary."""
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scaled = raw.astype(np.float64) * 10
    near = np.abs(scaled - np.floor(scaled) - 0.5) <= 1e-3
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    fin = ~np.isnan(a)
    assert (np.abs(a - b)[fin & ~near] <= ulp[fin & ~near]).all()
    assert (np.abs(a - b)[fin & near] <= 0.1 + ulp[fin & near]).all()


def test_cubequant_chain_matches_the_jax_cli(tmp_path, small_presets, jax_draws, temp_dirs,
                                             monkeypatch):
    """A 32x32x8 CubeQuant series (4 spin locks, each rolled by a voxel more)
    through both command lines: intraregister, interregister (to spin lock 1
    rolled, with a mask), t1_rho with a mask, and knee."""
    from dosma_tpu_torch.core.io.dicom_io import to_RAS_affine
    from dosma_tpu_torch.parallel.dryrun import series_headers
    from tests.test_torch_registration import _blobs

    monkeypatch.setattr(monoexp_pallas, "pallas_supported", lambda: True)
    shape, times = (32, 32, 8), (1.0, 10.0, 30.0, 60.0)
    rs = np.random.RandomState(3)
    relax = rs.rand(*shape).astype(np.float32) * 80 + 20
    base = 1000.0 * (0.2 + _blobs(shape, seed=1, n=16)) + 50.0
    pixels = np.stack([np.rint(np.roll(base * np.exp(-t / relax), (i, -i, 0), axis=(0, 1, 2)))
                       .astype(np.uint16) for i, t in enumerate(times)], axis=-1)
    headers = series_headers(shape, (0.5, 0.5, 1.0), times)
    affine = to_RAS_affine(list(headers[0, 0, :, 0]))
    src = tmp_path / "series"
    dt.DicomWriter().save(dt.MedicalVolume(pixels, affine, headers=headers), str(src))
    target, mask = tmp_path / "target.nii.gz", tmp_path / "mask.nii.gz"
    dt.MedicalVolume(np.roll(pixels[..., 0].astype(np.float32), (1, -1, 0), axis=(0, 1, 2)),
                     affine).save_volume(str(target))
    box = np.zeros(shape, np.uint8)
    box[8:24, 8:24, 2:6] = 1
    dt.MedicalVolume(box, affine).save_volume(str(mask))
    save = {"save": (tmp_path / "out_t", tmp_path / "out_j")}

    _both("--d {src} --s {save} cubequant intraregister", temp_dirs, "intra",
          src=(src, src), **save)
    names = _check_transform_dirs(temp_dirs.scan_dir("port-intra"),
                                  temp_dirs.scan_dir("jax-intra"))
    assert len(names) == 3  # an affine stage for each moving spin lock
    _both("--l {save} cubequant interregister --tp {tp} --tm {tm}", temp_dirs, "inter",
          tp=(target, target), tm=(mask, mask), **save)
    names = _check_transform_dirs(temp_dirs.scan_dir("port-inter"),
                                  temp_dirs.scan_dir("jax-inter"))
    assert len(names) == 2  # rigid + affine to the target
    _check_volumes(dt.CubeQuant.load(str(tmp_path / "out_t" / "cubequant")),
                   dosma_tpu.CubeQuant.load(str(tmp_path / "out_j" / "cubequant")))

    # The fit: the registered series is no exact exponential (r2 0.90 to
    # 0.9999), and there the two packages' LM stops lie up to 2.7e-4 apart
    # in relative terms; the port's map is its API's on the same volumes.
    _both("--l {save} cubequant --fc t1_rho --mask_path {m}", m=(mask, mask), **save)
    maps = {}
    for root, reader in (("out_t", dt.NiftiReader()), ("out_j", dosma_tpu.NiftiReader())):
        d = tmp_path / root / "fc" / "t1_rho"
        assert sorted(os.listdir(d)) == ["t1_rho-r2.nii.gz", "t1_rho.nii.gz"]
        maps[root] = [reader.load(str(d / f"{n}.nii.gz")) for n in ("t1_rho", "t1_rho-r2")]
    (got, got_r2), (want, want_r2) = maps["out_t"], maps["out_j"]
    np.testing.assert_array_equal(got.affine, want.affine)
    a, b = got.A, np.asarray(want.A)
    np.testing.assert_array_equal(a == 0, b == 0)
    assert (a[box.astype(bool)] > 0).mean() > 0.5
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=0)
    np.testing.assert_allclose(got_r2.A, np.asarray(want_r2.A), rtol=0, atol=1e-4)
    api = dt.CubeQuant.load(str(tmp_path / "out_t" / "cubequant")).generate_t1_rho_map(
        tissue=dt.FemoralCartilage(), mask_path=str(mask)).volumetric_map
    np.testing.assert_array_equal(a, np.asarray(api.A))

    # knee on two copies of JAX's directory, with fc's mask as a segment
    # call leaves it (the condyle geometry the femoral analytics expect).
    dt.MedicalVolume(_condyle_arc(shape), affine).save_volume(
        str(tmp_path / "out_j" / "fc" / "fc.nii.gz"))
    shutil.copytree(tmp_path / "out_j", tmp_path / "knee_t")
    _both("--l {save} knee --fc --t1_rho --pid P7",
          save=(tmp_path / "knee_t", tmp_path / "out_j"))
    _check_tables(tmp_path / "knee_t" / "fc" / "data.xlsx",
                  tmp_path / "out_j" / "fc" / "data.xlsx")


def test_qdess_segment_t2_knee_chain_matches_the_jax_cli(tmp_path):
    """qDESS through both command lines: segment (the same U-Net weights as
    the port's ``.pt`` state dict and as JAX's Keras ``.h5``), t2, and knee
    for all four tissues."""
    import jax

    from dosma_tpu.models.unet2d import init_unet2d_params
    from dosma_tpu.models.weights import save_keras_unet2d_weights
    from dosma_tpu_torch.models.weights import state_dict_from_params

    params = init_unet2d_params(jax.random.PRNGKey(0), num_classes=4)
    src = tmp_path / "dicoms"
    shape = (96, 96, 4)
    write_dicom_series(str(src), shape=shape, n_echos=2, plane="sagittal",
                       echo_times=[8.0, 42.0], extra=QDESS_TAGS)
    name = "iwoai-2019-unet2d_fc-tc-pc-men_weights"
    w_t, w_j = tmp_path / "w_pt", tmp_path / "w_h5"
    w_t.mkdir()
    w_j.mkdir()
    torch.save(state_dict_from_params(params), str(w_t / f"{name}.pt"))
    save_keras_unet2d_weights(str(w_j / f"{name}.h5"), params)
    out_t, out_j = tmp_path / "out_t", tmp_path / "out_j"
    save = {"save": (out_t, out_j)}
    tissues = ("fc", "tc", "pc", "men")

    _both("--d {src} --s {save} qdess --fc --tc --pc --men segment --weights_dir {w} "
          "--model iwoai-2019-t6 --rss", src=(src, src), w=(w_t, w_j), **save)
    for t in tissues:
        m_t = _load(out_t / t / f"{t}.nii.gz")
        m_j = dosma_tpu.NiftiReader().load(str(out_j / t / f"{t}.nii.gz"))
        assert m_t.shape == shape
        np.testing.assert_array_equal(m_t.A, np.asarray(m_j.A))
        np.testing.assert_array_equal(m_t.affine, m_j.affine)

    _both("--l {save} qdess --fc --tc --pc --men t2", **save)
    jscan = dosma_tpu.QDess.from_dicom(str(src))
    for t, jtissue in zip(tissues, (dosma_tpu.FemoralCartilage, dosma_tpu.TibialCartilage,
                                    dosma_tpu.PatellarCartilage, dosma_tpu.Meniscus)):
        a = _load(out_t / t / "t2" / "t2.nii.gz").A
        b = np.asarray(dosma_tpu.NiftiReader().load(str(out_j / t / "t2" / "t2.nii.gz")).A)
        raw = jscan.generate_t2_map(tissue=jtissue(), decimals=None, nan_bounds=None,
                                    nan_to_num=None).volumetric_map.A
        _check_t2_map(a, b, np.asarray(raw))

    # knee on two copies of JAX's directory; fc's mask is the condyle arc
    # (a random U-Net's fc mask has no condyle for the femoral analytics).
    affine = dosma_tpu.NiftiReader().load(str(out_j / "fc" / "fc.nii.gz")).affine
    for out in (out_t, out_j):
        dt.MedicalVolume(_condyle_arc(shape), np.asarray(affine)).save_volume(
            str(out / "fc" / "fc.nii.gz"))
    shutil.copytree(out_j, tmp_path / "knee_t")
    _both("--l {save} knee --fc --tc --pc --men --t2 --pid P7", save=(tmp_path / "knee_t", out_j))
    for t in tissues:
        _check_tables(tmp_path / "knee_t" / t / "data.xlsx", out_j / t / "data.xlsx",
                      rtol=RTOL_F64 if t in ("fc", "tc") else RTOL_F32)
    # and the port's own chain reaches the same step
    cli.parse_args(f"--l {out_t} knee --fc --tc --pc --men --t2".split())
    assert all((out_t / t / "data.xlsx").is_file() for t in tissues)
