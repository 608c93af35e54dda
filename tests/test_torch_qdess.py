"""The port's qDESS scan (``dosma_tpu_torch/scan_sequences/mri/qdess.py``)
against the JAX package's.

A two-echo sagittal series with GE's private spoiler tags (0019,10B6) and
(0019,10B7), written by ``tests/util.write_dicom_series``, is read by both
packages (the port on the host, and through ``load_to_device`` onto the
CPU). Held against ``dosma_tpu``:

- ``generate_t2_map``, with the header's parameters, with overrides and
  with ``set_metadata``: bit for bit equal to the port's
  ``ops.qmri.qdess_t2_map`` of the same echoes with those parameters, and
  held against ``dosma_tpu``'s map with the tolerances of
  ``tests/test_torch_qmri.py`` (unrounded: rtol 1e-5 with identical NaN
  and zero placement, as XLA's and torch's float32 log and division may
  differ by an ulp; rounded to 0.1: equal except where the unrounded value
  lies within 1e-4 of a rounding boundary); a missing private tag raises;
- ``calc_rss`` and ``_combine_echoes("rms")``: bit for bit equal to the
  port's ``rss_combine`` / ``rms_combine``, and to ``dosma_tpu``'s within
  rtol 1e-5 (``tests/test_torch_qmri.py``: XLA's float32 square root and
  sum may differ by an ulp);
- ``segment`` with a narrow U-Net whose parameters both packages load from
  one Keras h5 file (the port's ``models.weights``): equal masks, each
  tissue given its own channel;
- the scan's save / load round trips, as ``tests/scan_sequences/mri/
  test_qdess.py`` holds ``dosma_tpu``'s;
- the workflow on the port alone: ``from_dicom`` → ``segment`` →
  ``generate_t2_map(tissue=...)`` → each tissue's rows, which equal the
  JAX package's (the tolerances of ``tests/test_torch_tissues.py``).
"""

import os
import warnings

import numpy as np
import pytest
import torch

import dosma_tpu_torch as dt
from dosma_tpu.core.io.dicom import Tag as JTag
from dosma_tpu.scan_sequences.mri.qdess import QDess as JQDess
from dosma_tpu_torch.core.io.dicom import Tag
from dosma_tpu_torch.scan_sequences.mri.qdess import QDess
from tests.test_torch_tissues import RTOL_F32, RTOL_F64, assert_frames_match, assert_maps_match
from tests.test_torch_unet2d import random_unet_params
from tests.util import write_dicom_series


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    with dt.default_device("cpu"):
        yield


SHAPE = (64, 64, 6)  # sagittal: (SI, AP, slices along LR)
GL_AREA, TG = 3132.0, 1560.0


@pytest.fixture(scope="module")
def series(tmp_path_factory):
    """A two-echo qDESS series with the private tags; (directory, pixels)."""
    d = str(tmp_path_factory.mktemp("qdess") / "src")
    arr = write_dicom_series(
        d, shape=SHAPE, n_echos=2, plane="sagittal", echo_times=[8.0, 42.0],
        extra={JTag(0x0019, 0x10B6): GL_AREA, JTag(0x0019, 0x10B7): TG}, seed=11,
    )
    return d, arr


def _scans(series, to_device=None):
    d, _ = series
    return JQDess.from_dicom(d), QDess.from_dicom(d, to_device=to_device)


def _host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("to_device", [None, "cpu"])
def test_private_tags_survive_the_round_trip(series, to_device):
    _, scan = _scans(series, to_device)
    assert float(scan.get_metadata(Tag(0x0019, 0x10B6))) == GL_AREA
    assert float(scan.get_metadata(Tag(0x0019, 0x10B7))) == TG
    assert float(scan.get_metadata("RepetitionTime")) > 0


@pytest.mark.parametrize("to_device", [None, "cpu"])
@pytest.mark.parametrize("kwargs", [
    {},
    {"decimals": None, "nan_bounds": None, "nan_to_num": None},
    {"suppress_fat": True, "suppress_fluid": True, "beta": 1.1},
    {"tr": 30.0, "te": 9.0, "alpha": 25.0, "gl_area": 3000.0, "tg": 1500.0, "t1": 900.0},
], ids=["header", "raw", "suppress", "overrides"])
def test_generate_t2_map_matches(series, to_device, kwargs):
    from dosma_tpu_torch.ops.qmri import qdess_t2_map

    jscan, scan = _scans(series, to_device)
    kw = {"t1": 1200.0, **kwargs}
    got = scan.generate_t2_map(**kw).volumetric_map
    assert isinstance(got.volume, torch.Tensor if to_device else np.ndarray)
    assert got.orientation == scan.volumes[0].orientation
    got = _host(got.volume)

    # Bit for bit: the header's parameters reach qdess_t2_map.
    physics = {k: float(scan.get_metadata(key)) for k, key in (
        ("tr", "RepetitionTime"), ("te", "EchoTime"), ("alpha", "FlipAngle"))}
    physics.update(gl_area=GL_AREA, tg=TG)
    physics.update({k: kw.pop(k) for k in ("tr", "te", "alpha", "gl_area", "tg") if k in kw})
    e1, e2 = (v.volume for v in scan.volumes)
    np.testing.assert_array_equal(got, _host(qdess_t2_map(e1, e2, **physics, **kw)))

    # Against dosma_tpu, with ops/qmri's tolerances.
    kw = {"t1": 1200.0, **kwargs}
    want = np.asarray(jscan.generate_t2_map(**kw).volumetric_map.A)
    assert got.dtype == want.dtype == np.float32
    if kw.get("decimals", 1) is None:
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=0, equal_nan=True)
    else:
        raw = np.asarray(jscan.generate_t2_map(
            **{**kw, "decimals": None, "nan_bounds": None, "nan_to_num": None}).volumetric_map.A)
        scaled = raw.astype(np.float64) * 10
        near = np.abs(scaled - np.floor(scaled) - 0.5) <= 1e-3
        np.testing.assert_array_equal(got[~near], want[~near])
        assert np.all(np.abs(got[near] - want[near]) <= 0.1 + 1e-5)


def test_set_metadata_override_wins(series):
    jscan, scan = _scans(series)
    for s in (jscan, scan):
        s.set_metadata("RepetitionTime", 30.0)
    got = scan.generate_t2_map(t1=1200.0).volumetric_map.volume
    np.testing.assert_array_equal(got, scan.generate_t2_map(t1=1200.0, tr=30.0).volumetric_map.A)
    plain = QDess.from_dicom(series[0]).generate_t2_map(t1=1200.0).volumetric_map.volume
    assert not np.array_equal(got, plain)
    want = np.asarray(jscan.generate_t2_map(t1=1200.0).volumetric_map.A)
    assert np.mean(got == want) > 0.99  # off only at rounding boundaries (see above)


def test_tissue_t1_is_used_and_the_map_is_registered(series):
    _, scan = _scans(series)
    fc = dt.FemoralCartilage()
    qv = scan.generate_t2_map(tissue=fc)
    assert fc.quantitative_values == [qv]
    np.testing.assert_array_equal(qv.volumetric_map.volume,
                                  scan.generate_t2_map(t1=fc.T1_EXPECTED).volumetric_map.volume)


def test_missing_private_tag_raises(tmp_path):
    d = str(tmp_path / "src")
    write_dicom_series(d, shape=(8, 8, 2), n_echos=2, extra={JTag(0x0019, 0x10B6): GL_AREA})
    scan = QDess.from_dicom(d)
    with pytest.raises(ValueError, match="gl_area"):
        scan.generate_t2_map(t1=1200.0)
    assert scan.generate_t2_map(t1=1200.0, tg=TG).volumetric_map.shape == (8, 8, 2)


@pytest.mark.parametrize("to_device", [None, "cpu"])
@pytest.mark.parametrize("method", ["rss", "rms"])
def test_combine_echoes_matches(series, to_device, method):
    from dosma_tpu_torch.ops import qmri

    jscan, scan = _scans(series, to_device)
    want = jscan._combine_echoes(method)
    got = scan.calc_rss() if method == "rss" else scan._combine_echoes(method)
    assert isinstance(got.volume, torch.Tensor if to_device else np.ndarray)
    plain = getattr(qmri, f"{method}_combine")(*(v.volume for v in scan.volumes))
    np.testing.assert_array_equal(_host(got.volume), _host(plain))
    np.testing.assert_allclose(_host(got.volume), np.asarray(want.A), rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got.affine, want.affine)
    assert got.headers() is not scan.volumes[0].headers()
    with pytest.raises(ValueError, match="not supported"):
        scan._combine_echoes("mean")


def test_two_volumes_required(series):
    _, scan = _scans(series)
    with pytest.raises(ValueError):
        QDess(scan.volumes + scan.volumes)
    assert scan.ref_dicom is scan.volumes[0].headers(flatten=True)[0]


def _models(tmp_path):
    """The IWOAI normalized model of each package, loaded from one narrow
    Keras h5 file written by the port."""
    from dosma_tpu.models.oaiunet2d import IWOAIOAIUnet2DNormalized as JModel
    from dosma_tpu_torch.models.oaiunet2d import IWOAIOAIUnet2DNormalized as TModel
    from dosma_tpu_torch.models.weights import save_keras_unet2d_weights

    path = str(tmp_path / "iwoai-2019-unet2d-normalized_fc-tc-pc-men_weights.h5")
    save_keras_unet2d_weights(path, random_unet_params(seed=5, num_classes=4))
    return JModel(SHAPE[:2] + (1,), path), TModel(SHAPE[:2] + (1,), path)


def _tissue_pairs():
    from dosma_tpu import tissues as jt

    return [(jt.FemoralCartilage(), dt.FemoralCartilage()),
            (jt.TibialCartilage(), dt.TibialCartilage()),
            (jt.PatellarCartilage(), dt.PatellarCartilage()),
            (jt.Meniscus(), dt.Meniscus())]


@pytest.mark.parametrize("use_rss", [True, False])
def test_segment_matches_jax(series, tmp_path, use_rss):
    jscan, scan = _scans(series)
    jmodel, tmodel = _models(tmp_path)
    pairs = _tissue_pairs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # region splits of untrained masks may warn
        want = jscan.segment(jmodel, [j for j, _ in pairs], use_rss=use_rss)
        got = scan.segment(tmodel, [t for _, t in pairs], use_rss=use_rss)
    assert set(got) == set(want) == {"fc", "tc", "pc", "men"}
    for k in want:
        np.testing.assert_array_equal(got[k].volume, np.asarray(want[k].A))
        assert 0 < got[k].volume.mean() < 1, k
    for j, t in pairs:
        np.testing.assert_array_equal(t.get_mask().volume, np.asarray(j.get_mask().A))
    assert [t.STR_ID for t in scan.tissues] == ["fc", "tc", "pc", "men"]
    with pytest.raises(ValueError, match="already exists"):
        scan.segment(tmodel, dt.FemoralCartilage(), use_rss=use_rss)


def _arc(shape):
    """An inferior annular arc in each sagittal slice (the femoral condyle
    geometry the tissue analytics expect)."""
    from tests.test_torch_tissues import fc_mask_and_map

    return fc_mask_and_map(shape)[0]


@pytest.mark.parametrize("to_device", [None, "cpu"])
def test_directory_to_rows_matches_jax(series, tmp_path, to_device):
    """from_dicom → segment → arc masks → generate_t2_map(tissue) → rows,
    in both packages; the port's rows and unrolled maps equal the JAX
    package's."""
    jscan, scan = _scans(series, to_device)
    jmodel, tmodel = _models(tmp_path)
    pairs = _tissue_pairs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jscan.segment(jmodel, [j for j, _ in pairs], use_rss=True)
        scan.segment(tmodel, [t for _, t in pairs], use_rss=True)
    arc = _arc(SHAPE)
    from dosma_tpu.core.med_volume import MedicalVolume as JMV

    for (j, t), s_rtol in zip(pairs, (RTOL_F64, RTOL_F64, RTOL_F32, RTOL_F32)):
        j.set_mask(JMV(arc, jscan.volumes[0].affine))
        t.set_mask(dt.MedicalVolume(arc, scan.volumes[0].affine))
        jscan.generate_t2_map(tissue=j)
        qv = scan.generate_t2_map(tissue=t)
        assert isinstance(qv.volumetric_map.volume, torch.Tensor if to_device else np.ndarray)
        j.calc_quant_vals()
        t.calc_quant_vals()
        assert_frames_match(t.quant_vals["T2"][1], j.quant_vals["T2"][1], s_rtol)
        assert_maps_match(t.quant_vals["T2"][0], j.quant_vals["T2"][0], s_rtol)


def test_save_load_round_trip(series, tmp_path):
    """``save(save_custom=True)`` writes the echoes as image files; ``load``
    restores the scan, its echoes and the header's parameters, so the
    reloaded scan's T2 map equals the first one's."""
    _, scan = _scans(series)
    path = scan.save(str(tmp_path / "saved"), save_custom=True)
    assert os.path.isfile(path) and path.endswith("qdess.data")
    assert os.path.isdir(tmp_path / "saved" / "volumes")
    loaded = QDess.load(str(tmp_path / "saved"))
    assert loaded.NAME == "qdess" and len(loaded.volumes) == 2
    for a, b in zip(loaded.volumes, scan.volumes):
        np.testing.assert_array_equal(np.asarray(a.volume), b.volume)
    assert float(loaded.get_metadata(loaded.__GL_AREA_TAG__)) == GL_AREA
    np.testing.assert_array_equal(
        loaded.generate_t2_map(t1=1200.0).volumetric_map.volume,
        scan.generate_t2_map(t1=1200.0).volumetric_map.volume,
    )


def test_save_without_volumes_reloads_from_the_dicom_files(series, tmp_path):
    _, scan = _scans(series)
    scan.save(str(tmp_path / "saved"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        loaded = QDess.load(str(tmp_path / "saved"))
    for a, b in zip(loaded.volumes, scan.volumes):
        assert a.is_identical(b)


def test_save_of_tensor_volumes_round_trips(series, tmp_path):
    """Tensor-backed echoes (``to_device``) are copied to the host to be
    written (``_save`` starts each copy first)."""
    _, scan = _scans(series, "cpu")
    scan.save(str(tmp_path / "saved"), save_custom=True)
    loaded = QDess.load(str(tmp_path / "saved"))
    for a, b in zip(loaded.volumes, scan.volumes):
        np.testing.assert_array_equal(np.asarray(a.volume).astype(np.int64),
                                      b.volume.numpy().astype(np.int64))


def test_cmd_line_actions():
    names = [wrapper.name for _, wrapper in QDess.cmd_line_actions()]
    assert names == ["segment", "generate_t2_map"]
    t2 = dict((w.name, w) for _, w in QDess.cmd_line_actions())["generate_t2_map"]
    assert t2.aliases == ["t2"] and "0x001910b6" in t2.get_param_help("gl_area")
