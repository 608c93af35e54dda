"""The port's knee tissues and ``msk/knee.py`` against the JAX package's.

The same seeded numpy masks and maps (the recipe of
``tests/tissues/test_tissues.py``: an inferior annular arc in each sagittal
slice and a map of 20..60 on it) go through both packages on the CPU:

- ``largest_cc``, each tissue's region volume, femoral cartilage's θ bins
  and medial/lateral and anterior/central/posterior boundaries: exactly;
- the rows: categories and voxel counts exactly; Mean / Std / Median to
  rtol 1e-9 where ``dosma_tpu`` reduces in float64 (femoral and tibial
  cartilage) and to rtol 1e-6 where it reduces in float32 (patellar
  cartilage's float32 product, the meniscus through ``to_metrics``; the
  port's ``metric_rows`` reduces in float64);
- the unrolled maps, with the same rule and equal NaN positions;
- ``save_data`` / ``load_data`` round trips and ``handle_knee``.

Each case runs on a host (numpy) map and on a tensor-backed one (a CPU
tensor takes the gather and the reductions of a card's), float64 and
float32.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import torch

import dosma_tpu_torch as dt
from dosma_tpu import tissues as jt
from dosma_tpu.core.med_volume import MedicalVolume as JMV
from dosma_tpu.core.quant_vals import T2 as JT2
from dosma_tpu_torch import tissues as tt
from dosma_tpu_torch.core.quant_vals import T2 as TT2


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    with dt.default_device("cpu"):
        yield


RTOL_F64 = 1e-9  # dosma_tpu reduces in float64: the same sums, another order at most
RTOL_F32 = 1e-6  # dosma_tpu reduces in float32, the port in float64 (meniscus)

_AFFINE = dt.to_affine(dt.SAGITTAL, (0.3, 0.3, 0.7))


def fc_mask_and_map(shape=(64, 64, 16), seed=0):
    """``tests/tissues/test_tissues.py``'s recipe: an inferior annular arc
    in each sagittal slice, and a map of 20..60 on it (float64)."""
    rs = np.random.RandomState(seed)
    h, w, d = shape
    yv, xv = np.meshgrid(range(h), range(w), indexing="ij")
    cx, cy, R = w / 2, h / 2, h / 3
    rad = np.sqrt((xv - cx) ** 2 + (yv - cy) ** 2)
    annulus = (rad > R * 0.8) & (rad < R * 1.1) & (yv > cy - R)
    mask = np.repeat(annulus[..., None], d, axis=2).astype(np.uint8)
    qmap = (rs.rand(*shape) * 40 + 20) * mask
    return mask, qmap


# name: (JAX class, port class, constructor kwargs, rtol of the rows, seed)
_TISSUES = {
    "FemoralCartilage": (jt.FemoralCartilage, tt.FemoralCartilage, dict(medial_to_lateral=True),
                         RTOL_F64, 0),
    "TibialCartilage": (jt.TibialCartilage, tt.TibialCartilage, dict(medial_to_lateral=True),
                        RTOL_F64, 2),
    "PatellarCartilage": (jt.PatellarCartilage, tt.PatellarCartilage,
                          dict(medial_to_lateral=False), RTOL_F32, 3),
    "Meniscus": (jt.Meniscus, tt.Meniscus, dict(medial_to_lateral=True), RTOL_F32, 4),
    "Meniscus_ml_only": (jt.Meniscus, tt.Meniscus,
                         dict(medial_to_lateral=True, split_ml_only=True), RTOL_F32, 5),
}


def _port_map(arr, backing):
    return dt.MedicalVolume(torch.from_numpy(arr.copy()) if backing == "tensor" else arr.copy(),
                            _AFFINE)


def assert_frames_match(got, ref, rtol):
    """Categories and counts exactly, statistics to ``rtol``, equal NaNs."""
    assert list(got.columns) == list(ref.columns)
    stats = ("Mean", "Std", "Median")
    for col in got.columns:
        if col in stats:
            np.testing.assert_allclose(got[col].to_numpy(float), ref[col].to_numpy(float),
                                       rtol=rtol, atol=0, equal_nan=True)
        else:
            assert list(got[col]) == list(ref[col]), col


def assert_maps_match(got, ref, rtol):
    assert [m["title"] for m in got] == [m["title"] for m in ref]
    for g, r in zip(got, ref):
        assert {k: v for k, v in g.items() if k != "data"} == \
            {k: v for k, v in r.items() if k != "data"}
        np.testing.assert_array_equal(np.isnan(g["data"]), np.isnan(r["data"]))
        np.testing.assert_allclose(g["data"], r["data"], rtol=rtol, atol=0, equal_nan=True)


def _both(name, shape=(64, 64, 16), seed=None, qmap_fn=None):
    """(JAX tissue, port tissue, mask, map) with the mask set on both."""
    jcls, tcls, kw, _, default_seed = _TISSUES[name]
    mask, qmap = fc_mask_and_map(shape, default_seed if seed is None else seed)
    if qmap_fn is not None:
        qmap = qmap_fn(qmap)
    j, t = jcls(**kw), tcls(**kw)
    j.set_mask(JMV(mask, _AFFINE))
    t.set_mask(dt.MedicalVolume(mask, _AFFINE))
    return j, t, mask, qmap


@pytest.mark.parametrize("num", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_largest_cc_matches(seed, num):
    rs = np.random.RandomState(seed)
    mask = (rs.rand(24, 20, 10) > 0.62).astype(np.uint8)
    np.testing.assert_array_equal(tt.largest_cc(mask, num=num), jt.largest_cc(mask, num=num))


def test_largest_cc_of_an_empty_mask_raises():
    with pytest.raises(ValueError, match="No non-zero"):
        tt.largest_cc(np.zeros((4, 4, 2)))


@pytest.mark.parametrize("name", list(_TISSUES))
def test_region_split_matches(name):
    j, t, _, _ = _both(name)
    np.testing.assert_array_equal(t.regions_mask, j.regions_mask)
    assert t.regions_mask.dtype == j.regions_mask.dtype
    if name == "FemoralCartilage":
        np.testing.assert_array_equal(t.theta_bins, j.theta_bins)
        assert t.ML_BOUNDARY == j.ML_BOUNDARY and t.ACP_BOUNDARY == j.ACP_BOUNDARY


@pytest.mark.parametrize("medial_to_lateral", [True, False])
@pytest.mark.parametrize("seed, density", [(0, 0.02), (1, 0.15), (2, 0.5), (3, 0.9)])
@pytest.mark.parametrize("name", ["FemoralCartilage", "TibialCartilage", "PatellarCartilage",
                                  "Meniscus"])
def test_region_split_of_random_masks_matches(name, seed, density, medial_to_lateral):
    """Speckled masks, such as an untrained network gives, with labels above
    1 on one slice: the same region volumes (the per-column centers of mass
    of tibial and patellar cartilage included)."""
    jcls, tcls = _TISSUES[name][:2]
    rs = np.random.RandomState(seed)
    mask = (rs.rand(40, 36, 12) < density).astype(np.uint8)
    mask[..., 3] *= 3
    kw = {"use_largest_cc": False} if name in ("FemoralCartilage", "PatellarCartilage") else {}
    j, t = jcls(medial_to_lateral=medial_to_lateral), tcls(medial_to_lateral=medial_to_lateral)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j.set_mask(JMV(mask, _AFFINE), **kw)
        t.set_mask(dt.MedicalVolume(mask, _AFFINE), **kw)
    if j.regions_mask is None:
        assert t.regions_mask is None
    else:
        np.testing.assert_array_equal(t.regions_mask, j.regions_mask)
        assert t.regions_mask.dtype == j.regions_mask.dtype


def test_femoral_split_of_a_base_map_with_nan_and_zeros_matches():
    """``split_regions`` of a map whose masked voxels are partly NaN or 0:
    the valid set and the center of mass follow the product form."""
    j, t, mask, qmap = _both("FemoralCartilage", shape=(48, 48, 9))
    q = qmap.copy()
    inside = np.nonzero(mask)
    drop = np.random.RandomState(7).permutation(len(inside[0]))
    n = len(drop)
    q[tuple(i[drop[: n // 5]] for i in inside)] = np.nan
    q[tuple(i[drop[n // 5: 2 * n // 5]] for i in inside)] = 0.0
    got, want = t.split_regions(q), j.split_regions(q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("backing", ["numpy", "tensor"])
@pytest.mark.parametrize("name", list(_TISSUES))
def test_rows_and_unrolled_maps_match(name, backing, dtype):
    """A float32 map is what the qDESS map is: ``dosma_tpu`` then reduces
    patellar cartilage's product and the meniscus in float32."""
    j, t, _, qmap = _both(name, qmap_fn=lambda q: q.astype(dtype))
    rtol = _TISSUES[name][3]
    j.pid = t.pid = "subject-1"
    j.add_quantitative_value(JT2(JMV(qmap.copy(), _AFFINE)))
    t.add_quantitative_value(TT2(_port_map(qmap, backing)))
    j.calc_quant_vals()
    t.calc_quant_vals()
    jmaps, jdf = j.quant_vals["T2"]
    tmaps, tdf = t.quant_vals["T2"]
    assert len(tdf) == {"FemoralCartilage": 18, "TibialCartilage": 18, "PatellarCartilage": 6,
                        "Meniscus": 19, "Meniscus_ml_only": 3}[name]
    assert_frames_match(tdf, jdf, rtol)
    assert_maps_match(tmaps, jmaps, rtol)


@pytest.mark.parametrize("name", ["FemoralCartilage", "TibialCartilage"])
def test_compressed_rows_with_nan_and_nonpositive_voxels_match(name):
    """NaN, 0 and negative values inside the mask: the femoral product form
    drops them, tibial cartilage keeps NaN out of the statistics."""
    def spoil(q):
        q = q.copy()
        inside = np.nonzero(q)
        pick = np.random.RandomState(3).permutation(len(inside[0]))[:60]
        sel = tuple(i[pick] for i in inside)
        q[sel] = np.tile([np.nan, 0.0, -5.0], 20)
        return q

    j, t, _, qmap = _both(name, qmap_fn=spoil)
    j.add_quantitative_value(JT2(JMV(qmap.copy(), _AFFINE)))
    t.add_quantitative_value(TT2(_port_map(qmap, "tensor")))
    j.calc_quant_vals()
    t.calc_quant_vals()
    assert_frames_match(t.quant_vals["T2"][1], j.quant_vals["T2"][1], RTOL_F64)
    assert_maps_match(t.quant_vals["T2"][0], j.quant_vals["T2"][0], RTOL_F64)


@pytest.mark.parametrize("name", ["FemoralCartilage", "PatellarCartilage", "Meniscus"])
def test_a_map_in_another_orientation_is_reformatted_to_the_mask(name):
    """``quant_rows`` reformats the map in place to the mask's orientation,
    on the map's own device (here a CPU tensor)."""
    j, t, _, qmap = _both(name)
    jm = JMV(qmap.copy(), _AFFINE).reformat(dt.AXIAL)
    tm = _port_map(qmap, "tensor").reformat(dt.AXIAL)
    j.add_quantitative_value(JT2(jm))
    t.add_quantitative_value(TT2(tm))
    j.calc_quant_vals()
    t.calc_quant_vals()
    assert tm.orientation == dt.SAGITTAL and isinstance(tm.volume, torch.Tensor)
    assert_frames_match(t.quant_vals["T2"][1], j.quant_vals["T2"][1], _TISSUES[name][3])


@pytest.mark.parametrize("name", list(_TISSUES))
def test_quant_rows_need_no_pandas(name, monkeypatch):
    """The row function is what runs where pandas is missing."""
    _, t, _, qmap = _both(name)
    monkeypatch.setitem(sys.modules, "pandas", None)
    header, rows, maps = t.quant_rows(_port_map(qmap, "tensor"), TT2().qv_type)
    assert header[0] == "Subject" and all(len(r) == len(header) for r in rows)
    assert len(maps) == 3
    with pytest.raises(ImportError):
        t.__calc_quant_vals__(_port_map(qmap, "numpy"), TT2().qv_type)


def test_a_map_of_another_shape_raises():
    _, t, mask, _ = _both("FemoralCartilage")
    bad = dt.MedicalVolume(np.ones(mask.shape[:2] + (mask.shape[2] + 4,), np.float32), _AFFINE)
    t.add_quantitative_value(TT2(bad))
    with pytest.raises(ValueError, match="does not match"):
        t.calc_quant_vals()


def test_tibial_unroll_axial_of_another_shape_raises():
    _, t, mask, _ = _both("TibialCartilage")
    with pytest.raises(ValueError, match="shape"):
        t.unroll_axial(np.zeros(tuple(s + 1 for s in mask.shape)))


def test_femoral_unroll_matches():
    j, t, _, qmap = _both("FemoralCartilage", shape=(48, 48, 9))
    got = t.unroll(qmap, t.regions_mask, t.theta_bins)
    want = j.unroll(qmap, j.regions_mask, j.theta_bins)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", ["FemoralCartilage", "TibialCartilage", "PatellarCartilage",
                                  "Meniscus"])
def test_save_data_and_load_data_round_trip(name, tmp_path):
    """The port writes the mask, the map, the figures and ``data.xlsx``; the
    port and ``dosma_tpu`` both load them back, and the reloaded tissue's
    rows equal the first ones."""
    _, t, mask, qmap = _both(name)
    t.add_quantitative_value(TT2(_port_map(qmap, "numpy")))
    t.calc_quant_vals()
    t.save_data(str(tmp_path))
    root = tmp_path / t.STR_ID
    for rel in (f"{t.STR_ID}.nii.gz", "t2/t2.nii.gz", "data.xlsx"):
        assert (root / rel).is_file(), rel
    assert len(os.listdir(root / "t2")) > 1  # the map and the figures' folder
    if name == "FemoralCartilage":
        assert (root / "region_map.png").is_file()

    jcls, tcls, kw, rtol, _ = _TISSUES[name]
    t2, j2 = tcls(**kw), jcls(**kw)
    t2.load_data(str(tmp_path))
    j2.load_data(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(t2.get_mask().A), mask)
    np.testing.assert_array_equal(np.asarray(j2.get_mask().A), mask)
    assert len(t2.quantitative_values) == 1
    np.testing.assert_array_equal(np.asarray(t2.quantitative_values[0].volumetric_map.A),
                                  qmap)
    t2.calc_quant_vals()
    j2.calc_quant_vals()
    assert_frames_match(t2.quant_vals["T2"][1], t.quant_vals["T2"][1], 0)
    assert_frames_match(t2.quant_vals["T2"][1], j2.quant_vals["T2"][1], rtol)


def test_load_data_splits_the_regions(tmp_path):
    """``load_data`` goes through ``set_mask``, so the regions are split."""
    mask = np.zeros((32, 32, 8), np.uint8)
    mask[8:24, 8:24, 2:6] = 1
    t = tt.TibialCartilage()
    t.set_mask(dt.MedicalVolume(mask, dt.to_affine(dt.SAGITTAL, (0.5, 0.5, 1.0))))
    t.save_data(str(tmp_path))
    t2 = tt.TibialCartilage()
    t2.load_data(str(tmp_path))
    assert t2.regions_mask is not None
    np.testing.assert_array_equal(t2.regions_mask, t.regions_mask)


def test_find_weights_extension_rule(tmp_path):
    """A name that contains STR_ID and ends in ``h5``: ``.hdf5`` does not."""
    (tmp_path / "iwoai_fc_weights.hdf5").write_bytes(b"x")
    fc = tt.FemoralCartilage()
    with pytest.raises(ValueError, match="No file found"):
        fc.find_weights(str(tmp_path))
    good = tmp_path / "iwoai_fc_weights.h5"
    good.write_bytes(b"x")
    assert fc.find_weights(str(tmp_path)) == str(good)
    assert tt.FemoralCartilage(weights_dir=str(tmp_path)).weights_file_path == str(good)


def test_handle_knee_matches(tmp_path):
    """``handle_knee`` on the tissues saved by the port: the same tables as
    ``dosma_tpu``'s ``handle_knee`` on the same files."""
    from dosma_tpu.msk import knee as jknee
    from dosma_tpu_torch.msk import knee as tknee

    load_dir = tmp_path / "load"
    for name in ("FemoralCartilage", "TibialCartilage", "PatellarCartilage", "Meniscus"):
        _, t, _, qmap = _both(name)
        t.add_quantitative_value(TT2(_port_map(qmap, "numpy")))
        t.save_data(str(load_dir))

    def run(knee, pkg, out):
        vargin = {knee.TISSUES_KEY: None, knee.LOAD_KEY: str(load_dir),
                  knee.SAVE_KEY: str(tmp_path / out), knee.MEDIAL_TO_LATERAL_KEY: True,
                  knee.PID_KEY: "test-pid", "t2": True, "t1_rho": False, "t2_star": False}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return knee.handle_knee(vargin)

    got = run(tknee, tt, "save_port")
    want = run(jknee, jt, "save_jax")
    assert [t.STR_ID for t in got] == [t.STR_ID for t in want] == ["fc", "men", "tc", "pc"]
    for g, w in zip(got, want):
        rtol = RTOL_F64 if g.STR_ID in ("fc", "tc") else RTOL_F32
        assert_frames_match(g.quant_vals["T2"][1], w.quant_vals["T2"][1], rtol)
        assert os.path.isfile(tmp_path / "save_port" / g.STR_ID / "data.xlsx")


def test_knee_parser_flags():
    import argparse

    from dosma_tpu_torch.msk import knee

    parser = argparse.ArgumentParser()
    knee.knee_parser(parser.add_subparsers())
    ns = parser.parse_args(["knee", "--fc", "--t2", "--ml", "--pid", "p1"])
    assert ns.fc and ns.t2 and ns.ml and not ns.tc and ns.pid == "p1"
    assert ns.func is knee.handle_knee


def test_add_quantitative_value_of_a_host_map_copies_nothing():
    """A tissue whose analytics read the whole map (``_PREFETCH_FULL_MAP``)
    starts its copy to the host when it is registered: a no-op for a host
    map. The knee tissues gather the masked voxels instead."""
    class WholeMap(tt.PatellarCartilage):
        _PREFETCH_FULL_MAP = True

    mask, qmap = fc_mask_and_map()
    t = WholeMap()
    t.set_mask(dt.MedicalVolume(mask, _AFFINE))
    vm = _port_map(qmap, "tensor")
    vol = vm.volume
    t.add_quantitative_value(TT2(vm))
    assert vm.volume is vol and vm._host_copy is None
    assert [cls._PREFETCH_FULL_MAP for cls in (tt.FemoralCartilage, tt.TibialCartilage,
                                               tt.PatellarCartilage, tt.Meniscus)] == [False] * 4
