"""The port's segmentation models (``dosma_tpu_torch.models``) against the
JAX package's: ``generate_mask`` of every model on the same axial volume,
with the same parameters set on both, must give equal masks (bit for bit)
in the input's orientation; the registry, configs, weight-file names and
the precision preference must behave as in ``dosma_tpu``.
"""

import numpy as np
import pytest
import torch

import dosma_tpu as dm
import dosma_tpu.models as jmodels
import dosma_tpu_torch as dt
import dosma_tpu_torch.models as tmodels
from tests.test_torch_unet2d import random_unet_params


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


SHAPE = (64, 64, 5)  # sagittal (H, W, slices)
MODELS = ["OAIUnet2D", "IWOAIOAIUnet2D", "IWOAIOAIUnet2DNormalized", "StanfordQDessUNet2D"]
HEADS = {"OAIUnet2D": 1, "IWOAIOAIUnet2D": 4, "IWOAIOAIUnet2DNormalized": 4,
         "StanfordQDessUNet2D": 4}


def _pair(name, params, input_shape=SHAPE[:2] + (1,)):
    """The JAX and the port's model ``name`` with ``params`` set on both."""
    out = []
    for pkg in (jmodels, tmodels):
        model = getattr(pkg, name)(input_shape, None, force_weights=True)
        model.seg_model.params = params
        out.append(model)
    return out


def _volumes(shape=SHAPE, seed=0, orientation=dm.AXIAL, dtype=np.float32, scale=100.0):
    """The same volume for each package: made sagittal, reformatted to
    ``orientation`` (so the models' reformats do work)."""
    arr = (np.random.RandomState(seed).rand(*shape) * scale).astype(dtype)
    jv = dm.MedicalVolume(arr, dm.to_affine(dm.SAGITTAL, (0.3, 0.3, 0.7))).reformat(orientation)
    tv = dt.MedicalVolume(arr, dt.to_affine(dt.SAGITTAL, (0.3, 0.3, 0.7))).reformat(orientation)
    return jv, tv


def _assert_same_masks(want, got):
    if isinstance(want, dict):
        assert list(got) == list(want)
        pairs = [(want[k], got[k]) for k in want]
    else:
        pairs = [(want, got)]
    for w, g in pairs:
        assert isinstance(g, dt.MedicalVolume)
        assert isinstance(g.volume, np.ndarray) and g.volume.dtype == np.uint8
        assert g.orientation == w.orientation
        np.testing.assert_array_equal(g.affine, w.affine)
        np.testing.assert_array_equal(g.volume, np.asarray(w.volume))
    assert any(0 < g.volume.mean() < 1 for _, g in pairs)


@pytest.mark.parametrize("name", MODELS)
def test_generate_mask_matches_jax(name):
    jm, tm = _pair(name, random_unet_params(num_classes=HEADS[name]))
    jv, tv = _volumes()
    want, got = jm.generate_mask(jv), tm.generate_mask(tv)
    _assert_same_masks(want, got)
    vols = list(got.values()) if isinstance(got, dict) else [got]
    assert all(v.orientation == tv.orientation and v.shape == tv.shape for v in vols)


def test_stanford_two_echo_input_matches_jax():
    params = random_unet_params(num_classes=4)
    jm, tm = _pair("StanfordQDessUNet2D", params)
    jv, tv = _volumes(shape=SHAPE + (2,))
    want, got = jm.generate_mask(jv), tm.generate_mask(tv)
    _assert_same_masks(want, got)
    assert got["pc"].shape == tv.shape[:3]
    with pytest.raises(ValueError):
        tm.generate_mask(dt.MedicalVolume(np.zeros((4, 4, 4, 2, 2)), np.eye(4)))


def test_category_order():
    params = random_unet_params(num_classes=4)
    tv = _volumes()[1]
    assert list(_pair("IWOAIOAIUnet2D", params)[1].generate_mask(tv)) == ["fc", "tc", "pc", "men"]
    assert list(_pair("StanfordQDessUNet2D", params)[1].generate_mask(tv)) == [
        "pc", "fc", "tc", "men"]


def test_uint16_volume_matches_jax():
    jm, tm = _pair("IWOAIOAIUnet2DNormalized", random_unet_params(num_classes=4))
    jv, tv = _volumes(dtype=np.uint16, scale=4000.0)
    _assert_same_masks(jm.generate_mask(jv), tm.generate_mask(tv))


@pytest.mark.parametrize("name", ["OAIUnet2D", "IWOAIOAIUnet2D"])
def test_unpackable_width_takes_the_batched_path(name):
    # A 3-depth network takes a width of 36, which no packed byte divides
    # for one class (8 pixels a byte); four classes pack 2 pixels a byte.
    params = random_unet_params(num_classes=HEADS[name], features=[4, 8, 16])
    jm, tm = _pair(name, params, input_shape=(36, 36, 1))
    assert tm.seg_model.fits_packed_volume(36) == (HEADS[name] == 4)
    jv, tv = _volumes(shape=(36, 36, 3))
    _assert_same_masks(jm.generate_mask(jv), tm.generate_mask(tv))


def test_volume_on_a_tensor_gives_the_host_volume_masks():
    _, tm = _pair("IWOAIOAIUnet2DNormalized", random_unet_params(num_classes=4))
    tv = _volumes()[1]
    on_tensor = tv._partial_clone(volume=torch.from_numpy(np.ascontiguousarray(tv.volume)))
    got, want = tm.generate_mask(on_tensor), tm.generate_mask(tv)
    for k in want:
        assert isinstance(got[k].volume, np.ndarray)
        np.testing.assert_array_equal(got[k].volume, want[k].volume)


def test_get_model_and_aliases():
    for name in MODELS:
        cls = getattr(tmodels, name)
        assert tmodels.util._REGISTRY[name] is cls
        for alias in cls.ALIASES:
            assert isinstance(tmodels.get_model(alias, SHAPE[:2] + (1,), None,
                                                force_weights=True), cls)
    assert tmodels.SUPPORTED_MODELS == jmodels.SUPPORTED_MODELS
    assert sorted(tmodels.util._REGISTRY) == sorted(jmodels.util._REGISTRY)
    with pytest.raises(LookupError):
        tmodels.get_model("nope", SHAPE[:2] + (1,), None)


def _pt_weights(tmp_path, num_classes, name="custom.pt"):
    from dosma_tpu_torch.models.weights import state_dict_from_params

    params = random_unet_params(num_classes=num_classes)
    path = str(tmp_path / name)
    torch.save(state_dict_from_params(params), path)
    return path, params


@pytest.mark.parametrize("as_yaml", [False, True])
def test_model_from_config(tmp_path, as_yaml):
    path, params = _pt_weights(tmp_path, 4)
    cfg = {"DOSMA_MODEL": "iwoai-2019-t6", "CATEGORIES": ["a", "b", "c", "d"],
           "WEIGHTS_FILE": "custom.pt"}
    if as_yaml:
        import yaml

        cfg_path = tmp_path / "model.yml"
        cfg_path.write_text(yaml.safe_dump(cfg))
        cfg = str(cfg_path)
    model = tmodels.model_from_config(cfg, weights_dir=str(tmp_path),
                                      input_shape=SHAPE[:2] + (1,))
    tv = _volumes()[1]
    masks = model.generate_mask(tv)
    assert list(masks) == ["a", "b", "c", "d"]
    _, ref = _pair("IWOAIOAIUnet2D", params)
    for k, cat in zip("abcd", ref.CATEGORIES):
        np.testing.assert_array_equal(masks[k].volume, ref.generate_mask(tv)[cat].volume)


def test_model_from_config_needs_a_weights_dir():
    cfg = {"DOSMA_MODEL": "iwoai-2019-t6", "CATEGORIES": ["a"], "WEIGHTS_FILE": "missing.pt"}
    with pytest.raises(ValueError, match="weights_dir"):
        tmodels.model_from_config(cfg, input_shape=SHAPE[:2] + (1,))
    with pytest.raises(LookupError):
        tmodels.model_from_config(dict(cfg, DOSMA_MODEL="nope"), weights_dir="/nonexistent",
                                  input_shape=SHAPE[:2] + (1,))


def test_weights_filename_check(tmp_path):
    cls = tmodels.IWOAIOAIUnet2D
    with pytest.raises(ValueError, match="not supported"):
        cls(SHAPE[:2] + (1,), weights_path=str(tmp_path / "bad.h5"))
    stem = cls._WEIGHTS_FILE[: -len(".h5")]
    path, params = _pt_weights(tmp_path, 4, name=stem + ".pt")
    model = cls(SHAPE[:2] + (1,), weights_path=path)
    np.testing.assert_array_equal(model.seg_model.params["final"]["w"], params["final"]["w"])
    h5py = pytest.importorskip("h5py")  # noqa: F841
    from dosma_tpu_torch.models.weights import save_keras_unet2d_weights

    h5 = str(tmp_path / cls._WEIGHTS_FILE)
    save_keras_unet2d_weights(h5, params)
    np.testing.assert_array_equal(cls(SHAPE[:2] + (1,), h5).seg_model.params["final"]["b"],
                                  params["final"]["b"])
    normalized = tmodels.IWOAIOAIUnet2DNormalized
    with pytest.raises(ValueError, match="not supported"):
        normalized(SHAPE[:2] + (1,), h5)


@pytest.fixture
def _restore_precision():
    old = dt.preferences.segmentation_precision
    yield
    dt.preferences.set("segmentation/precision", old)


def test_precision_preference_reaches_the_models(tmp_path, _restore_precision):
    path, params = _pt_weights(tmp_path, 1, name="oai-unet2d_fc_weights.pt")
    dt.preferences.set("precision", "bfloat16", prefix="segmentation")
    model = tmodels.OAIUnet2D(SHAPE[:2] + (1,), path)
    assert model.seg_model.precision == "bfloat16"
    tv = _volumes()[1]
    mask16 = model.generate_mask(tv).volume
    dt.preferences.set("precision", "float32", prefix="segmentation")
    model32 = tmodels.OAIUnet2D(SHAPE[:2] + (1,), path)
    assert model32.seg_model.precision == "float32"
    # bfloat16 masks agree with float32 away from the decision boundary.
    assert np.mean(mask16 != model32.generate_mask(tv).volume) < 0.02
    assert model32.batch_size == dt.preferences.segmentation_batch_size == 64
