"""The port's weights module (``dosma_tpu_torch.models.weights``) against the
JAX package's: the same ``.h5`` files decode to the same parameters, with
the same ``params_checksum`` digest; ``.pt`` state dicts carry the same
parameters to a machine without h5py. Tests that read or write ``.h5``
files need h5py and skip without it.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dosma_tpu.models import weights as JW
from dosma_tpu_torch.models import weights as TW
from dosma_tpu_torch.models.unet2d import UNet2D, Unet2D
from tests.test_torch_unet2d import random_unet_params


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


@pytest.fixture
def h5py():
    return pytest.importorskip("h5py")


def _leaves(params):
    return sorted((path, np.asarray(leaf)) for path, leaf in TW._leaves_with_paths(params))


def _assert_same_params(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.shape == y.shape, path
        np.testing.assert_array_equal(x, y, err_msg=path)


def test_checksum_equals_the_jax_digest():
    params = jax.tree_util.tree_map(jnp.asarray, random_unet_params(num_classes=4))
    digest = TW.params_checksum(params)
    assert digest == JW.params_checksum(params)
    # The same digest whatever the leaves are: numpy, torch, JAX.
    as_numpy = TW.params_from_state_dict(TW.state_dict_from_params(params))
    assert TW.params_checksum(as_numpy) == digest
    assert TW.params_checksum(random_unet_params(num_classes=4)) == JW.params_checksum(
        random_unet_params(num_classes=4))
    assert TW.params_checksum(random_unet_params(num_classes=1)) != TW.params_checksum(
        random_unet_params(num_classes=4))


def test_key_strings_follow_jax_keystr():
    paths = [p for p, _ in TW._leaves_with_paths(random_unet_params(features=[4, 8]))]
    want = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(
        random_unet_params(features=[4, 8]))[0]]
    assert sorted(paths) == sorted(want)
    assert "['down'][0]['bn']['beta']" in paths


def test_state_dict_round_trip():
    params = random_unet_params(num_classes=3)
    sd = TW.state_dict_from_params(params)
    net = UNet2D.from_params(params)
    assert list(net.state_dict()) == list(sd)
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k]), k
    # (out, in, kh, kw) and, for the transpose convolution, (in, out, kh, kw).
    assert sd["down.0.conv1.weight"].shape == (4, 1, 3, 3)
    assert sd["up.0.convT.weight"].shape == (8, 4, 3, 3)
    back = TW.params_from_state_dict(net.state_dict())
    _assert_same_params(back, params)
    assert all(isinstance(leaf, np.ndarray) for _, leaf in TW._leaves_with_paths(back))


def test_pt_conversion_and_load(tmp_path, h5py):
    params = random_unet_params(num_classes=4)
    h5 = str(tmp_path / "w.h5")
    JW.save_keras_unet2d_weights(h5, params)
    pt = str(tmp_path / "w.pt")
    rep = TW.convert_weights(h5, pt)
    assert rep["lossless"] and rep["sha256"] == JW.params_checksum(params)
    model = Unet2D((64, 64, 1), num_classes=4)
    model.load_weights(pt)
    _assert_same_params(model.params, params)
    assert TW.verify_weights(pt)["sha256"] == rep["sha256"]
    # Back to canonical .h5 from the .pt.
    h5_again = str(tmp_path / "again.h5")
    assert TW.convert_weights(pt, h5_again)["lossless"]
    _assert_same_params(JW.load_keras_unet2d_weights(h5_again), params)


def test_pt_load_needs_no_h5py(tmp_path, monkeypatch):
    import sys

    pt = str(tmp_path / "w.pt")
    torch.save(TW.state_dict_from_params(random_unet_params(num_classes=2)), pt)
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises
    model = Unet2D((64, 64, 1), num_classes=2)
    model.load_weights(pt)
    _assert_same_params(model.params, random_unet_params(num_classes=2))
    with pytest.raises(ImportError):
        TW.read_keras_h5(str(tmp_path / "w.h5"))


def test_h5_round_trip_matches_jax(tmp_path, h5py):
    params = random_unet_params(num_classes=4)
    path = str(tmp_path / "port.h5")
    TW.save_keras_unet2d_weights(path, params)
    _assert_same_params(TW.load_keras_unet2d_weights(path), params)
    _assert_same_params(JW.load_keras_unet2d_weights(path), params)
    jax_path = str(tmp_path / "jax.h5")
    JW.save_keras_unet2d_weights(jax_path, params)
    assert [n for n, _ in TW.read_keras_h5(jax_path)] == [n for n, _ in TW.read_keras_h5(path)]


def test_foreign_keras_fixture_loads_as_jax_does(tmp_path, h5py):
    from tests.models.test_weights_foreign import _model_order_specs, _write_foreign_h5

    path = str(tmp_path / "foreign_keras24.h5")
    _write_foreign_h5(path, _model_order_specs())
    got = TW.load_keras_unet2d_weights(path)
    _assert_same_params(got, JW.load_keras_unet2d_weights(path))
    assert float(got["up"][4]["convT"]["w"][0, 0, 0, 0]) == 200.0  # the first convT made
    assert TW.params_checksum(got) == JW.params_checksum(JW.load_keras_unet2d_weights(path))
    # Group order on disk does not matter, only layer_names.
    other = str(tmp_path / "shuffled.h5")
    _write_foreign_h5(other, _model_order_specs(), shuffle_seed=17)
    _assert_same_params(TW.load_keras_unet2d_weights(other), got)
    rep = TW.convert_weights(path, str(tmp_path / "canonical.h5"))
    assert rep["lossless"] and rep["sha256"] == TW.params_checksum(got)


def test_layer_count_checks(tmp_path, h5py):
    from tests.models.test_weights_foreign import _model_order_specs, _write_foreign_h5

    specs = _model_order_specs()
    path = str(tmp_path / "short.h5")
    _write_foreign_h5(path, [s for s in specs if s[0] != "batch_normalization_12"])
    with pytest.raises(ValueError, match="BatchNormalization"):
        TW.load_keras_unet2d_weights(path)
    _write_foreign_h5(path, [s for s in specs if s[0] != "conv2d_transpose_8"])
    with pytest.raises(ValueError, match="Conv2DTranspose"):
        TW.load_keras_unet2d_weights(path)


def test_cli_verify_and_convert(tmp_path, capsys, h5py):
    path = str(tmp_path / "w.h5")
    TW.save_keras_unet2d_weights(path, random_unet_params(num_classes=4))
    assert TW.main(["verify", path]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["roundtrip_ok"] and rep["num_classes"] == 4 and rep["arrays"] == 100
    jrep = JW.verify_weights(path)
    assert {k: rep[k] for k in ("arrays", "parameters", "sha256")} == {
        k: jrep[k] for k in ("arrays", "parameters", "sha256")}
    assert TW.main(["convert", path, str(tmp_path / "w.pt")]) == 0
    assert json.loads(capsys.readouterr().out)["lossless"]


def test_golden_regen_matches_jax(tmp_path, h5py):
    """Goldens regenerated by the port equal the JAX package's, from the
    same scan and weights."""
    import dosma_tpu as dm
    from dosma_tpu.models.weights import regenerate_goldens

    for pkg_dir in ("jax", "port"):
        data = tmp_path / pkg_dir
        (data / "datasets/oai").mkdir(parents=True)
        vol = dm.MedicalVolume(
            (np.random.RandomState(0).rand(64, 64, 4) * 100).astype(np.float32),
            dm.to_affine(dm.SAGITTAL, (0.3, 0.3, 0.7)),
        )
        dm.NiftiWriter().save(vol, str(data / "datasets/oai/test_001_V00.nii.gz"))
        for alias, fname, c in [
            ("iwoai-2019-t6-normalized",
             "iwoai-2019-unet2d-normalized_fc-tc-pc-men_weights.h5", 4),
            ("oai-unet2d", "oai-unet2d_fc_weights.h5", 1),
        ]:
            (data / "weights" / alias).mkdir(parents=True)
            JW.save_keras_unet2d_weights(str(data / "weights" / alias / fname),
                                         random_unet_params(num_classes=c))
    jrep = regenerate_goldens(str(tmp_path / "jax"))
    trep = TW.regenerate_goldens(str(tmp_path / "port"))
    assert trep == jrep
    assert trep["test_001_V00-iwoai-2019-t6.npy"] == "skipped (no weights)"
    for golden in ("test_001_V00-iwoai-2019-t6-normalized.npy", "test_001_V00-oai-unet2d-fc.npy"):
        want = np.load(tmp_path / "jax/datasets/oai/expected" / golden)
        got = np.load(tmp_path / "port/datasets/oai/expected" / golden)
        assert got.dtype == np.uint8 and 0 < got.mean() < 1
        np.testing.assert_array_equal(got, want)
    assert TW.regenerate_goldens(str(tmp_path / "port"))[
        "test_001_V00-oai-unet2d-fc.npy"].startswith("exists")
