"""The port's U-Net (``dosma_tpu_torch.models.unet2d``) against the JAX
package's (XLA on the CPU), with JAX's parameters carried across.

Tolerances:
- transpose convolution and float32 forwards: atol 1e-5 on probabilities
  (the golden fixtures' tolerance, ``tests/models/test_unet2d.py``); a
  golden mask may differ only where |p - 0.5| < 1e-5;
- bfloat16 against JAX's bfloat16: max |Δp| <= 2**-7, two bfloat16 steps
  at 0.5 (the two round their convolutions' float32 sums differently);
  masks may differ only where JAX's p is within 2**-7 of 0.5;
- masks from the packed paths: bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dosma_tpu.models import seg_model as jseg
from dosma_tpu.models import unet2d as J
from dosma_tpu_torch.models import seg_model as tseg
from dosma_tpu_torch.models import unet2d as T


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


NARROW = [4, 8, 16, 32, 64, 128]
_DATA = os.path.join(os.path.dirname(__file__), "data")


def random_unet_params(seed=3, num_classes=4, features=NARROW, in_channels=1):
    """U-Net parameters in the JAX package's layout (numpy float32 leaves):
    He-normal kernels, and biases and BatchNorm statistics drawn away from
    their initial zeros and ones so that each takes part."""
    rs = np.random.RandomState(seed)

    def conv(kh, cin, cout, transpose=False):
        w = rs.randn(kh, kh, cin, cout) * np.sqrt(2.0 / (kh * kh * cin))
        w = w.transpose(0, 1, 3, 2) if transpose else w  # Keras (kh, kw, out, in)
        return {"w": np.ascontiguousarray(w, np.float32),
                "b": (rs.randn(cout) * 0.05).astype(np.float32)}

    def bn(f):
        return {"gamma": rs.uniform(0.5, 1.5, f).astype(np.float32),
                "beta": (rs.randn(f) * 0.1).astype(np.float32),
                "mean": (rs.randn(f) * 0.1).astype(np.float32),
                "var": rs.uniform(0.5, 1.5, f).astype(np.float32)}

    params = {"down": [], "up": [None] * (len(features) - 1), "final": None}
    cin = in_channels
    for f in features:
        params["down"].append({"conv1": conv(3, cin, f), "conv2": conv(3, f, f), "bn": bn(f)})
        cin = f
    for d in range(len(features) - 2, -1, -1):
        f = features[d]
        params["up"][d] = {"convT": conv(3, features[d + 1], f, transpose=True),
                           "conv1": conv(3, 2 * f, f), "conv2": conv(3, f, f), "bn": bn(f)}
    params["final"] = conv(1, features[0], num_classes)
    return params


def _narrow_params(num_classes=4, features=NARROW):
    return random_unet_params(num_classes=num_classes, features=features)


def _models(params, num_classes, shape=(64, 64, 1), precision="float32"):
    jm = J.Unet2D(shape, num_classes=num_classes, precision=precision)
    tm = T.Unet2D(shape, num_classes=num_classes, precision=precision)
    jm.params = params
    tm.params = params
    return jm, tm


@pytest.mark.parametrize("stride", [2, 3])
def test_conv_transpose_matches_jax(stride):
    rs = np.random.RandomState(0)
    x = rs.rand(2, 6, 6, 3).astype(np.float32)
    w_keras = rs.rand(3, 3, 5, 3).astype(np.float32)  # (kh, kw, out, in)
    b = rs.rand(5).astype(np.float32)
    want = np.asarray(J._conv_transpose_same(jnp.asarray(x), jnp.asarray(w_keras),
                                             jnp.asarray(b), stride))
    got = T.conv_transpose_same(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w_keras).permute(3, 2, 0, 1), torch.from_numpy(b), stride,
    ).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 6 * stride, 6 * stride, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_full_width_forward_matches_golden_fixtures():
    params = J.init_unet2d_params(jax.random.PRNGKey(7), num_classes=4)
    net = T.UNet2D.from_params(params)
    assert net.features == J.FEATURES
    assert sum(p.numel() for p in net.state_dict().values()) == 34_597_892
    x = np.random.RandomState(11).rand(2, 96, 96, 1).astype(np.float32)
    with torch.inference_mode():
        probs = net(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()

    golden_probs = np.load(os.path.join(_DATA, "unet2d_golden_probs_sample.npy"))
    golden_mask = np.load(os.path.join(_DATA, "unet2d_golden_mask.npy"))
    np.testing.assert_allclose(probs[:, ::16, ::16, :], golden_probs, rtol=0, atol=1e-5)
    disagree = (probs > 0.5).astype(np.uint8) != golden_mask
    assert np.all(np.abs(probs[disagree] - 0.5) < 1e-5)


def test_odd_pooling_path_matches_jax():
    # 288 -> 144 -> 72 -> 36 -> 18 -> 9: the decoder's last transpose
    # convolution runs at stride 2 onto 18, the pools before it at 2.
    params = _narrow_params()
    x = np.random.RandomState(1).rand(1, 288, 288, 1).astype(np.float32)
    want = np.asarray(jax.jit(J.unet2d_forward)(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = T.UNet2D.from_params(params)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


def test_stride_three_path_matches_jax():
    # 54 -> 27 (odd) -> 9 -> 3 -> 1: pools and transpose convolutions of
    # stride 3.
    params = _narrow_params(features=NARROW[:5])
    x = np.random.RandomState(2).rand(2, 54, 54, 1).astype(np.float32)
    want = np.asarray(jax.jit(J.unet2d_forward)(params, jnp.asarray(x)))
    with torch.inference_mode():
        got = T.UNet2D.from_params(params)(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=0, atol=1e-5)


def test_incompatible_size_raises():
    # 100 -> 50 -> 25 -> (3x3 pool) 8; the transpose convolution gives 24.
    params = _narrow_params(num_classes=1)
    with pytest.raises(ValueError, match="size mismatch"), torch.inference_mode():
        T.UNet2D.from_params(params)(torch.zeros(1, 1, 100, 100))


def test_predict_matches_jax():
    params = _narrow_params()
    jm, tm = _models(params, 4)
    v = np.random.RandomState(4).rand(5, 64, 64, 1).astype(np.float32)
    got = tm.predict(v, batch_size=2)
    assert got.dtype == np.float32 and got.shape == (5, 64, 64, 4)
    np.testing.assert_allclose(got, jm.predict(v, batch_size=2), rtol=0, atol=1e-5)


def test_bfloat16_matches_jax_bfloat16():
    params = _narrow_params()
    jm, tm = _models(params, 4, precision="bfloat16")
    v = np.random.RandomState(0).rand(3, 64, 64, 1).astype(np.float32)
    want = jm.predict(v, batch_size=2)
    got = tm.predict(v, batch_size=2)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= 2.0**-7
    flips = (got > 0.5) != (want > 0.5)
    assert np.all(np.abs(want[flips] - 0.5) <= 2.0**-7)
    # The parameters were cast once, to bfloat16.
    assert all(p.dtype == torch.bfloat16 for p in tm.network("cpu").state_dict().values())


@pytest.mark.parametrize("num_classes,width,features", [
    (1, 64, NARROW),  # 1 bit a pixel, 8 pixels a byte
    (2, 64, NARROW),  # 2 bits, 4 pixels a byte
    (4, 64, NARROW),  # 4 bits, 2 pixels a byte
    (6, 64, NARROW),  # a whole byte a pixel
    (1, 36, NARROW[:3]),  # width 36 is no multiple of 8: whole bytes
    (9, 64, NARROW),  # more than 8 classes: the per-class mask
])
def test_predict_mask_matches_jax(num_classes, width, features):
    params = _narrow_params(num_classes=num_classes, features=features)
    jm, tm = _models(params, num_classes, shape=(64, width, 1))
    v = (np.random.RandomState(5).rand(5, 64, width, 1) * 1000).astype(np.float32)
    kw = dict(batch_size=2, threshold=0.5, mean=480.0, std=290.0)
    want = jm.predict_mask(v, **kw)
    got = tm.predict_mask(v, **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape == (5, 64, width, num_classes)
    assert 0 < got.mean() < 1
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num_classes", [1, 2, 4, 6])
@pytest.mark.parametrize("whiten", [False, True])
def test_segment_volume_matches_jax(num_classes, whiten):
    params = _narrow_params(num_classes=num_classes)
    jm, tm = _models(params, num_classes)
    # 5 slices in batches of 2: the last batch is short.
    vol = (np.random.RandomState(6).rand(64, 64, 5) * 900).astype(np.float32)
    kw = dict(batch_size=2, threshold=0.5, whiten=whiten, whiten_eps=1e-8)
    want = jm.predict_mask_volume(jnp.asarray(vol), **kw)
    got = tm.predict_mask_volume(torch.from_numpy(vol), **kw)
    assert got.dtype == np.uint8 and got.shape == want.shape == (5, 64, 64, num_classes)
    np.testing.assert_array_equal(got, want)
    # The batched path gives the same masks.
    mean, std = tseg.whiten_stats(vol, eps=1e-8) if whiten else (0.0, 1.0)
    slices = np.transpose(vol, (2, 0, 1))[..., None]
    np.testing.assert_array_equal(
        tm.predict_mask(slices, batch_size=2, mean=mean, std=std), got)


def test_segment_volume_of_uint16_matches_jax():
    params = _narrow_params()
    jm, tm = _models(params, 4)
    vol = (np.random.RandomState(8).rand(64, 64, 3) * 4000).astype(np.uint16)
    kw = dict(batch_size=64, threshold=0.5, whiten=True, whiten_eps=0.0)
    np.testing.assert_array_equal(tm.predict_mask_volume(vol, **kw),
                                  jm.predict_mask_volume(jnp.asarray(vol), **kw))


def test_segment_volume_refuses_unpackable_width():
    _, tm = _models(_narrow_params(), 4)
    assert tm.fits_packed_volume(64) and not tm.fits_packed_volume(97)
    with pytest.raises(ValueError, match="constraints"):
        tm.predict_mask_volume(torch.zeros(64, 97, 4), batch_size=4)


def test_whiten_stats_match_jax_and_numpy():
    vol = (np.random.RandomState(9).rand(16, 12, 5) * 1000).astype(np.float32)
    assert tseg.whiten_stats(vol, eps=1e-8) == jseg.whiten_stats(vol, eps=1e-8)
    mean, std = tseg.whiten_stats(torch.from_numpy(vol), eps=0.5)
    assert mean.shape == std.shape == () and mean.device.type == "cpu"
    np.testing.assert_allclose(float(mean), np.mean(vol, dtype=np.float64), rtol=1e-6)
    # The population std (ddof 0), as jnp.std and np.std.
    np.testing.assert_allclose(float(std), np.std(vol, dtype=np.float64) + 0.5, rtol=1e-6)
    jmean, jstd = jseg.whiten_stats(jnp.asarray(vol), eps=0.5)
    np.testing.assert_allclose([float(mean), float(std)], [float(jmean), float(jstd)], rtol=1e-6)
    np.testing.assert_allclose(tseg.whiten_volume(vol, eps=1e-8),
                               jseg.whiten_volume(vol, eps=1e-8), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        tseg.whiten_stats(np.zeros((2, 2)))


def test_params_are_drawn_lazily_and_reset_the_networks():
    tm = T.Unet2D((64, 64, 1), num_classes=2)
    assert tm._params is None
    params = tm.params
    assert [blk["conv1"]["w"].shape[-1] for blk in params["down"]] == T.FEATURES
    assert params["up"][0]["convT"]["w"].shape == (3, 3, 32, 64)  # (kh, kw, out, in)
    assert params["final"]["w"].shape == (1, 1, 32, 2)
    net = tm.network("cpu")
    assert tm.network("cpu") is net
    tm.params = _narrow_params(num_classes=2)
    assert tm.network("cpu") is not net
    assert tm.network("cpu").features == NARROW


def test_init_params_are_he_normal():
    params = T.init_unet2d_params(torch.Generator().manual_seed(0), features=[8, 16, 32])
    w = params["down"][2]["conv2"]["w"]  # fan-in 3 * 3 * 32
    assert abs(float(w.std()) - np.sqrt(2.0 / 288)) < 0.01
    again = T.init_unet2d_params(torch.Generator().manual_seed(0), features=[8, 16, 32])
    assert torch.equal(again["down"][2]["conv2"]["w"], w)


def test_cudnn_exact_scope_restores_the_flags():
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    try:
        cudnn.allow_tf32, cudnn.deterministic = True, False
        with T.cudnn_exact():
            assert (cudnn.allow_tf32, cudnn.deterministic) == (False, True)
        assert (cudnn.allow_tf32, cudnn.deterministic) == (True, False)
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev


def test_invalid_arguments_raise():
    with pytest.raises(ValueError):
        T.Unet2D((64, 64, 2))
    with pytest.raises(ValueError):
        T.Unet2D((64, 64, 1), precision="float16")
