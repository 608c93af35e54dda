"""The plain U-Net reference (``qmri_bench/reference/unet2d.py``, float64,
no part of the port) against the golden fixtures, and the port's U-Net and
``generate_mask`` against it on seeded random weights whose BatchNorm
statistics are drawn (so that BatchNorm is no identity).

Tolerances:
- probabilities: atol 1e-5, the golden fixtures' tolerance
  (``tests/models/test_unet2d.py``): the port's float32 forward, about
  twenty convolutions deep, against the reference's float64 one;
- masks: may differ only where the reference's probability lies within
  1e-5 of 0.5, where that float32 rounding can move a voxel across the
  threshold.
"""

import os

import jax
import numpy as np
import pytest
import torch

import dosma_tpu_torch as dt
from dosma_tpu.models import unet2d as J
from dosma_tpu_torch.models import unet2d as T
from qmri_bench.reference import unet2d as R
from tests.test_torch_unet2d import NARROW, random_unet_params

ATOL = 1e-5
_DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    with dt.default_device("cpu"):
        yield


def _reference_probs(params, x_nchw):
    with torch.no_grad():
        return R.forward(R.prepare(params, "cpu"), x_nchw.to(torch.float64))


def _assert_masks_agree(got, want, probs):
    """Masks equal but where the reference's probability is within ATOL of 0.5."""
    differ = got != want
    assert np.all(np.abs(probs[differ] - 0.5) < ATOL), int(differ.sum())
    assert 0 < want.mean() < 1


def test_reference_matches_golden_fixtures():
    params = J.init_unet2d_params(jax.random.PRNGKey(7), num_classes=4)
    x = np.random.RandomState(11).rand(2, 96, 96, 1).astype(np.float32)
    probs = _reference_probs(params, torch.from_numpy(x).permute(0, 3, 1, 2))
    probs = probs.permute(0, 2, 3, 1).numpy()
    golden_probs = np.load(os.path.join(_DATA, "unet2d_golden_probs_sample.npy"))
    golden_mask = np.load(os.path.join(_DATA, "unet2d_golden_mask.npy"))
    np.testing.assert_allclose(probs[:, ::16, ::16, :], golden_probs, rtol=0, atol=ATOL)
    disagree = (probs > 0.5).astype(np.uint8) != golden_mask
    assert np.all(np.abs(probs[disagree] - 0.5) < ATOL)


@pytest.mark.parametrize("features,size,num_classes", [
    (NARROW, 64, 4),  # the even path: pools and transpose convolutions of stride 2
    (NARROW, 64, 1),  # a one-class head
    (T.FEATURES, 96, 4),  # full width
    (NARROW, 288, 4),  # 288 -> 144 -> 72 -> 36 -> 18 -> 9, the odd bottom
    (NARROW, 162, 4),  # 162 -> 81 -> 27 -> 9 -> 3 -> 1: stride-3 pools and decoder
    (NARROW[:5], 54, 4),  # 54 -> 27 -> 9 -> 3 -> 1 at depth 5
], ids=["narrow", "one-class", "full-width", "odd-288", "stride3-162", "stride3-54"])
def test_port_forward_equals_reference(features, size, num_classes):
    params = random_unet_params(seed=size, num_classes=num_classes, features=features)
    x = torch.from_numpy(np.random.RandomState(size).randn(2, 1, size, size).astype(np.float32))
    with torch.inference_mode():
        got = T.UNet2D.from_params(params)(x)
    want = _reference_probs(params, x)
    assert got.shape == want.shape == (2, num_classes, size, size)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ATOL)


MODELS = {"IWOAIOAIUnet2DNormalized": 0.0, "OAIUnet2D": 1e-8, "IWOAIOAIUnet2D": None,
          "StanfordQDessUNet2D": 1e-8}


@pytest.mark.parametrize("name,dtype", [
    ("IWOAIOAIUnet2DNormalized", np.float32),
    ("IWOAIOAIUnet2DNormalized", np.uint16),
    ("OAIUnet2D", np.float32),
    ("OAIUnet2D", np.uint16),
    ("IWOAIOAIUnet2D", np.float32),
    ("StanfordQDessUNet2D", np.uint16),
])
def test_generate_mask_equals_reference(name, dtype):
    """``generate_mask`` of a sagittal volume against the reference's masks,
    class ``c`` of the head as the model's ``CATEGORIES[c]``; whitening eps
    0 (the normalized IWOAI model), 1e-8 (the OAI and qDESS models) or none
    (the IWOAI model on raw intensities)."""
    model_cls = getattr(dt.models, name)
    eps = MODELS[name]
    num_classes = len(getattr(model_cls, "CATEGORIES", [None]))
    params = random_unet_params(seed=21, num_classes=num_classes)
    shape = (64, 64, 5)
    scale = 1000.0 if eps is not None else 1.0
    arr = (np.random.RandomState(5).rand(*shape) * scale).astype(dtype)
    vol = dt.MedicalVolume(arr, dt.to_affine(dt.SAGITTAL, (0.3, 0.3, 0.7)))

    model = model_cls(shape[:2] + (1,), None, force_weights=True)
    model.seg_model.params = params
    out = model.generate_mask(vol)
    names = getattr(model_cls, "CATEGORIES", None)
    got = np.stack([out[c].A for c in names] if names else [out.A], axis=-1)  # (H, W, S, C)

    want, probs = R.segment(params, torch.from_numpy(arr.astype(np.int32) if dtype == np.uint16
                                                     else arr), eps, batch_size=2,
                            probabilities=True)
    assert got.dtype == np.uint8 and got.shape == shape + (num_classes,)
    _assert_masks_agree(got, want.permute(1, 2, 0, 3).numpy(), probs.permute(1, 2, 0, 3).numpy())


def test_reference_imports_nothing_of_the_program():
    import ast

    tree = ast.parse(open(R.__file__).read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert not {n.split(".")[0] for n in names} & {"dosma_tpu_torch", "dosma_tpu", "jax"}


def test_reference_scope_turns_tf32_off_and_restores_it():
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = cuda.allow_tf32, cudnn.allow_tf32
    try:
        cuda.allow_tf32 = cudnn.allow_tf32 = True
        with R.precision():
            assert (cuda.allow_tf32, cudnn.allow_tf32) == (False, False)
        assert (cuda.allow_tf32, cudnn.allow_tf32) == (True, True)
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = prev
