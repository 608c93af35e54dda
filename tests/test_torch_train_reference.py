"""The port's U-Net training step (``SegTrainer``) against the plain float64
training step of ``qmri_bench/reference/unet2d_train.py`` (no part of the
port) on seeded random weights whose BatchNorm statistics are drawn, at a
small size on the CPU: features [4, 8, 16], 4 classes, batch 3, at 48x48
and at 45x45 (odd, so the stride-3 pooling and transpose convolution run).

Tolerances:
- loss: relative 1e-5, the port's float32 loss of some twenty convolutions
  and a sum over the batch against float64 (measured at most 1.3e-7);
- gradients: per leaf ``|g - g_ref| / |g_ref|`` at most 1e-4, as
  ``chip_smoke.py``'s ``TRAIN_GRAD_RTOL`` (measured at most 3.5e-6);
- parameters after 1 and 3 Adam steps: every element within 2 float32
  spacings of the reference's value plus a thousandth of the learning rate
  (the step's own rounding is half a spacing; measured at most one
  spacing).
"""

import numpy as np
import pytest
import torch

import dosma_tpu_torch as dt
from dosma_tpu_torch.models.weights import state_dict_from_params
from dosma_tpu_torch.train import SegTrainer
from qmri_bench.reference import unet2d_train as R
from tests.test_torch_unet2d import random_unet_params

FEATURES = [4, 8, 16]
CLASSES = 4
LR = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_TOL_SPACINGS = 2.0
PARAM_TOL_LR = 1e-3
SIZES = [48, 45]


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    with dt.default_device("cpu"):
        yield


def _case(size, seed=5):
    """Seeded parameters (nested, Keras layouts) and an NHWC batch: float32
    images and uint8 labels whose classes cover 20, 40, 60 and 80%."""
    params = random_unet_params(seed=seed, num_classes=CLASSES, features=FEATURES)
    rs = np.random.RandomState(size)
    images = rs.rand(3, size, size, 1).astype(np.float32)
    labels = (rs.rand(3, size, size, CLASSES) < [0.2, 0.4, 0.6, 0.8]).astype(np.uint8)
    return params, images, labels


def _nchw(images, labels):
    return (torch.from_numpy(images).permute(0, 3, 1, 2),
            torch.from_numpy(labels).permute(0, 3, 1, 2))


def _grad_gap(got, want):
    """The largest ``|g - g_ref| / |g_ref|`` over the leaves."""
    return max(float((got[k].double() - want[k]).norm() / want[k].norm()) for k in want)


def _spacing32(x):
    x32 = x.abs().float()
    return (torch.nextafter(x32, torch.full_like(x32, np.inf)) - x32).double()


def _params_off(got, want):
    """Elements of ``got`` further from ``want`` (float64) than the
    parameters' tolerance."""
    return sum(int(((got[k].double() - want[k]).abs()
                    > PARAM_TOL_SPACINGS * _spacing32(want[k]) + PARAM_TOL_LR * LR).sum())
               for k in want)


@pytest.mark.parametrize("size", SIZES)
def test_trainer_loss_and_grads_match_the_reference(size):
    params, images, labels = _case(size)
    loss, grads = SegTrainer(learning_rate=LR, num_classes=CLASSES, features=FEATURES,
                             params=params).loss_and_grads(images, labels)
    want_loss, want_grads = R.loss_and_grads(state_dict_from_params(params),
                                             *_nchw(images, labels))
    assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert _grad_gap(state_dict_from_params(grads), want_grads) <= GRAD_RTOL


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("size", SIZES)
def test_trainer_steps_match_the_reference_adam(size, steps):
    """Each step's loss, and the parameters after the steps, against the
    float64 chain of reference steps from the same start."""
    params, images, labels = _case(size)
    trainer = SegTrainer(learning_rate=LR, num_classes=CLASSES, features=FEATURES,
                         params=params)
    p = {k: v.double() for k, v in state_dict_from_params(params).items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    for count in range(steps):
        loss = trainer.step(images, labels)
        want_loss, grads = R.loss_and_grads(p, *_nchw(images, labels))
        assert abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
        p, mu, nu = R.adam_step(p, grads, mu, nu, count, LR)
    assert _params_off(state_dict_from_params(trainer.host_params()), p) == 0


@pytest.mark.parametrize("size", SIZES)
def test_blocked_reference_equals_unblocked(size):
    params, images, labels = _case(size)
    flat = state_dict_from_params(params)
    loss, grads = R.loss_and_grads(flat, *_nchw(images, labels))
    for block in (1, 2):
        b_loss, b_grads = R.loss_and_grads(flat, *_nchw(images, labels), block=block)
        assert b_loss == pytest.approx(loss, rel=1e-13, abs=0)
        assert _grad_gap(b_grads, grads) <= 1e-12


@pytest.mark.parametrize("size", SIZES)
def test_bfloat16_reference_fails_the_tolerances(size):
    """The reference a precision step below float32 misses the loss, every
    gradient tolerance and the parameters after a step."""
    params, images, labels = _case(size)
    flat = state_dict_from_params(params)
    want_loss, want_grads = R.loss_and_grads(flat, *_nchw(images, labels))
    loss, grads = R.loss_and_grads(flat, *_nchw(images, labels), dtype=torch.bfloat16)
    assert not abs(loss - want_loss) <= LOSS_RTOL * abs(want_loss)
    assert not _grad_gap(grads, want_grads) <= GRAD_RTOL
    zeros = {k: torch.zeros_like(v) for k, v in want_grads.items()}
    want, _, _ = R.adam_step(flat, want_grads, zeros, zeros, 0, LR)
    got, _, _ = R.adam_step(flat, grads, zeros, zeros, 0, LR)
    assert _params_off(got, want) > 0


def test_place_batch_is_the_float32_nchw_batch():
    """The batch crosses as float32 NCHW, the values of the NHWC arrays;
    on the CPU nothing counts as crossed."""
    from dosma_tpu_torch.utils.profiling import counters

    params, images, labels = _case(48)
    trainer = SegTrainer(num_classes=CLASSES, features=FEATURES, params=params)
    before = counters["h2d.bytes"]
    x, y = trainer._step.place_batch(images, labels)
    assert counters["h2d.bytes"] == before
    assert x.dtype == y.dtype == torch.float32
    assert x.shape == (3, 1, 48, 48) and y.shape == (3, CLASSES, 48, 48)
    torch.testing.assert_close(x, torch.as_tensor(images).permute(0, 3, 1, 2), rtol=0, atol=0)
    torch.testing.assert_close(y, torch.as_tensor(labels, dtype=torch.float32)
                               .permute(0, 3, 1, 2), rtol=0, atol=0)
