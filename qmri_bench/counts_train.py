"""The work of one training step of the 2D U-Net, from shapes alone.

Operations: the forward's convolutions (``counts_unet.slice_flops``), the
weights' gradients (as many operations as the forward) and the inputs'
gradients (as many again, less the first convolution's: nothing needs the
image's gradient), on every slice of the batch. They run in float32
outside the tensor cores (the program keeps TF32 off), so
``counts.least_seconds`` holds them to ``counts.PEAK_F32_PER_S``; the loss,
BatchNorm, ReLU, pooling and Adam's elementwise work are not counted.
Bytes: the batch as it crosses to the card (float32 images and labels),
then the float32 parameters, their gradients and Adam's two moments, each
read or written once.
"""

from __future__ import annotations

from qmri_bench.counts_unet import parameter_count, slice_flops

__all__ = ["first_conv_input_grad_flops", "train_slice_flops", "train_step_work"]


def first_conv_input_grad_flops(h: int, w: int, features, in_channels: int = 1) -> int:
    """Operations of the first convolution's input gradient, which the
    backward skips."""
    return 2 * 9 * in_channels * features[0] * h * w


def train_slice_flops(h: int, w: int, features, num_classes: int, in_channels: int = 1) -> int:
    """Float32 operations of the forward and backward on one slice."""
    fwd = slice_flops(h, w, features, num_classes, in_channels)
    return 3 * fwd - first_conv_input_grad_flops(h, w, features, in_channels)


def train_step_work(batch: int, h: int, w: int, features, num_classes: int,
                    in_channels: int = 1):
    """(bytes, float32 operations) of one step on ``batch`` slices."""
    crossed = 4 * batch * h * w * (in_channels + num_classes)
    state = 4 * 4 * parameter_count(features, num_classes, in_channels)
    return crossed + state, batch * train_slice_flops(h, w, features, num_classes, in_channels)
