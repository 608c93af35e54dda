"""The work of one segmentation request of the 2D U-Net, from shapes alone.

Operations: the multiply-adds x 2 of the network's convolutions on every
slice (a transpose convolution: 9 products per input pixel and pair of
channels; the 1x1 head included; BatchNorm, ReLU, pooling, whitening, the
threshold and the packing not counted); ``chip_smoke.py`` takes its count
from here. They run in float32 outside the tensor cores (the
program keeps TF32 off), so ``counts.least_seconds`` holds them to
``counts.PEAK_F32_PER_S``. Bytes: the volume read once as the card holds
it, the float32 parameters read once, and the packed masks (``mask_bits``
bits a voxel) written once.
"""

from __future__ import annotations

__all__ = ["slice_flops", "parameter_count", "mask_bits", "segment_work"]


def slice_flops(h: int, w: int, features, num_classes: int, in_channels: int = 1) -> int:
    """Float32 operations of the convolutions on one ``h`` x ``w`` slice."""
    flops, sizes, cin = 0, [], in_channels
    for d, f in enumerate(features):
        flops += 2 * 9 * (cin + f) * f * h * w  # conv1 (cin -> f) and conv2 (f -> f)
        sizes.append((h, w))
        cin = f
        if d < len(features) - 1:
            stride = 2 if h % 2 == 0 else 3
            h, w = h // stride, w // stride
    for d in range(len(features) - 2, -1, -1):
        f = features[d]
        flops += 2 * 9 * features[d + 1] * f * h * w  # transpose convolution, at its input
        h, w = sizes[d]
        flops += 2 * 9 * (2 * f + f) * f * h * w  # conv1 on [up, skip], conv2
    return flops + 2 * features[0] * num_classes * h * w


def parameter_count(features, num_classes: int, in_channels: int = 1) -> int:
    """Weights, biases and BatchNorm statistics of the network."""
    n, cin = 0, in_channels
    for f in features:
        n += 9 * cin * f + f + 9 * f * f + f + 4 * f
        cin = f
    for d in range(len(features) - 1):
        f = features[d]
        n += 9 * features[d + 1] * f + f + 9 * 2 * f * f + f + 9 * f * f + f + 4 * f
    return n + features[0] * num_classes + num_classes


def mask_bits(num_classes: int) -> int:
    """Bits a voxel's classes take in the packed copy (1, 2, 4 or 8)."""
    return 1 if num_classes == 1 else 2 if num_classes == 2 else 4 if num_classes <= 4 else 8


def segment_work(shape, features, num_classes: int, volume_bytes_per_voxel: int = 4):
    """(bytes, float32 operations) of segmenting a sagittal ``(H, W, S)``
    volume slice by slice."""
    h, w, s = (int(v) for v in shape)
    nbytes = (volume_bytes_per_voxel * h * w * s + 4 * parameter_count(features, num_classes)
              + h * w * s * mask_bits(num_classes) // 8)
    return nbytes, s * slice_flops(h, w, features, num_classes)
