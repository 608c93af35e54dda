"""Plain U-Net of DOSMA's 2D segmentation models (``oaiunet2d.py``,
``stanford_qdess.py``: Keras ``unet_2d_model``), the reference of the
``segment`` request kind.

Plain ``torch`` on the parameters' Keras layouts: a nested dict
``{"down": [...], "up": [...], "final": {...}}`` with convolution kernels
HWIO and transpose kernels ``(kh, kw, out, in)``, numpy or tensor leaves.
Per depth ``d`` a block of two 3x3 SAME convolutions, each with ReLU, then
the inference BatchNorm ``(x - mean) * rsqrt(var + 1e-3) * gamma + beta``;
max pooling by 2 where the height is even and by 3 where it is odd (VALID);
a decoder of 3x3 transpose convolutions at the skip's stride, the concat
``[up, skip]`` and a block; a 1x1 sigmoid head, thresholded ``> 0.5``. A
volume ``(H, W, S)`` is whitened over all its voxels, ``(x - mean) / (std
+ eps)`` with the population std, and its slices ``vol[:, :, s]`` go
through the network in order; the masks come out ``(S, H, W, C)``, class
``c`` the head's channel ``c`` ({fc, tc, pc, men} for the IWOAI models).

Departures from the Keras model:

- float64 by default (Keras runs float32), with TF32 off for every matrix
  product and convolution; a lower ``dtype`` (and ``tf32=True``) gives the
  controls that the check's limit has to fail;
- inference only: BatchNorm from its stored statistics, no dropout (the
  Keras model has none at inference);
- the transpose convolution is written as zeros inserted between the
  inputs (stride ``s``), a pad of ``k - 1`` on each side and a convolution
  with the spatially flipped kernel, cropped to ``H * s`` from ``(k - s) //
  2`` as TF's ``padding="same"`` crops it; pooling is a reshape and a max;
- the whitening statistics are computed in ``dtype`` over the whole volume
  at once (Keras' caller does it in numpy).

Imports nothing of the program under test.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["BN_EPS", "prepare", "logits", "forward", "whiten", "segment", "precision"]

BN_EPS = 1e-3


@contextlib.contextmanager
def precision(tf32: bool = False):
    """TF32 allowed or not in matrix products and cuDNN convolutions inside
    the scope; the process-wide flags are restored on exit."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    prev = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = prev


def prepare(params: Dict, device, dtype=torch.float64) -> Dict:
    """The parameter dict with every leaf a ``dtype`` tensor on ``device``
    (layouts unchanged)."""
    if isinstance(params, dict):
        return {k: prepare(v, device, dtype) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [prepare(v, device, dtype) for v in params]
    leaf = params if isinstance(params, torch.Tensor) else torch.from_numpy(np.array(params))
    return leaf.detach().to(device=device, dtype=dtype)


def _conv_same(x, conv):
    """Keras ``Conv2D(k, padding="same")``, stride 1, odd k: a pad of
    ``k // 2`` on each side; HWIO kernel."""
    w = conv["w"]
    p = w.shape[0] // 2
    return F.conv2d(F.pad(x, (p, p, p, p)), w.permute(3, 2, 0, 1)) + conv["b"][:, None, None]


def _conv_transpose_same(x, conv, stride: int):
    """Keras ``Conv2DTranspose(k, strides=stride, padding="same")`` with the
    kernel ``(kh, kw, out, in)``: zeros inserted, padded, a convolution with
    the flipped kernel, cropped to ``H * stride``."""
    w = conv["w"]
    k = w.shape[0]
    b, c, h, wd = x.shape
    z = x.new_zeros((b, c, (h - 1) * stride + 1, (wd - 1) * stride + 1))
    z[:, :, ::stride, ::stride] = x
    z = F.pad(z, (k - 1, k - 1, k - 1, k - 1))
    full = F.conv2d(z, w.permute(2, 3, 0, 1).flip((2, 3)))  # (out, in, kh, kw), flipped
    pb = (k - stride) // 2
    return full[:, :, pb : pb + h * stride, pb : pb + wd * stride] + conv["b"][:, None, None]


def _max_pool(x, s: int):
    """``MaxPooling2D(pool_size=s, strides=s)``, VALID."""
    b, c, h, w = x.shape
    x = x[:, :, : h // s * s, : w // s * s]
    return x.reshape(b, c, h // s, s, w // s, s).amax(dim=(3, 5))


def _block(x, blk):
    x = torch.relu(_conv_same(x, blk["conv1"]))
    x = torch.relu(_conv_same(x, blk["conv2"]))
    bn = blk["bn"]
    scale = torch.rsqrt(bn["var"] + BN_EPS) * bn["gamma"]
    return (x - bn["mean"][:, None, None]) * scale[:, None, None] + bn["beta"][:, None, None]


def _stride(h: int) -> int:
    return 2 if h % 2 == 0 else 3


def logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The head's outputs before the sigmoid, ``(B, C, H, W)``, of ``x``
    ``(B, in, H, W)``; ``params`` as :func:`prepare` gives them, in ``x``'s
    dtype."""
    depth = len(params["down"])
    skips, h = [], x
    for d, blk in enumerate(params["down"]):
        h = _block(h, blk)
        skips.append(h)
        if d < depth - 1:
            h = _max_pool(h, _stride(h.shape[2]))
    for d in range(depth - 2, -1, -1):
        blk, skip = params["up"][d], skips[d]
        up = _conv_transpose_same(h, blk["convT"], _stride(skip.shape[2]))
        if up.shape[2:] != skip.shape[2:]:
            raise ValueError(f"size {tuple(up.shape[2:])} against the skip's "
                             f"{tuple(skip.shape[2:])} at depth {d}")
        h = _block(torch.cat([up, skip], dim=1), blk)
    return _conv_same(h, params["final"])


def forward(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Sigmoid probabilities ``(B, C, H, W)`` of ``x`` (as :func:`logits`)."""
    return torch.sigmoid(logits(params, x))


def whiten(vol: torch.Tensor, eps: Optional[float], dtype=torch.float64) -> torch.Tensor:
    """``vol`` in ``dtype``, whitened over all its voxels (population std
    plus ``eps``); ``eps`` None: not whitened."""
    x = vol.to(dtype)
    if eps is None:
        return x
    return (x - x.mean()) / (x.std(correction=0) + eps)


def segment(params: Dict, vol: torch.Tensor, eps: Optional[float], *, threshold: float = 0.5,
            batch_size: int = 16, dtype=torch.float64, tf32: bool = False,
            probabilities: bool = False):
    """Masks ``(S, H, W, C)`` uint8 of the volume ``vol`` ``(H, W, S)`` on its
    device, the slices in batches of ``batch_size``; with ``probabilities``
    also the sigmoid outputs ``(S, H, W, C)`` in ``dtype``. The whitening
    statistics are of the whole volume."""
    p = prepare(params, vol.device, dtype)
    masks, probs = [], []
    with torch.no_grad(), precision(tf32):
        x = whiten(vol, eps, dtype).permute(2, 0, 1)[:, None]  # (S, 1, H, W)
        for s in range(0, x.shape[0], batch_size):
            pr = forward(p, x[s : s + batch_size]).permute(0, 2, 3, 1)
            masks.append((pr > threshold).to(torch.uint8))
            if probabilities:
                probs.append(pr)
    masks = torch.cat(masks)
    return (masks, torch.cat(probs)) if probabilities else masks
