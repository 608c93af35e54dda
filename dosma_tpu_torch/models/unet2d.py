"""2D U-Net in PyTorch (counterpart of ``dosma_tpu/models/unet2d.py``).

The graph of the reference's Keras model, layer for layer, so that its
weights give the same masks:

- 6 depths with ``32 * 2^d`` features;
- per block two 3x3 SAME convolutions, each followed by ReLU, then the
  inference BatchNorm ``(x - mean) * rsqrt(var + 1e-3) * gamma + beta``;
- pooling with stride 2 when the height is even and 3 when it is odd, the
  same stride on both axes (Keras ``MaxPooling2D``, VALID);
- a decoder of 3x3 transpose convolutions with the skip's stride, a concat
  ``[up, skip]`` and a block;
- a 1x1 sigmoid head with ``num_classes`` channels.

Parameters are exchanged as the JAX package's nested dict in Keras layouts
(``{"down": [...], "up": [...], "final": {...}}``, convolution kernels
HWIO, transpose kernels ``(kh, kw, out, in)``); :class:`UNet2D` holds them
in PyTorch's layouts. On the card, ``float32`` inference runs in full
float32 and every forward with deterministic cuDNN algorithms, whatever
the process-wide flags say (:func:`cudnn_exact`).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dosma_tpu_torch.core.device import as_tensor, compute_device

__all__ = [
    "DEPTH",
    "FEATURES",
    "UNet2D",
    "Unet2D",
    "conv_transpose_same",
    "init_unet2d_params",
    "unet2d_segment_volume",
]

DEPTH = 6
FEATURES = [32 * 2**d for d in range(DEPTH)]
BN_EPS = 1e-3

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@contextlib.contextmanager
def cudnn_exact():
    """Inside the scope cuDNN runs float32 convolutions in full float32 (no
    TF32) and picks deterministic algorithms (the transpose convolution's
    default ones accumulate in a varying order), so a volume gives the same
    masks on every call; the process-wide flags are restored on exit."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev


def conv_transpose_same(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int):
    """TF/Keras ``Conv2DTranspose(k, strides=s, padding="same")``, NCHW.

    ``w`` is in PyTorch's layout ``(in, out, kh, kw)``: the Keras kernel
    ``(kh, kw, out, in)`` permuted, not flipped. The full transpose
    convolution is cropped to ``H * s`` from ``pb = (k - s) // 2``.
    """
    k = w.shape[-1]
    out = F.conv_transpose2d(x, w, stride=stride)
    pb = (k - stride) // 2
    h, wd = x.shape[2] * stride, x.shape[3] * stride
    return out[:, :, pb : pb + h, pb : pb + wd] + b[:, None, None]


class _BatchNorm(nn.Module):
    """Inference BatchNorm with stored statistics (Keras eps 1e-3)."""

    def __init__(self, f: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(f), requires_grad=False)
        self.beta = nn.Parameter(torch.zeros(f), requires_grad=False)
        self.register_buffer("mean", torch.zeros(f))
        self.register_buffer("var", torch.ones(f))

    def forward(self, x):
        inv = torch.rsqrt(self.var + BN_EPS)
        return (x - self.mean[:, None, None]) * inv[:, None, None] * self.gamma[:, None, None] \
            + self.beta[:, None, None]


class _Block(nn.Module):
    """Two 3x3 SAME convolutions with ReLU, then BatchNorm."""

    def __init__(self, cin: int, f: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, f, 3, padding=1)
        self.conv2 = nn.Conv2d(f, f, 3, padding=1)
        self.bn = _BatchNorm(f)

    def forward(self, x):
        x = F.relu(self.conv1(x))
        x = F.relu(self.conv2(x))
        return self.bn(x)


class _UpBlock(_Block):
    """A transpose convolution (stride chosen at run time), then a block on
    ``[up, skip]``."""

    def __init__(self, f_in: int, f: int):
        super().__init__(2 * f, f)
        self.convT = nn.ConvTranspose2d(f_in, f, 3)


class UNet2D(nn.Module):
    """The reference U-Net. Input ``(B, in_channels, H, W)``; output the
    sigmoid probabilities ``(B, num_classes, H, W)``.

    ``features`` gives each depth's width (default :data:`FEATURES`); the
    depth is its length.
    """

    def __init__(self, in_channels: int = 1, num_classes: int = 1,
                 features: Optional[Sequence[int]] = None):
        super().__init__()
        features = list(FEATURES if features is None else features)
        self.features = features
        cin = in_channels
        self.down = nn.ModuleList()
        for f in features:
            self.down.append(_Block(cin, f))
            cin = f
        self.up = nn.ModuleList(
            _UpBlock(features[d + 1], features[d]) for d in range(len(features) - 1)
        )
        self.final = nn.Conv2d(features[0], num_classes, 1)
        self.requires_grad_(False)

    @classmethod
    def from_params(cls, params: Dict) -> "UNet2D":
        """The network of a parameter dict (the JAX package's layout); its
        depth and widths are read from the parameters."""
        from dosma_tpu_torch.models.weights import state_dict_from_params

        down = params["down"]
        features = [int(np.shape(blk["conv1"]["w"])[-1]) for blk in down]
        in_channels = int(np.shape(down[0]["conv1"]["w"])[2])
        num_classes = int(np.shape(params["final"]["w"])[-1])
        net = cls(in_channels, num_classes, features)
        net.load_state_dict(state_dict_from_params(params))
        return net

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        depth = len(self.down)
        skips = []
        h = x
        for d, blk in enumerate(self.down):
            h = blk(h)
            skips.append(h)
            if d < depth - 1:
                size = 2 if h.shape[2] % 2 == 0 else 3
                h = F.max_pool2d(h, size, stride=size)
        for d in range(depth - 2, -1, -1):
            blk = self.up[d]
            target = skips[d]
            stride = 2 if target.shape[2] % 2 == 0 else 3
            up = conv_transpose_same(h, blk.convT.weight, blk.convT.bias, stride)
            if up.shape[2:] != target.shape[2:]:
                raise ValueError(
                    f"U-Net size mismatch at depth {d}: upsampled {tuple(up.shape[2:])} vs skip "
                    f"{tuple(target.shape[2:])}. Input spatial dims must survive the reference's "
                    f"even/odd pooling schedule (e.g. 256, 384, 288)."
                )
            h = blk(torch.cat([up, target], dim=1))
        return torch.sigmoid(self.final(h))


def init_unet2d_params(generator: torch.Generator, in_channels: int = 1, num_classes: int = 1,
                       features=None) -> Dict:
    """He-normal parameters drawn from ``generator``, in the JAX package's
    nested layout (float32 CPU tensors; Keras kernel layouts).

    The draws cannot equal ``jax.random``'s; a JAX dict is carried across
    with ``Unet2D.params = ...`` instead.
    """
    features = list(FEATURES if features is None else features)
    depth = len(features)

    def he_conv(kh, kw, cin, cout):
        w = torch.randn((kh, kw, cin, cout), generator=generator, dtype=torch.float32)
        return w * np.float32(np.sqrt(2.0 / (kh * kw * cin)))

    def bn(f):
        return {"gamma": torch.ones(f), "beta": torch.zeros(f),
                "mean": torch.zeros(f), "var": torch.ones(f)}

    params = {"down": [], "up": [None] * (depth - 1), "final": None}
    cin = in_channels
    for f in features:
        params["down"].append({
            "conv1": {"w": he_conv(3, 3, cin, f), "b": torch.zeros(f)},
            "conv2": {"w": he_conv(3, 3, f, f), "b": torch.zeros(f)},
            "bn": bn(f),
        })
        cin = f
    for d in range(depth - 2, -1, -1):
        f, f_in = features[d], features[d + 1]
        params["up"][d] = {
            # Keras transpose kernel layout: (kh, kw, out, in).
            "convT": {"w": he_conv(3, 3, f_in, f).permute(0, 1, 3, 2).contiguous(),
                      "b": torch.zeros(f)},
            "conv1": {"w": he_conv(3, 3, 2 * f, f), "b": torch.zeros(f)},
            "conv2": {"w": he_conv(3, 3, f, f), "b": torch.zeros(f)},
            "bn": bn(f),
        }
    params["final"] = {"w": he_conv(1, 1, features[0], num_classes),
                       "b": torch.zeros(num_classes)}
    return params


def _bits_per_px(num_classes: int) -> int:
    """Bits a pixel's class mask takes in the packed output (1, 2, 4 or 8)."""
    c = num_classes
    return 1 if c == 1 else (2 if c == 2 else (4 if c <= 4 else 8))


def _forward_masks(net: UNet2D, x: torch.Tensor, mean, std, threshold: float,
                   dtype: torch.dtype, bits_per_px: Optional[int]) -> torch.Tensor:
    """One batch ``(B, 1, H, W)`` in any dtype: whiten by ``(x - mean) /
    std`` (0-d float32 tensors on its device, or None for no whitening),
    forward, threshold.

    Returns the class bits packed into bytes, ``bits_per_px`` bits a pixel
    (``(B, H, W * bits_per_px // 8)`` uint8; bit ``c`` of a pixel's lane is
    class ``c``), or the per-class mask ``(B, H, W, C)`` when
    ``bits_per_px`` is None.
    """
    x = x.to(torch.float32)
    if mean is not None:
        x = (x - mean) / std
    probs = net(x.to(dtype))
    m = (probs > threshold).to(torch.uint8)  # (B, C, H, W)
    if bits_per_px is None:
        return m.permute(0, 2, 3, 1)
    c = m.shape[1]
    weights = (1 << torch.arange(c, device=m.device, dtype=torch.int32))[:, None, None]
    packed = (m.to(torch.int32) * weights).sum(dim=1)  # (B, H, W)
    ppb = 8 // bits_per_px
    if ppb > 1:
        b, h, w = packed.shape
        shifts = torch.arange(ppb, device=m.device, dtype=torch.int32) * bits_per_px
        packed = (packed.reshape(b, h, w // ppb, ppb) << shifts).sum(dim=-1)
    return packed.to(torch.uint8)


def _unpack(packed: np.ndarray, width: int, num_classes: int, bits_per_px: int) -> np.ndarray:
    """Host unpack of :func:`_forward_masks`'s bytes to ``(N, H, W, C)`` uint8."""
    n, h = packed.shape[:2]
    out = np.unpackbits(packed[..., None], axis=-1, bitorder="little")
    return out.reshape(n, h, width, bits_per_px)[..., :num_classes]


def _run_batches(net, slices: torch.Tensor, mean, std, threshold, dtype, bits_per_px,
                 batch_size: int) -> np.ndarray:
    """Masks of ``slices`` ``(N, 1, H, W)``, batch by batch on their device;
    the packed outputs are gathered there and cross to the host in one copy."""
    outs = [
        _forward_masks(net, slices[s : s + batch_size], mean, std, threshold, dtype, bits_per_px)
        for s in range(0, slices.shape[0], batch_size)
    ]
    return (outs[0] if len(outs) == 1 else torch.cat(outs)).cpu().numpy()


def unet2d_segment_volume(net: UNet2D, vol: torch.Tensor, threshold: float, *,
                          batch_size: int, bits_per_px: int, whiten: bool, whiten_eps: float,
                          dtype: torch.dtype = torch.float32) -> np.ndarray:
    """The volume-segmentation path on ``vol``'s device.

    ``vol``: ``(H, W, S)`` tensor in its source dtype. Casts to float32,
    whitens with the whole volume's mean and population std (optional),
    takes the slices in batches of ``batch_size`` through forward,
    threshold and bit packing, and returns the packed bytes
    ``(S, H, W * bits_per_px // 8)`` on the host: one device-to-host copy.
    """
    x = vol.to(torch.float32)
    mean = std = None
    if whiten:
        mean = x.mean()
        std = x.std(correction=0) + whiten_eps
    slices = x.permute(2, 0, 1).contiguous()[:, None]  # (S, 1, H, W)
    return _run_batches(net, slices, mean, std, threshold, dtype, bits_per_px, batch_size)


class Unet2D:
    """U-Net parameters and inference, with the Keras model's surface.

    ``params`` (the JAX package's nested dict) are drawn lazily from seed 0
    unless set or loaded. Inference runs on the input's device (a host
    array: the default device) at ``precision``: ``"float32"`` (full
    float32) or ``"bfloat16"`` (parameters and input cast; probabilities
    returned as float32).
    """

    def __init__(self, input_shape: Tuple[int, int, int], num_classes: int = 1,
                 precision: str = "float32"):
        if not isinstance(input_shape, tuple) or len(input_shape) != 3 or input_shape[2] != 1:
            raise ValueError("input_size must be a tuple of size (height, width, 1)")
        if precision not in _DTYPES:
            raise ValueError("precision must be 'float32' or 'bfloat16'")
        self.input_shape = input_shape
        self.num_classes = num_classes
        self.precision = precision
        self._params = None
        self._nets = {}  # (device, dtype) -> UNet2D, built once per weight load

    @property
    def params(self) -> Dict:
        if self._params is None:
            self._params = init_unet2d_params(
                torch.Generator().manual_seed(0), in_channels=self.input_shape[2],
                num_classes=self.num_classes,
            )
        return self._params

    @params.setter
    def params(self, value: Dict):
        """A nested dict in the JAX package's layout, with numpy, JAX or
        torch leaves."""
        self._params = value
        self._nets = {}

    def load_weights(self, weights_path: str):
        """Keras ``.h5`` weights (needs h5py) or the port's ``.pt`` state dict."""
        from dosma_tpu_torch.models.weights import load_unet2d_weights

        self.params = load_unet2d_weights(weights_path)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.precision]

    def network(self, device) -> UNet2D:
        """The network on ``device`` at the model's precision (cast once per
        weight load)."""
        key = (torch.device(device), self.dtype)
        if key not in self._nets:
            net = UNet2D.from_params(self.params)
            self._nets[key] = net.to(device=key[0], dtype=key[1]).eval()
        return self._nets[key]

    def fits_packed_volume(self, width: int) -> bool:
        """Whether :meth:`predict_mask_volume` takes a volume this wide:
        C <= 8 and W divisible by the pixels a packed byte holds."""
        bits = _bits_per_px(self.num_classes)
        return self.num_classes <= 8 and width % (8 // bits) == 0

    def predict(self, v, batch_size: int = 16, verbose: int = 0) -> np.ndarray:
        """Probabilities ``(N, H, W, C)`` float32 on the host for ``v``
        ``(N, H, W, 1)``, in batches over the leading axis."""
        x = as_tensor(v, compute_device(v)).permute(0, 3, 1, 2)
        net = self.network(x.device)
        outs = []
        with torch.inference_mode(), cudnn_exact():
            for s in range(0, x.shape[0], batch_size):
                probs = net(x[s : s + batch_size].to(self.dtype))
                outs.append(probs.to(torch.float32).permute(0, 2, 3, 1))
            return torch.cat(outs).cpu().numpy()

    def predict_mask_volume(self, vol, batch_size: int = 16, threshold: float = 0.5,
                            whiten: bool = False, whiten_eps: float = 0.0) -> np.ndarray:
        """Segment an ``(H, W, S)`` volume (a tensor, or a host array taken
        to the default device) in batches on its device.

        Returns the ``(S, H, W, C)`` uint8 mask on the host; the packed
        mask is the only device-to-host copy. Requires
        :meth:`fits_packed_volume` of the width, else ``ValueError``.
        """
        if not self.fits_packed_volume(vol.shape[1]):
            raise ValueError("predict_mask_volume constraints not met")
        vol = as_tensor(vol, compute_device(vol))
        bits = _bits_per_px(self.num_classes)
        with torch.inference_mode(), cudnn_exact():
            packed = unet2d_segment_volume(
                self.network(vol.device), vol, float(threshold), batch_size=int(batch_size),
                bits_per_px=bits, whiten=bool(whiten), whiten_eps=float(whiten_eps),
                dtype=self.dtype,
            )
        return _unpack(packed, vol.shape[1], self.num_classes, bits)

    def predict_mask(self, v, batch_size: int = 16, threshold: float = 0.5, mean=0.0,
                     std=1.0) -> np.ndarray:
        """Thresholded uint8 masks ``(N, H, W, C)`` on the host for ``v``
        ``(N, H, W, 1)`` in its source dtype, whitened by ``(v - mean) /
        std`` on its device (``mean`` and ``std`` may be 0-d tensors there).

        C <= 8 classes cross packed into bytes (below a byte a pixel when
        the width allows it) in one copy; wider heads return the per-class
        mask.
        """
        x = as_tensor(v, compute_device(v)).permute(0, 3, 1, 2)
        c = self.num_classes
        if c > 8:
            bits = None
        else:
            bits = _bits_per_px(c) if self.fits_packed_volume(x.shape[3]) else 8
        mean, std = (torch.as_tensor(a, dtype=torch.float32, device=x.device)
                     for a in (mean, std))
        with torch.inference_mode(), cudnn_exact():
            out = _run_batches(self.network(x.device), x, mean, std, float(threshold),
                               self.dtype, bits, int(batch_size))
        return out if bits is None else _unpack(out, x.shape[3], c, bits)
