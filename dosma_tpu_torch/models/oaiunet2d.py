"""OAI U-Net segmentation models (counterpart of ``dosma_tpu/models/oaiunet2d.py``).

The reference's architectures and channel orders, so that its weights give
the same masks:

- :class:`OAIUnet2D`: a 1-channel sigmoid head;
- :class:`IWOAIOAIUnet2D`: a 4-channel head ordered {fc, tc, pc, men};
- :class:`IWOAIOAIUnet2DNormalized`: the same with whitening.

A host volume crosses to the default device once, in its own layout; the
sagittal reformat, the slice-major transpose, whitening and the batches run
there. Masks come back as host ``uint8`` volumes.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from dosma_tpu_torch.core.device import get_default_device
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.core.orientation import SAGITTAL
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.models.seg_model import TorchSegModel, whiten_stats, whiten_volume
from dosma_tpu_torch.models.unet2d import Unet2D

__all__ = ["OAIUnet2D", "IWOAIOAIUnet2D", "IWOAIOAIUnet2DNormalized"]


def _staged(mv: MedicalVolume) -> MedicalVolume:
    """``mv`` on the device the models compute on: a tensor-backed volume
    stays where it is; a host volume goes to the default device in one copy of its
    own layout (``core/device.py::as_tensor``: uint16 crosses as uint16 and
    is widened there)."""
    return mv if isinstance(mv.volume, torch.Tensor) else mv.to(get_default_device())


def _weights_file_ok(weights_path: str, expected: str) -> bool:
    """The expected ``.h5`` file name, or its stem with ``.pt``."""
    name = os.path.basename(weights_path)
    return name in (expected, os.path.splitext(expected)[0] + ".pt")


class OAIUnet2D(TorchSegModel):
    """2D U-Net from Chaudhari et al. IWOAI 2018 (single-class head)."""

    ALIASES = ["oai-unet2d", "oai_unet2d"]
    sigmoid_threshold = 0.5

    def __load_model__(self, input_shape):
        return Unet2D(input_shape, num_classes=1, precision=preferences.segmentation_precision)

    def generate_mask(self, volume: MedicalVolume):
        """Sagittal reformat → batched inference → threshold 0.5 → reformat
        back to the input's orientation."""
        vol_copy = _staged(volume).reformat(SAGITTAL)
        mask = self._predict_slices(vol_copy)  # (S, H, W, 1)

        vol_copy.volume = np.transpose(np.squeeze(mask, axis=-1), (1, 2, 0))
        vol_copy.reformat(volume.orientation, inplace=True)
        return vol_copy

    def __preprocess_volume__(self, volume: np.ndarray):
        return whiten_volume(volume, eps=1e-8)

    def __whiten_stats__(self, volume):
        """Whitening scalars matching ``__preprocess_volume__`` (None = no
        normalization), applied on the device."""
        return whiten_stats(volume, eps=1e-8)

    def __whiten_eps__(self):
        return 1e-8


class IWOAIOAIUnet2D(OAIUnet2D):
    """IWOAI 2019 Team 6 model: 4-class head {fc, tc, pc, men}."""

    ALIASES = ["iwoai-2019-t6"]
    _WEIGHTS_FILE = "iwoai-2019-unet2d_fc-tc-pc-men_weights.h5"
    CATEGORIES = ["fc", "tc", "pc", "men"]

    def __init__(self, input_shape, weights_path, force_weights=False):
        if not force_weights and not _weights_file_ok(weights_path, self._WEIGHTS_FILE):
            raise ValueError(f"Weights {weights_path} not supported for {type(self)}")
        super().__init__(input_shape, weights_path)

    def __load_model__(self, input_shape):
        return Unet2D(input_shape, num_classes=4, precision=preferences.segmentation_precision)

    def generate_mask(self, volume: MedicalVolume):
        vol_copy = _staged(volume).reformat(SAGITTAL)
        mask = self._predict_slices(vol_copy)  # (S, H, W, C)
        return _category_volumes(vol_copy, mask, self.CATEGORIES, volume.orientation)

    def __preprocess_volume__(self, volume: np.ndarray):
        return volume

    def __whiten_stats__(self, volume):
        return None  # IWOAI 2019 T6 runs on raw intensities

    def __whiten_eps__(self):
        return None


class IWOAIOAIUnet2DNormalized(IWOAIOAIUnet2D):
    """IWOAI 2019 Team 6 model with zero-mean/unit-std input normalization."""

    ALIASES = ("iwoai-2019-t6-normalized",)
    _WEIGHTS_FILE = "iwoai-2019-unet2d-normalized_fc-tc-pc-men_weights.h5"

    def __preprocess_volume__(self, volume: np.ndarray):
        return whiten_volume(volume)

    def __whiten_stats__(self, volume):
        return whiten_stats(volume, eps=0.0)

    def __whiten_eps__(self):
        return 0.0


def _category_volumes(vol_copy: MedicalVolume, mask: np.ndarray, categories, orientation):
    """{category: host uint8 volume in ``orientation``} from the (S, H, W, C)
    mask of the sagittal ``vol_copy``."""
    mask = np.transpose(mask, (1, 2, 0, 3))  # (H, W, S, C)
    vols = {}
    for i, category in enumerate(categories):
        vol_cp = vol_copy._partial_clone(volume=mask[..., i], headers=True)
        vol_cp.reformat(orientation, inplace=True)
        vols[category] = vol_cp
    return vols
