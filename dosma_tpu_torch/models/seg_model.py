"""Segmentation model base classes (counterpart of
``dosma_tpu/models/seg_model.py``).

Models are PyTorch U-Nets whose parameters load from the reference's Keras
``.h5`` weight files or from the port's ``.pt`` state dicts (see
:mod:`dosma_tpu_torch.models.weights`), and run batched on the volume's
device.
"""

from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch

from dosma_tpu_torch.core.device import as_tensor, compute_device
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.utils.profiling import annotate

__all__ = ["SegModel", "TorchSegModel", "KerasSegModel", "whiten_volume", "whiten_stats"]

__VOLUME_DIMENSIONS__ = 3


class SegModel(ABC):
    """Abstract segmentation model.

    Args:
        input_shape: (height, width, channels) for model initialization.
        weights_path: path to ``.h5`` or ``.pt`` weights.
        force_weights: skip weight-filename validation.
    """

    ALIASES = [""]

    def __init__(self, input_shape, weights_path, force_weights=False):
        self.batch_size = preferences.segmentation_batch_size
        self.seg_model = self.build_model(input_shape, weights_path)

    @abstractmethod
    def build_model(self, input_shape, weights_path):
        pass  # pragma: no cover

    @abstractmethod
    def generate_mask(self, volume: MedicalVolume):
        pass  # pragma: no cover

    def __call__(self, *args, **kwargs):
        return self.generate_mask(*args, **kwargs)

    def __preprocess_volume__(self, volume: np.ndarray):
        return volume

    def __postprocess_volume__(self, volume: np.ndarray):
        return volume


class TorchSegModel(SegModel):
    """Base for PyTorch models with Keras-h5-convertible weights.

    Subclasses define ``__load_model__(input_shape)`` returning a
    :class:`~dosma_tpu_torch.models.unet2d.Unet2D`; ``build_model`` loads
    its weights.
    """

    def build_model(self, input_shape, weights_path=None):
        model = self.__load_model__(input_shape)
        if weights_path:
            model.load_weights(weights_path)
        return model

    @abstractmethod
    def __load_model__(self, input_shape):
        pass  # pragma: no cover

    def __whiten_eps__(self):
        """Whitening std-epsilon of the volume path; None = no whitening.
        Must agree with the subclass's ``__whiten_stats__``."""
        return None

    def _predict_slices(self, vol_copy: MedicalVolume) -> np.ndarray:
        """(S, H, W, C) uint8 masks on the host for a sagittal volume, on
        its device (a host volume: the default device).

        Widths that the reference's packed volume path takes
        (:meth:`Unet2D.fits_packed_volume`) go through
        :meth:`Unet2D.predict_mask_volume`; the others through
        :meth:`Unet2D.predict_mask`. Each crosses the masks in one copy.
        """
        vol = as_tensor(vol_copy.volume, compute_device(vol_copy.volume))
        model = self.seg_model
        if model.fits_packed_volume(vol.shape[1]):
            eps = self.__whiten_eps__()
            return model.predict_mask_volume(
                vol, batch_size=self.batch_size, threshold=self.sigmoid_threshold,
                whiten=eps is not None, whiten_eps=eps or 0.0,
            )
        with annotate("dosma.segment.stage"):
            stats = self.__whiten_stats__(vol)
            mean, std = stats if stats is not None else (0.0, 1.0)
        return model.predict_mask(
            vol.permute(2, 0, 1)[..., None], batch_size=self.batch_size,
            threshold=self.sigmoid_threshold, mean=mean, std=std,
        )


# The reference's class name.
KerasSegModel = TorchSegModel


def whiten_volume(x: np.ndarray, eps: float = 0.0) -> np.ndarray:
    """Zero-mean, unit-std normalization over all voxels."""
    if len(x.shape) != __VOLUME_DIMENSIONS__:
        raise ValueError(f"Input has {x.ndim} dimensions. Expected {__VOLUME_DIMENSIONS__}")
    return (x - np.mean(x)) / (np.std(x) + eps)


def whiten_stats(x, eps: float = 0.0):
    """(mean, std + eps) of the whole volume, std the population std: the
    scalars the inference path whitens with on the device.

    A tensor gives 0-d float32 tensors on its device (no host
    synchronization); a host array gives Python floats.
    """
    if len(x.shape) != __VOLUME_DIMENSIONS__:
        raise ValueError(f"Input has {x.ndim} dimensions. Expected {__VOLUME_DIMENSIONS__}")
    if isinstance(x, torch.Tensor):
        xf = x.to(torch.float32)
        return xf.mean(), xf.std(correction=0) + eps
    return float(np.mean(x)), float(np.std(x)) + eps
