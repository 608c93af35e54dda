"""SKM-TEA / Stanford qDESS U-Net (counterpart of
``dosma_tpu/models/stanford_qdess.py``).

The head order is {pc, fc, tc, men}, unlike the IWOAI model's
{fc, tc, pc, men}. Takes 3D RSS input or 4D two-echo input, whose RSS is
computed on the volume's device.
"""

from __future__ import annotations

import numpy as np

from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.core.orientation import SAGITTAL
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.models.oaiunet2d import _category_volumes, _staged
from dosma_tpu_torch.models.seg_model import TorchSegModel, whiten_stats, whiten_volume
from dosma_tpu_torch.models.unet2d import Unet2D
from dosma_tpu_torch.utils.profiling import annotate

__all__ = ["StanfordQDessUNet2D"]


class StanfordQDessUNet2D(TorchSegModel):
    """2D U-Net for SKM-TEA qDESS knee segmentation (pc/fc/tc/men head)."""

    ALIASES = ("stanford-qdess-2021-unet2d", "skm-tea-unet2d")
    sigmoid_threshold = 0.5
    CATEGORIES = ["pc", "fc", "tc", "men"]

    def __load_model__(self, input_shape):
        return Unet2D(input_shape, num_classes=4, precision=preferences.segmentation_precision)

    def generate_mask(self, volume: MedicalVolume):
        """Segment from 3D RSS or 4D two-echo input."""
        ndim = volume.ndim
        if ndim not in (3, 4):
            raise ValueError("`volume` must either be 3D or 4D")

        with annotate("dosma.segment"):
            with annotate("dosma.segment.stage"):
                vol_copy = _staged(volume)
                if ndim == 4:
                    # Squared as a float (** 2.0): integer echoes would overflow.
                    vol_copy = np.sqrt(np.sum(vol_copy ** 2.0, axis=-1))
                vol_copy = vol_copy.reformat(SAGITTAL)

            mask = self._predict_slices(vol_copy)  # (S, H, W, 4)
            with annotate("dosma.segment.masks"):
                return _category_volumes(vol_copy, mask, self.CATEGORIES, volume.orientation)

    def __preprocess_volume__(self, volume: np.ndarray):
        return whiten_volume(volume, eps=1e-8)

    def __whiten_stats__(self, volume):
        return whiten_stats(volume, eps=1e-8)

    def __whiten_eps__(self):
        return 1e-8
