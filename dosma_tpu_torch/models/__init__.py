"""Segmentation models (counterpart of ``dosma_tpu/models``): the OAI and
IWOAI U-Nets, the SKM-TEA qDESS U-Net, their registry and weights."""

from dosma_tpu_torch.models.oaiunet2d import (  # noqa: F401
    IWOAIOAIUnet2D,
    IWOAIOAIUnet2DNormalized,
    OAIUnet2D,
)
from dosma_tpu_torch.models.seg_model import (  # noqa: F401
    KerasSegModel,
    SegModel,
    TorchSegModel,
    whiten_volume,
)
from dosma_tpu_torch.models.stanford_qdess import StanfordQDessUNet2D  # noqa: F401
from dosma_tpu_torch.models.util import SUPPORTED_MODELS, get_model, model_from_config  # noqa: F401
