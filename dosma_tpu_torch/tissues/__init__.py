"""Knee tissues and their regional analytics (counterpart of ``dosma_tpu/tissues``)."""

from dosma_tpu_torch.tissues.femoral_cartilage import FemoralCartilage  # noqa: F401
from dosma_tpu_torch.tissues.meniscus import Meniscus  # noqa: F401
from dosma_tpu_torch.tissues.patellar_cartilage import PatellarCartilage  # noqa: F401
from dosma_tpu_torch.tissues.tibial_cartilage import TibialCartilage  # noqa: F401
from dosma_tpu_torch.tissues.tissue import Tissue, largest_cc  # noqa: F401
