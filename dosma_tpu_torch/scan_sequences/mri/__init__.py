"""MRI scan sequences (counterpart of ``dosma_tpu/scan_sequences/mri``)."""

from dosma_tpu_torch.scan_sequences.mri.cones import Cones  # noqa: F401
from dosma_tpu_torch.scan_sequences.mri.cube_quant import CubeQuant  # noqa: F401
from dosma_tpu_torch.scan_sequences.mri.mapss import Mapss  # noqa: F401
from dosma_tpu_torch.scan_sequences.mri.qdess import QDess  # noqa: F401

__all__ = ["QDess", "CubeQuant", "Mapss", "Cones"]
