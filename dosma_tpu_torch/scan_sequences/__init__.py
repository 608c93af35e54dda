"""Scan sequences (counterpart of ``dosma_tpu/scan_sequences``): both
``from dosma_tpu_torch.scan_sequences import QDess`` and the ``mri`` and
``scans`` submodule paths work."""

from dosma_tpu_torch.scan_sequences import mri  # noqa: F401
from dosma_tpu_torch.scan_sequences import scans  # noqa: F401
from dosma_tpu_torch.scan_sequences.mri import Cones, CubeQuant, Mapss, QDess  # noqa: F401
from dosma_tpu_torch.scan_sequences.scans import NonTargetSequence, ScanSequence  # noqa: F401

__all__ = ["QDess", "CubeQuant", "Mapss", "Cones", "ScanSequence", "NonTargetSequence"]
