"""Scan sequences (counterpart of ``dosma_tpu/scan_sequences``): both
``from dosma_tpu_torch.scan_sequences import QDess`` and the ``mri`` and
``scans`` submodule paths work."""

from dosma_tpu_torch.scan_sequences import mri  # noqa: F401
from dosma_tpu_torch.scan_sequences import scans  # noqa: F401
from dosma_tpu_torch.scan_sequences.scans import ScanSequence  # noqa: F401

__all__ = ["QDess", "ScanSequence"]

# The other scans are looked up in ``mri``, which names the ROADMAP item
# that brings each of them.
_LAZY = {"QDess", "CubeQuant", "Mapss", "Cones", "NonTargetSequence"}


def __getattr__(name):
    if name in _LAZY:
        return getattr(mri, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
