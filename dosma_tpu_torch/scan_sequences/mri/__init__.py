"""MRI scan sequences (counterpart of ``dosma_tpu/scan_sequences/mri``)."""

from dosma_tpu_torch.scan_sequences.mri.qdess import QDess  # noqa: F401

__all__ = ["QDess"]

# Scans of ``dosma_tpu`` that the port does not have yet: each needs
# registration to a target scan (``NonTargetSequence``).
_NOT_PORTED = {"CubeQuant", "Mapss", "Cones", "NonTargetSequence"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"{name} is not ported yet: ROADMAP queue 1, item 7 (the registered scans, "
            "NonTargetSequence and mri/_common.py)"
        )
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
