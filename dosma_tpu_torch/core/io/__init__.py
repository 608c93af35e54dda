"""I/O package surface (counterpart of ``dosma_tpu/core/io/__init__.py``):
the readers and writers, the format enum and the format-dispatch helpers
are importable from ``dosma_tpu_torch.core.io`` directly."""

from dosma_tpu_torch.core.io import dicom_io, format_io_utils, nifti_io  # noqa: F401
from dosma_tpu_torch.core.io.dicom_io import *  # noqa: F401,F403
from dosma_tpu_torch.core.io.format_io import ImageDataFormat  # noqa: F401
from dosma_tpu_torch.core.io.format_io_utils import *  # noqa: F401,F403
from dosma_tpu_torch.core.io.nifti_io import *  # noqa: F401,F403

__all__ = []
__all__.extend(dicom_io.__all__)
__all__.extend(["ImageDataFormat"])
__all__.extend(format_io_utils.__all__)
__all__.extend(nifti_io.__all__)
