"""Pure-Python + C++-accelerated DICOM toolkit.

The reference uses pydicom (``dosma/core/io/dicom_io.py:1-40``);
pydicom is not available in this environment, so dosma_tpu ships its own
DICOM implementation: a tag dictionary, dataset model, Part-10 reader/writer
for Implicit/Explicit VR Little Endian, and an optional C++ fast-parse path.
"""

from dosma_tpu_torch.core.io.dicom.dataset import DataElement, Dataset, Tag  # noqa: F401
from dosma_tpu_torch.core.io.dicom.reader import read_dicom, read_dicom_bytes  # noqa: F401
from dosma_tpu_torch.core.io.dicom.writer import write_dicom  # noqa: F401
