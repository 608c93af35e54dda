"""dosma_tpu_torch: the PyTorch / CUDA port of dosma_tpu.

The same public names as ``dosma_tpu`` for the ported slices: DICOM and
NIfTI I/O (``read``/``write``/``load``/``save``, the readers and writers,
``load_to_device``), voxelwise monoexponential relaxometry, the
curve-fitting API (``CurveFitter``, ``PolyFitter``, ``curve_fit``,
``polyfit``), quantitative maps and their metrics (``quant_vals``), the
numpy routines on volumes, registration (``register``, ``apply_warp`` and
the ``ops.registration`` functions), the segmentation
models (``models``), the knee tissues and their regional analytics
(``Tissue``, ``FemoralCartilage``, ``TibialCartilage``,
``PatellarCartilage``, ``Meniscus``), the qDESS scan (``QDess``) and the
registered scans (``CubeQuant``, ``Mapss``, ``Cones``) with the B-spline
(FFD) registration stage, ``get_array_module`` and ``collect_env_info``.
The command line is ``python -m dosma_tpu_torch.cli`` and the GUI
``python -m dosma_tpu_torch.app``.
Importing it loads torch, numpy and scipy only: no jax, pandas, yaml or
matplotlib. Kernels and the host C++ libraries are compiled on first use.

Entry points compute host (numpy) data on the default device, the first
CUDA card, unless the caller asks for another:
``dosma_tpu_torch.set_default_device("cpu")`` or, for a scope,
``with dosma_tpu_torch.default_device("cpu"): ...``. Tensors are computed on
their own device.
"""

__version__ = "0.1.0"

from dosma_tpu_torch.core.device import (  # noqa: F401
    Device,
    cpu_device,
    default_device,
    get_array_module,
    get_default_device,
    get_device,
    set_default_device,
    to_device,
)
from dosma_tpu_torch.core.fitting import (  # noqa: F401
    CurveFitter,
    MonoExponentialFit,
    PolyFitter,
    biexponential,
    curve_fit,
    monoexponential,
    polyfit,
)
from dosma_tpu_torch.core.io.dicom_io import DicomReader, DicomWriter  # noqa: F401
from dosma_tpu_torch.core.io.format_io import ImageDataFormat  # noqa: F401
from dosma_tpu_torch.core.io.format_io_utils import (  # noqa: F401
    convert_image_data_format,
    generic_load,
    get_filepath_variations,
    get_reader,
    get_writer,
    load,
    read,
    save,
    write,
)
from dosma_tpu_torch.core.io.nifti_io import NiftiReader, NiftiWriter  # noqa: F401
from dosma_tpu_torch.core.io.prefetch import load_to_device  # noqa: F401
from dosma_tpu_torch.core.med_volume import MedicalVolume  # noqa: F401
from dosma_tpu_torch.core import numpy_routines, quant_vals  # noqa: F401
from dosma_tpu_torch.core.orientation import (  # noqa: F401
    AXIAL,
    CORONAL,
    SAGITTAL,
    get_flip_inds,
    get_transpose_inds,
    orientation_nib_to_standard,
    orientation_standard_to_nib,
    to_affine,
)
from dosma_tpu_torch.core.quant_vals import (  # noqa: F401
    QuantitativeValue,
    T1Rho,
    T2,
    T2Star,
    get_qv,
)
from dosma_tpu_torch.core.registration import (  # noqa: F401
    apply_warp,
    register,
    symlink_elastix,
    unlink_elastix,
)
from dosma_tpu_torch.defaults import preferences  # noqa: F401
from dosma_tpu_torch.ops.registration import (  # noqa: F401
    RegistrationParams,
    compose_transforms,
    register_chain,
    register_chain_batch,
    register_pair,
    warp_volume,
    warp_volume_batch,
    warp_volume_chain,
)
from dosma_tpu_torch.scan_sequences import Cones, CubeQuant, Mapss, QDess  # noqa: F401
from dosma_tpu_torch.tissues import (  # noqa: F401
    FemoralCartilage,
    Meniscus,
    PatellarCartilage,
    TibialCartilage,
    Tissue,
)
from dosma_tpu_torch.utils.collect_env import collect_env_info  # noqa: F401
from dosma_tpu_torch.utils.env import debug  # noqa: F401
from dosma_tpu_torch.utils.logger import setup_logger  # noqa: F401
