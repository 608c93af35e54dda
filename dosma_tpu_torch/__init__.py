"""dosma_tpu_torch: the PyTorch / CUDA port of dosma_tpu.

The same public names as ``dosma_tpu`` for the ported slices: voxelwise
monoexponential relaxometry and the curve-fitting API (``CurveFitter``,
``PolyFitter``, ``curve_fit``, ``polyfit``). Importing it loads torch and numpy only: no
jax, pandas, yaml or matplotlib. Kernels are compiled on first use.
"""

__version__ = "0.1.0"

from dosma_tpu_torch.core.device import Device, cpu_device, get_device, to_device  # noqa: F401
from dosma_tpu_torch.core.fitting import (  # noqa: F401
    CurveFitter,
    MonoExponentialFit,
    PolyFitter,
    biexponential,
    curve_fit,
    monoexponential,
    polyfit,
)
from dosma_tpu_torch.core.med_volume import MedicalVolume  # noqa: F401
from dosma_tpu_torch.core.orientation import AXIAL, CORONAL, SAGITTAL, to_affine  # noqa: F401
from dosma_tpu_torch.core.quant_vals import (  # noqa: F401
    QuantitativeValue,
    T1Rho,
    T2,
    T2Star,
    get_qv,
)
from dosma_tpu_torch.defaults import preferences  # noqa: F401
