"""dosma_tpu_torch: the PyTorch / CUDA port of dosma_tpu.

The same public names as ``dosma_tpu`` for the ported slices: voxelwise
monoexponential relaxometry, the curve-fitting API (``CurveFitter``,
``PolyFitter``, ``curve_fit``, ``polyfit``) and matrix registration
(``register``, ``apply_warp`` and the ``ops.registration`` functions).
Importing it loads torch and numpy only: no jax, pandas, yaml or
matplotlib. Kernels are compiled on first use.

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
from dosma_tpu_torch.core.med_volume import MedicalVolume  # noqa: F401
from dosma_tpu_torch.core.orientation import AXIAL, CORONAL, SAGITTAL, to_affine  # noqa: F401
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
