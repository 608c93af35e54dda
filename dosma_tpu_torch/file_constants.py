"""Registration parameter presets by name (counterpart of
``dosma_tpu/file_constants.py``).

The constants keep DOSMA's names. Each is the name of a preset of
:data:`dosma_tpu_torch.core.registration.PRESETS` (the port ships the
presets as dicts, not as files); ``register`` accepts them as parameter
files.
"""

ELASTIX_RIGID_PARAMS_FILE = "parameters-rigid.yaml"
ELASTIX_AFFINE_PARAMS_FILE = "parameters-affine.yaml"
ELASTIX_BSPLINE_PARAMS_FILE = "parameters-bspline.yaml"
ELASTIX_RIGID_INTERREGISTER_PARAMS_FILE = "parameters-rigid-interregister.yaml"
ELASTIX_AFFINE_INTERREGISTER_PARAMS_FILE = "parameters-affine-interregister.yaml"


def __getattr__(name):
    if name == "TEMP_FOLDER_PATH":  # made on first use, not at import
        from dosma_tpu_torch.utils import env

        return env.temp_dir()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
