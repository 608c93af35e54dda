"""Import hygiene of the PyTorch port.

The machine that runs the port has torch but no jax, pandas or yaml, and a
kernel is compiled only when it is first launched, so importing the port
must need none of those and no CUDA compiler.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


_REPO = Path(__file__).resolve().parent.parent
_PKG = _REPO / "dosma_tpu_torch"


def _run(code: str, env=None) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=_REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_import_loads_no_jax_pandas_yaml():
    out = _run(
        "import sys, dosma_tpu_torch, dosma_tpu_torch.ops.monoexp, "
        "dosma_tpu_torch.ops.monoexp_pipeline, dosma_tpu_torch.ops.nlls, "
        "dosma_tpu_torch.ops.biexp, dosma_tpu_torch.ops.generic_lm, "
        "dosma_tpu_torch.ops.interp, dosma_tpu_torch.ops.warp, "
        "dosma_tpu_torch.ops.registration, dosma_tpu_torch.core.registration, "
        "dosma_tpu_torch.core.io.nifti_io, dosma_tpu_torch.utils.env, "
        "dosma_tpu_torch.core.io.dicom_io, dosma_tpu_torch.core.io.format_io_utils, "
        "dosma_tpu_torch.core.io.prefetch, dosma_tpu_torch.core.io._native, "
        "dosma_tpu_torch.core.numpy_routines, dosma_tpu_torch.ops.qmri, "
        "dosma_tpu_torch.ops.analytics, dosma_tpu_torch.utils.io_utils, "
        "dosma_tpu_torch.utils.logger, dosma_tpu_torch.file_constants, "
        "dosma_tpu_torch.models, dosma_tpu_torch.models.unet2d, "
        "dosma_tpu_torch.models.weights, dosma_tpu_torch.models.util, "
        "dosma_tpu_torch.ops.bspline, dosma_tpu_torch.scan_sequences.mri.cube_quant, "
        "dosma_tpu_torch.scan_sequences.mri.mapss, dosma_tpu_torch.scan_sequences.mri.cones, "
        "dosma_tpu_torch.parallel, dosma_tpu_torch.parallel.sharding, "
        "dosma_tpu_torch.parallel.dryrun, dosma_tpu_torch.train, "
        "dosma_tpu_torch.train.seg_trainer, dosma_tpu_torch.train.checkpoint, "
        "dosma_tpu_torch.utils.profiling, dosma_tpu_torch.cli, dosma_tpu_torch.app, "
        "dosma_tpu_torch.gui.ims, dosma_tpu_torch.utils.collect_env, "
        "dosma_tpu_torch.core.sitk_interop\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pandas', 'yaml', 'matplotlib', 'dosma_tpu', 'PIL', 'h5py', "
        "'optax', 'orbax')))"
    )
    assert out == "[]"


@pytest.mark.parametrize(
    "path", sorted(_PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(_REPO))
)
def test_no_file_imports_jax_or_the_jax_package(path):
    for line in path.read_text().splitlines():
        words = line.split()
        if words[:1] in (["import"], ["from"]) and len(words) > 1:
            top = words[1].split(".")[0].rstrip(",")
            assert top not in ("jax", "jaxlib", "dosma_tpu", "optax", "orbax"), line


def test_ops_import_and_run_without_nvcc(tmp_path):
    env = dict(os.environ)
    env["PATH"] = str(tmp_path)  # no nvcc anywhere on it
    env["CUDA_HOME"] = env["CUDA_PATH"] = str(tmp_path / "no-cuda")
    out = _run(
        "import numpy as np, torch\n"
        "from dosma_tpu_torch.ops.monoexp import monoexp_lm\n"
        "from dosma_tpu_torch.utils.profiling import counters\n"
        "y = torch.exp(-torch.arange(1, 5, dtype=torch.float32) / 20).repeat(3, 1)\n"
        "popt, r2, conv = monoexp_lm(np.float32([1, 2, 3, 4]), y)\n"
        "print(counters['monoexp_lm.launches'], bool(conv.all()), round(float(popt[0, 1]), 4))",
        env=env,
    )
    assert out == "0 True -0.05"


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    from dosma_tpu_torch.ops import _build

    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("CUDA_PATH", str(tmp_path / "no-cuda"))
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at its default place")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


def test_fmad_build_is_a_separate_library():
    # There is one build of each kernel: multiplies and adds separately
    # rounded, as the plain version's are (bit equality depends on it), for
    # Hopper's sm_90a; each source gets a library of its own name.
    from dosma_tpu_torch.ops import _build

    flags = _build._NVCC_FLAGS
    assert "-fmad=false" in flags and "-fmad=true" not in flags
    assert "--use_fast_math" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    assert _build._sources_digest("monoexp_lm") != _build._sources_digest("biexp_lm")


_IO_AND_MAP_NAMES = [
    "read", "write", "load", "save", "ImageDataFormat", "DicomReader", "DicomWriter",
    "NiftiReader", "NiftiWriter", "get_reader", "get_writer", "generic_load",
    "get_filepath_variations", "convert_image_data_format", "get_transpose_inds",
    "get_flip_inds", "orientation_nib_to_standard", "orientation_standard_to_nib",
    "quant_vals", "numpy_routines", "load_to_device", "setup_logger", "debug",
]


@pytest.mark.parametrize("name", _IO_AND_MAP_NAMES)
def test_exports_the_io_and_map_names(name):
    import dosma_tpu_torch

    assert getattr(dosma_tpu_torch, name) is not None


def test_names_still_missing_against_the_jax_package():
    """None is left: the port has every public name of ``dosma_tpu``."""
    import re

    import dosma_tpu_torch

    src = (_REPO / "dosma_tpu" / "__init__.py").read_text()
    lazy = set(re.findall(r'^\s+"(\w+)": \(', src, re.M))
    eager = {"Device", "cpu_device", "get_array_module", "get_device", "to_device",
             "MedicalVolume", "AXIAL", "CORONAL", "SAGITTAL", "to_affine", "numpy_routines",
             "preferences", "debug", "setup_logger", "quant_vals"}
    missing = {n for n in lazy | eager if not hasattr(dosma_tpu_torch, n)}
    assert missing == set()
    for name in ("CubeQuant", "Mapss", "Cones", "get_array_module", "collect_env_info"):
        assert getattr(dosma_tpu_torch, name).__module__.startswith("dosma_tpu_torch.")


def test_every_module_of_the_jax_package_has_a_counterpart():
    """Every module of ``dosma_tpu`` has one in the port, but the four
    Pallas kernels, which are ported as CUDA kernels (``csrc/``)."""
    jax_pkg = _REPO / "dosma_tpu"
    mods = {str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*.py")}
    missing = sorted(m for m in mods if not (_PKG / m).is_file())
    assert missing == ["ops/biexp_pallas.py", "ops/generic_lm_pallas.py",
                       "ops/monoexp_pallas.py", "ops/warp_pallas.py"]


def test_cli_gui_and_env_report_need_no_optional_package():
    """The machine with the card has no matplotlib, pandas, yaml or h5py:
    the command line, the GUI modules and the environment report import and
    run with each of them made unimportable."""
    out = _run(
        "import sys\n"
        "for m in ('matplotlib', 'pandas', 'yaml', 'h5py', 'jax', 'dosma_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import dosma_tpu_torch.cli, dosma_tpu_torch.app, dosma_tpu_torch.gui.ims, "
        "dosma_tpu_torch.gui.im_viewer, dosma_tpu_torch.gui.preferences_viewer, "
        "dosma_tpu_torch.gui.dosma_gui, dosma_tpu_torch.gui.gui_utils.widgets, "
        "dosma_tpu_torch.core.sitk_interop\n"
        "from dosma_tpu_torch import collect_env_info\n"
        "info = collect_env_info()\n"
        "parser, _ = dosma_tpu_torch.cli._build_parser()\n"
        "print('matplotlib' in info, 'jax' in info, "
        "sorted(m for m in sys.modules if m.split('.')[0] == 'tkinter'))"
    )
    assert out == "True False []"


def test_parsing_the_command_line_touches_no_card():
    """``--gpu G`` sets CUDA_VISIBLE_DEVICES, which CUDA reads only when it
    is first initialised: importing the port and parsing the arguments must
    not initialise it (every torch.cuda entry that would is made to fail)."""
    out = _run(
        "import os, torch\n"
        "def touched(*a, **k):\n"
        "    raise SystemExit('torch.cuda was touched')\n"
        "for name in ('is_available', 'device_count', 'init', '_lazy_init', "
        "'current_device', 'set_device', 'get_device_name'):\n"
        "    setattr(torch.cuda, name, touched)\n"
        "import dosma_tpu_torch.cli as cli\n"
        "parser, _ = cli._build_parser()\n"
        "vargin = vars(parser.parse_args('--gpu 3 --l x qdess --fc t2'.split()))\n"
        "print(vargin['gpu'], vargin['scan_action'])"
    )
    assert out == "3 t2"
