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
        "dosma_tpu_torch.core.io.nifti_io, dosma_tpu_torch.utils.env\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'pandas', 'yaml', 'matplotlib', 'dosma_tpu')))"
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
            assert top not in ("jax", "jaxlib", "dosma_tpu"), line


def test_ops_import_and_run_without_nvcc(tmp_path):
    env = dict(os.environ)
    env["PATH"] = str(tmp_path)  # no nvcc anywhere on it
    env["CUDA_HOME"] = env["CUDA_PATH"] = str(tmp_path / "no-cuda")
    out = _run(
        "import numpy as np, torch\n"
        "from dosma_tpu_torch.ops.monoexp import monoexp_lm\n"
        "y = torch.exp(-torch.arange(1, 5, dtype=torch.float32) / 20).repeat(3, 1)\n"
        "popt, r2, conv = monoexp_lm(np.float32([1, 2, 3, 4]), y)\n"
        "print(monoexp_lm.launches, bool(conv.all()), round(float(popt[0, 1]), 4))",
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
    # The default build keeps multiplies and adds separately rounded, as the
    # plain version does; the fused build (for measuring that choice) must
    # never be loaded in its place, so its flags and file name differ.
    from dosma_tpu_torch.ops import _build

    plain, fused = _build._nvcc_flags(False), _build._nvcc_flags(True)
    assert "-fmad=false" in plain and "-fmad=true" not in plain
    assert "-fmad=true" in fused and "-fmad=false" not in fused
    assert "arch=compute_90a,code=sm_90a" in fused
    assert _build._sources_digest("monoexp_lm", plain) != _build._sources_digest(
        "monoexp_lm", fused
    )
