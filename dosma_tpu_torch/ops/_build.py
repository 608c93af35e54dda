"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on first use into a shared library with a
plain C interface, under ``dosma_tpu_torch/_build/`` (listed in
``.gitignore``). The library's file name carries a hash of the sources and
the compiler flags, so an edited source is rebuilt and a stale library is
never loaded. Generated sources (the generic LM kernel, one per model) are
written beside their libraries and cached the same way, under the hash of
the generated text, the headers and the flags. A failed build or load
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["load_library", "load_generated"]

_PKG_DIR = Path(__file__).resolve().parent.parent
_CSRC = _PKG_DIR / "csrc"
_BUILD_DIR = _PKG_DIR / "_build"

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the kernels")
    return found


def _nvcc_flags(fmad: bool) -> tuple:
    if not fmad:
        return _NVCC_FLAGS
    return tuple("-fmad=true" if f == "-fmad=false" else f for f in _NVCC_FLAGS)


def _digest(flags: tuple, main_name: str, main_text: bytes) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for path in sorted(_CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(main_name.encode())
    h.update(main_text)
    return h.hexdigest()[:16]


def _sources_digest(name: str, flags: tuple) -> str:
    path = _CSRC / f"{name}.cu"
    return _digest(flags, path.name, path.read_bytes())


def _load(src: Path, stem: str, flags: tuple) -> ctypes.CDLL:
    """Compile ``src`` into ``_build/lib<stem>.so`` unless it exists; load it."""
    out_dir = _BUILD_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"lib{stem}.so"
    seconds = 0.0
    if not lib_path.is_file():
        t0 = time.perf_counter()
        # Build to a private name, then rename: concurrent processes never
        # load a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *flags, "-I", str(_CSRC), "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            (out_dir / f"{stem}.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src.name}:\n{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(lib_path))
    lib.build_seconds = seconds
    lib.build_log = out_dir / f"{stem}.log"
    return lib


@functools.lru_cache(maxsize=None)
def load_library(name: str, fmad: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if its library is not built yet, and load it.

    The compiler's register and spill report (``-Xptxas -v``) is kept beside
    the library as ``<name>-<hash>.log``; ``load_library(name).build_seconds``
    is the compile time (0 when an existing build was loaded). ``fmad=True``
    builds a second library with fused multiply-adds, which only
    ``tools/profile_monoexp_fit.py`` loads, to measure what ``-fmad=false``
    costs.
    """
    flags = _nvcc_flags(fmad)
    src = _CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"kernel source {src} missing")
    return _load(src, f"{name}-{_sources_digest(name, flags)}", flags)


@functools.lru_cache(maxsize=None)
def load_generated(name: str, source: str) -> ctypes.CDLL:
    """Compile a generated CUDA source (which may include ``csrc/*.cuh``)
    once per distinct text, and load it. The source is kept beside its
    library as ``<name>-<hash>.cu``."""
    flags = _nvcc_flags(False)
    stem = f"{name}-{_digest(flags, name, source.encode())}"
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _BUILD_DIR / f"{stem}.cu"
    if not src.is_file():
        fd, tmp = tempfile.mkstemp(suffix=".cu", dir=_BUILD_DIR)
        with os.fdopen(fd, "w") as f:
            f.write(source)
        os.replace(tmp, src)
    return _load(src, stem, flags)
