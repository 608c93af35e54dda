"""Optional packages, package directories and the debug flag (counterpart
of ``dosma_tpu/utils/env.py``, without its JAX backend probe)."""

from __future__ import annotations

import importlib
import importlib.util
import os
from typing import Optional

__all__ = [
    "debug",
    "get_version",
    "package_available",
    "sitk_available",
    "cupy_available",
    "torch_available",
    "h5py_available",
    "nibabel_available",
    "pydicom_available",
    "resources_dir",
    "output_dir",
    "temp_dir",
    "log_file_path",
]

_DOSMA_DIR = os.path.expanduser("~/.dosma_tpu_torch")

_SUPPORTED_PACKAGES = {}


def package_available(name: str) -> bool:
    """True if the package ``name`` can be imported (found once, then cached;
    nothing is imported)."""
    if name not in _SUPPORTED_PACKAGES:
        try:
            _SUPPORTED_PACKAGES[name] = importlib.util.find_spec(name) is not None
        except (ImportError, ValueError):
            _SUPPORTED_PACKAGES[name] = False
    return _SUPPORTED_PACKAGES[name]


def get_version(package_or_name) -> str:
    """``__version__`` of a package (a module or its name); raises
    ``ValueError`` if it is not installed."""
    name = package_or_name if isinstance(package_or_name, str) else package_or_name.__name__
    if not package_available(name):
        raise ValueError(f"Package '{name}' not available")
    return getattr(importlib.import_module(name), "__version__", "unknown")


def sitk_available() -> bool:
    return package_available("SimpleITK")


def cupy_available() -> bool:
    return package_available("cupy")


def torch_available() -> bool:
    return package_available("torch")


def h5py_available() -> bool:
    return package_available("h5py")


def nibabel_available() -> bool:
    return package_available("nibabel")


def pydicom_available() -> bool:
    return package_available("pydicom")


def debug(value: Optional[bool] = None) -> bool:
    """Get, or set and get, debug mode (``$DOSMA_DEBUG``).

    Setting it re-levels the package logger's console handler: DEBUG when
    on, INFO when off.
    """
    if value is not None:
        if not isinstance(value, bool):
            raise ValueError("value must be a bool")
        import logging

        from dosma_tpu_torch.utils import logger as _logger

        os.environ["DOSMA_DEBUG"] = str(value)
        _logger.setup_logger.cache_clear()
        pkg_logger = _logger.setup_logger()
        # setup_logger keeps existing handlers, so re-level them here.
        lvl = logging.DEBUG if value else logging.INFO
        for h in pkg_logger.handlers:
            if isinstance(h, logging.StreamHandler) and not isinstance(h, logging.FileHandler):
                h.setLevel(lvl)
    return os.environ.get("DOSMA_DEBUG", "").lower() in ("true", "1")


def resources_dir() -> str:
    """The package's ``resources`` directory."""
    return os.path.join(os.path.dirname(os.path.dirname(__file__)), "resources")


def output_dir() -> str:
    """Output directory: ``$DOSMA_OUTPUT_DIR``, else ``~/.dosma_tpu_torch/outputs``."""
    return os.environ.get("DOSMA_OUTPUT_DIR", os.path.join(_DOSMA_DIR, "outputs"))


def temp_dir() -> str:
    """Scratch directory: ``$DOSMA_TEMP_DIR``, else ``~/.dosma_tpu_torch/temp``."""
    path = os.environ.get("DOSMA_TEMP_DIR", os.path.join(_DOSMA_DIR, "temp"))
    os.makedirs(path, exist_ok=True)
    return path


def log_file_path() -> str:
    """The log file of :func:`dosma_tpu_torch.utils.logger.setup_logger`."""
    return os.path.join(_DOSMA_DIR, "dosma.log")
