"""Environment report for bug reports (counterpart of
``dosma_tpu/utils/collect_env.py``): the platform, Python, the port, torch
and CUDA, each card's name and memory, and the optional packages.

Run: ``python -m dosma_tpu_torch.utils.collect_env``
"""

from __future__ import annotations

import os
import platform
import sys

__all__ = ["collect_env_info"]

_PACKAGES = ["numpy", "scipy", "pandas", "matplotlib", "yaml", "h5py"]


def collect_env_info() -> str:
    """Platform, library and card information as a two-column table.

    A package that is not installed is reported so, without importing
    anything in its place.
    """
    import torch

    import dosma_tpu_torch
    from dosma_tpu_torch.utils import env

    rows = [
        ("sys.platform", sys.platform),
        ("Python", sys.version.replace("\n", "")),
        ("Machine", platform.machine()),
        ("Processor", platform.processor() or "n/a"),
        ("dosma_tpu_torch", dosma_tpu_torch.__version__),
        ("torch", torch.__version__),
        ("torch.version.cuda", str(torch.version.cuda)),
    ]
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            rows.append((f"cuda:{i}", f"{props.name}, {props.total_memory / 2**30:.1f} GiB"))
    else:
        rows.append(("cuda", "no card available"))
    for pkg in _PACKAGES:
        rows.append((pkg, env.get_version(pkg) if env.package_available(pkg) else "not installed"))
    rows.append(("DOSMA_DEBUG", os.environ.get("DOSMA_DEBUG", "unset")))

    width = max(len(k) for k, _ in rows)
    return "\n".join(f"{k.ljust(width)}  {v}" for k, v in rows)


if __name__ == "__main__":
    print(collect_env_info())
