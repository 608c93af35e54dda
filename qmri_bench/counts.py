"""Peaks of the card and the work a request needs, from shapes alone.

The arithmetic is that of ``chip_smoke.py::bound`` and ``lm_bound``: the
least time is the larger of bytes over the memory bandwidth and float32
operations over the float32 rate outside the tensor cores. Peaks are
NVIDIA's data sheet for one H100 SXM at its full 700 W.

The operations of a monoexponential fit are counted per voxel with a
frozen number of Levenberg-Marquardt iterations, so the count does not
change with the code it measures (``chip_smoke.py`` took the kernel's own
mean latch iteration, 2.187 on config1).
"""

from __future__ import annotations

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F32_PER_S", "MONOEXP_ITERATIONS", "least_seconds",
           "monoexp_fit_work"]

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12

# Iterations a voxel of these recipes needs, frozen: chip_smoke.py measured a
# mean of 2.187 on config1, rounded up to whole iterations.
MONOEXP_ITERATIONS = 3


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time the card could take for this work."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_PER_S)


def monoexp_fit_work(n_voxels: int, n_echoes: int):
    """(bytes, float32 operations) of one monoexponential fit of ``n_voxels``
    voxels at ``n_echoes`` echoes: the echoes read once and four rows (a, b,
    r2, converged) written once; a log-linear seed of 8T + 10 operations,
    ``MONOEXP_ITERATIONS`` iterations of 20T + 40 (``chip_smoke.py``'s
    count: columns, six sums, the Newton step and the trial cost) and a
    closing pass of 6T + 10 (amplitude and r2)."""
    t = int(n_echoes)
    nbytes = 4 * t * n_voxels + 4 * 4 * n_voxels
    per_voxel = (8 * t + 10) + MONOEXP_ITERATIONS * (20 * t + 40) + (6 * t + 10)
    return nbytes, per_voxel * n_voxels
