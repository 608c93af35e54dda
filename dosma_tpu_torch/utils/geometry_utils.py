"""Geometry helpers (counterpart of ``dosma_tpu/utils/geometry_utils.py``).

``circle_fit`` minimizes geometric-distance residuals with scipy
``leastsq`` from a centroid initialization, as the JAX package does, so the
fitted condyle circles match it bit for bit. numpy and scipy on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["circle_fit", "cart2pol", "center_of_mass"]


def circle_fit(x: np.ndarray, y: np.ndarray) -> Tuple[float, float, float]:
    """Least-squares circle fit to scatter points → (xc, yc, R).

    Same objective as the reference (geometric distance residuals,
    ``geometry_utils.py:11-70``); solved via scipy leastsq from the
    centroid initialization for identical behavior.
    """
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)

    from scipy import optimize

    x_m, y_m = x.mean(), y.mean()

    def calc_R(xc, yc):
        return np.sqrt((x - xc) ** 2 + (y - yc) ** 2)

    def f_2(c):
        Ri = calc_R(*c)
        return Ri - Ri.mean()

    center, _ = optimize.leastsq(f_2, (x_m, y_m))
    xc, yc = center
    R = calc_R(xc, yc).mean()
    return float(xc), float(yc), float(R)


def cart2pol(x, y) -> Tuple[np.ndarray, np.ndarray]:
    """Cartesian → polar, angle in degrees in [-180, 180) with +180 → -180
    (ref ``geometry_utils.py:73-89``)."""
    rho = np.sqrt(x**2 + y**2)
    phi = np.arctan2(y, x) * (180 / np.pi)
    phi = np.asarray(phi)
    phi[phi == 180] = -180
    return rho, phi


def center_of_mass(input, labels=None, index=None):
    """Center of mass (scipy.ndimage passthrough; ref ``geometry_utils.py:92-124``)."""
    import scipy.ndimage as sni

    return sni.center_of_mass(np.asarray(input), labels=labels, index=index)
