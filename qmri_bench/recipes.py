"""Inputs of every cell, made on the device from ``--seed``.

The recipes are those of the repository's earlier TPU benchmark, rewritten
in PyTorch and drawn with one ``torch.Generator`` on the device: the same
distributions, not the same numpy streams.

- ``config1`` (``bench.py:120-135``, ``chip_smoke.py::config1_data``):
  ``b = -1 / (U * 70 + 10)``, echoes ``exp(b * TE) + sigma * N(0, 1)``, and
  the two-label mask of ``config1_data``.
- ``cubequant`` (``bench.py:372-391``): T1rho ``U(20, 100)``, a box of 1000
  plus ``50 * U(0, 1)``, spin lock ``i`` equal to ``base * exp(-TSL_i / T1rho)``
  and, for the registration cell, rolled by ``i * (1, -1, 0)``; the condyle
  arc of ``bench.py:544-553`` as the femoral cartilage mask.

Every seed draws the same number of values of each size in the same order,
so every seed does the same work.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["generator", "sagittal_affine", "config1_scan", "config1_labels", "cubequant_scan",
           "condyle_arc"]


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def sagittal_affine(spacing) -> np.ndarray:
    """The RAS+ affine of a sagittal ("SI", "AP", "LR") grid: array axis 0
    runs inferior, 1 posterior, 2 right (DOSMA's ``to_affine(SAGITTAL,
    spacing)``)."""
    s0, s1, s2 = (float(s) for s in spacing)
    return np.array([[0.0, 0.0, s2, 0.0],
                     [0.0, -s1, 0.0, 0.0],
                     [-s0, 0.0, 0.0, 0.0],
                     [0.0, 0.0, 0.0, 1.0]])


def config1_scan(cfg, gen: torch.Generator, device) -> torch.Tensor:
    """One config1 scan: the echoes as a (T,) + shape float32 tensor."""
    shape = tuple(cfg["shape"])
    n = int(np.prod(shape))
    te = torch.tensor(cfg["echo_times_ms"], dtype=torch.float32, device=device)
    u = torch.rand(n, generator=gen, device=device)
    b = -1.0 / (u * 70.0 + 10.0)
    noise = torch.randn((te.numel(), n), generator=gen, device=device)
    y = torch.exp(b[None, :] * te[:, None]) + float(cfg["noise_sigma"]) * noise
    return y.reshape((te.numel(),) + shape)


def config1_labels(cfg, device) -> torch.Tensor:
    """The two-label uint8 mask of ``chip_smoke.py::config1_data``."""
    labels = torch.zeros(tuple(cfg["shape"]), dtype=torch.uint8, device=device)
    for label, ((a0, a1), (b0, b1), (c0, c1)) in cfg["label_boxes"].items():
        labels[a0:a1, b0:b1, c0:c1] = int(label)
    return labels


def cubequant_scan(cfg, gen: torch.Generator, device, rolled: bool) -> torch.Tensor:
    """One CubeQuant series: the spin locks as a (4,) + shape float32 tensor,
    spin lock ``i`` rolled by ``i * roll_per_spin_lock`` when ``rolled``."""
    shape = tuple(cfg["shape"])
    lo, hi = cfg["t1rho_ms"]
    t1rho = torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo
    base = torch.zeros(shape, dtype=torch.float32, device=device)
    base[shape[0] // 4: -(shape[0] // 4), shape[1] // 4: -(shape[1] // 4), 2:-2] = cfg["box_value"]
    base += cfg["box_noise"] * torch.rand(shape, generator=gen, device=device)
    roll = cfg["roll_per_spin_lock"]
    vols = []
    for i, tsl in enumerate(cfg["spin_lock_times_ms"]):
        sig = base * torch.exp(-tsl / t1rho)
        if rolled and i:
            sig = torch.roll(sig, tuple(i * r for r in roll), dims=(0, 1, 2))
        vols.append(sig)
    return torch.stack(vols)


def condyle_arc(shape) -> np.ndarray:
    """``bench.py:544-553``: the inferior arc of a femoral condyle in each
    sagittal slice, as a uint8 mask."""
    h, w, d = shape
    yv, xv = np.mgrid[0:h, 0:w]
    cy, cx, r = h * 0.45, w * 0.5, h * 0.3
    rad = np.sqrt((yv - cy) ** 2 + (xv - cx) ** 2)
    annulus = (rad > r * 0.8) & (rad < r * 1.05) & (yv > cy)
    return np.repeat(annulus[..., None], d, axis=2).astype(np.uint8)
