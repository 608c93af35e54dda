"""Monoexponential relaxometry on the data's device.

Counterpart of ``dosma_tpu/ops/monoexp_pipeline.py``: ``MonoExponentialFit``
semantics as seed + fit followed by the elementwise post-processing — rate →
time constant, bounds and r² threshold → NaN, mask, ``nan_to_num`` and
rounding — all on the device the echoes are on. On a card that is one launch
of the kernel's maps entry (:func:`dosma_tpu_torch.ops.monoexp.monoexp_maps`),
which reads the echo rows in place; on the CPU it is
:func:`dosma_tpu_torch.ops.monoexp.monoexp_lm` and then
:func:`dosma_tpu_torch.ops.monoexp.maps_epilogue` in torch, the same
operations as the maps entry's plain version.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dosma_tpu_torch.core.device import as_tensor
from dosma_tpu_torch.ops.monoexp import maps_epilogue, monoexp_lm, monoexp_maps
from dosma_tpu_torch.utils.profiling import annotate

__all__ = ["monoexp_fit_full"]


def monoexp_fit_full(
    x,
    yT,
    bounds: Tuple[float, float],
    tc0,
    r2_threshold: Optional[float],
    decimal_precision: Optional[int],
    mask_flat=None,
    nan_fill: float = 0.0,
    max_iter: int = 100,
):
    """Run the complete monoexp relaxometry fit.

    Args:
        x: (T,) echo/spin-lock times (host).
        yT: (T, N) echo data (a tensor on the CPU or a card, or a numpy
            array), or a list of T (N,) rows on one device, of any dtype. The
            device chooses the path; :func:`monoexp_maps` (a card) or
            :func:`monoexp_lm` (the CPU) lays the data out.
        bounds: (lb, ub) time-constant bounds → NaN outside.
        tc0: initial tc guess or ``"polyfit"``.
        r2_threshold: minimum r² (below → NaN); None keeps every voxel.
        decimal_precision: rounding decimals (None = no rounding; halves
            round to even, as ``jnp.around`` does).
        mask_flat: optional (N,) mask of any dtype; voxels outside (<= 0)
            get ``nan_fill``.
        nan_fill: value replacing NaNs.

    Returns:
        (tc_map (N,), r2 (N,)) float32 tensors on the echoes' device.
    """
    first = yT[0] if isinstance(yT, (list, tuple)) else yT
    on_card = isinstance(first, torch.Tensor) and first.device.type == "cuda"
    p0 = None if isinstance(tc0, str) and tc0 == "polyfit" else (1.0, -1.0 / float(tc0))

    if on_card:
        # One launch: the kernel writes the finished maps.
        with annotate("dosma.fit.lm"):
            return monoexp_maps(
                x, yT, p0, max_iter=max_iter, bounds=bounds, r2_threshold=r2_threshold,
                decimals=decimal_precision, mask=mask_flat, nan_fill=nan_fill,
            )

    # The CPU composes the plain version's two halves through this module's
    # names (``monoexp_lm``, then ``maps_epilogue``), where a test can plant a
    # fault in the fit.
    if isinstance(yT, (list, tuple)):
        yT = torch.stack([as_tensor(r) for r in yT], dim=0)
    with annotate("dosma.fit.lm"):
        popt, r2, _ = monoexp_lm(x, yT, p0, max_iter=max_iter, y_layout="tn")

    with annotate("dosma.fit.post"):
        mask = (None if mask_flat is None
                else as_tensor(mask_flat, r2.device).to(torch.float32).reshape(-1))
        return maps_epilogue(popt[:, 1], r2, bounds, r2_threshold, decimal_precision, mask,
                             nan_fill)
