"""Shared helpers of the registered MRI scans (counterpart of
``dosma_tpu/scan_sequences/mri/_common.py``).

CubeQuant, Mapss and Cones share their shape: echo or spin-lock times read
from the headers, a masked monoexponential fit wrapped in a
QuantitativeValue, and command-line actions with one vocabulary. Each
scan's module keeps what differs (echo selection, bounds, the anchor of
its registration).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Type

from dosma_tpu_torch.core import quant_vals as qv
from dosma_tpu_torch.core.fitting import MonoExponentialFit
from dosma_tpu_torch.core.io import format_io_utils as fio_utils
from dosma_tpu_torch.utils.cmd_line_utils import ActionWrapper
from dosma_tpu_torch.utils.profiling import annotate

__all__ = [
    "times_from_headers",
    "resolve_fit_mask",
    "monoexp_qv_fit",
    "interregister_action",
    "intraregister_action",
    "qmap_action",
]


def times_from_headers(volumes, arg_name: str) -> Optional[Sequence[float]]:
    """EchoTime of each volume from its DICOM headers.

    Volumes without headers give ``None`` (the caller's attribute stays
    unset); a header that cannot be read raises, naming the argument that
    would supply the times.
    """
    try:
        if all(v.headers() is not None for v in volumes):
            return [v.get_metadata("EchoTime", float) for v in volumes]
        return None
    except (KeyError, AttributeError, RuntimeError) as e:
        raise ValueError(
            f"Could not extract echo times from header. "
            f"Please specify `{arg_name}` argument - {e}"
        )


def resolve_fit_mask(tissue, mask_path):
    """The fit's mask: an explicit ``mask_path`` (path or volume) wins over
    the tissue's mask."""
    if mask_path is not None:
        if isinstance(mask_path, (str, os.PathLike)):
            return fio_utils.generic_load(mask_path, expected_num_volumes=1)
        return mask_path
    return tissue.get_mask() if tissue is not None else None


def monoexp_qv_fit(
    xs,
    ys,
    qv_type: Type[qv.QuantitativeValue],
    bounds,
    decimal_precision: int,
    tissue=None,
    mask_path=None,
    num_workers: int = 0,
    tc0="polyfit",
):
    """Masked monoexponential fit (one ``monoexp_lm`` launch for volumes on
    a card) → a QuantitativeValue with an r² extra, added to the tissue
    when one is given."""
    with annotate("dosma.fit.scan"):
        fitter = MonoExponentialFit(
            bounds=bounds, tc0=tc0, decimal_precision=decimal_precision, num_workers=num_workers
        )
        tc_map, r2 = fitter.fit(xs, ys, mask=resolve_fit_mask(tissue, mask_path))

        result = qv_type(tc_map)
        result.add_additional_volume("r2", r2)
        if tissue is not None:
            tissue.add_quantitative_value(result)
    return result


_MASK_HELP = "mask filepath (.nii.gz) to reduce computation"


def interregister_action(method):
    """(method, ActionWrapper) of the interregister action."""
    return (
        method,
        ActionWrapper(
            name=method.__name__,
            help="register to another scan",
            param_help={
                "target_path": "path to target image in nifti format (.nii.gz)",
                "target_mask_path": "path to target mask in nifti format (.nii.gz)",
            },
            alternative_param_names={
                "target_path": ["tp", "target"],
                "target_mask_path": ["tm", "target_mask"],
            },
        ),
    )


def intraregister_action(method):
    return (
        method,
        ActionWrapper(name=method.__name__, help="register volumes within this scan"),
    )


def qmap_action(method, help_text: str, aliases: Optional[Sequence[str]] = None,
                mask_help: str = _MASK_HELP):
    """(method, ActionWrapper) of a quantitative-map action."""
    return (
        method,
        ActionWrapper(
            name=method.__name__,
            help=help_text,
            aliases=list(aliases) if aliases else None,
            param_help={"mask_path": mask_help},
        ),
    )
