"""Knee analysis workflow and its CLI subcommand (counterpart of
``dosma_tpu/msk/knee.py``): for each requested tissue, load the saved mask
and quantitative maps, compute the regional analytics of every requested
quantitative value, and write them out.
"""

from __future__ import annotations

import logging
import uuid
from typing import Dict, List, Sequence

from dosma_tpu_torch.core.quant_vals import QuantitativeValueType as QV
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.tissues import FemoralCartilage, Meniscus, PatellarCartilage, TibialCartilage
from dosma_tpu_torch.tissues.tissue import Tissue

KNEE_KEY = "knee"
MEDIAL_TO_LATERAL_KEY = "ml"
TISSUES_KEY = "tissues"
LOAD_KEY = "load"
SAVE_KEY = "save"
PID_KEY = "pid"

SUPPORTED_TISSUES = [FemoralCartilage, Meniscus, TibialCartilage, PatellarCartilage]
SUPPORTED_QUANTITATIVE_VALUES = [QV.T2, QV.T1_RHO, QV.T2_STAR]

_logger = logging.getLogger(__name__)

# Declarative flag table: (flag, argparse kwargs).
_KNEE_FLAGS = [
    (
        MEDIAL_TO_LATERAL_KEY,
        dict(
            action="store_const",
            const=True,
            default=False,
            help="defines slices in sagittal direction going from medial -> lateral",
        ),
    ),
]


def knee_parser(base_parser):
    """Attach the ``knee`` subcommand (flags generated from the tissue and
    quantitative-value tables)."""
    parser = base_parser.add_parser(
        KNEE_KEY, help="calculate/analyze quantitative data for knee"
    )
    for flag, kwargs in _KNEE_FLAGS:
        parser.add_argument(f"--{flag}", **kwargs)
    parser.add_argument(
        f"--{PID_KEY}", nargs="?", default=str(uuid.uuid4()), help="specify pid"
    )

    for tissue_cls in SUPPORTED_TISSUES:
        parser.add_argument(
            f"--{tissue_cls.STR_ID}",
            action="store_const",
            const=True,
            default=False,
            help=f"analyze {tissue_cls.FULL_NAME}",
        )
    for qv in SUPPORTED_QUANTITATIVE_VALUES:
        parser.add_argument(
            f"--{qv.name.lower()}",
            action="store_const",
            const=True,
            default=False,
            help=f"quantify {qv.name.lower()}",
        )

    parser.set_defaults(func=handle_knee)


def _resolve_tissues(vargin: Dict) -> List[Tissue]:
    requested = vargin.get(TISSUES_KEY)
    if requested:
        return list(requested)
    _logger.info("Computing for all supported knee tissues...")
    return [cls() for cls in SUPPORTED_TISSUES]


def _resolve_qvs(vargin: Dict) -> Sequence:
    selected = [qv for qv in SUPPORTED_QUANTITATIVE_VALUES if vargin.get(qv.name.lower())]
    if selected:
        return selected
    _logger.info("Computing for all supported quantitative values...")
    return SUPPORTED_QUANTITATIVE_VALUES


def handle_knee(vargin: Dict) -> List[Tissue]:
    """Run the knee workflow: per tissue, reload stored masks/maps from
    ``--load``, compute regional metrics for the requested quantitative
    values, and write analytics to ``--save``."""
    tissues = _resolve_tissues(vargin)
    qvs = _resolve_qvs(vargin)
    load_path = vargin[LOAD_KEY]
    save_path = vargin[SAVE_KEY]

    for tissue in tissues:
        tissue.pid = vargin[PID_KEY]
        tissue.medial_to_lateral = vargin[MEDIAL_TO_LATERAL_KEY]
        tissue.load_data(load_path)

        _logger.info(tissue.FULL_NAME)
        for qv in qvs:
            _logger.info(f"Analyzing {qv.name.lower()}")
        # One pass: calc_quant_vals already iterates every registered qv
        # (calling it inside the loop above recomputed the full region
        # analytics N times per tissue).
        tissue.calc_quant_vals()

    for tissue in tissues:
        tissue.save_data(save_path, data_format=preferences.image_data_format)

    return tissues
