"""qDESS scan sequence: segmentation and the analytic T2 map (counterpart of
``dosma_tpu/scan_sequences/mri/qdess.py``).

The analytic T2 (Sveinsson et al., MRM 2017) and the echo combinations are
elementwise torch on the echoes' device (:mod:`dosma_tpu_torch.ops.qmri`):
card echoes give card maps, host echoes are computed on the default device
and give host maps. This module resolves the acquisition parameters from
the DICOM header (TR, TE, flip angle and GE's private spoiler tags) and
wraps the result in a :class:`MedicalVolume`.
"""

from __future__ import annotations

import logging
import math
import warnings
from typing import Sequence, Tuple, Union

import numpy as np

from dosma_tpu_torch.core import quant_vals as qv
from dosma_tpu_torch.core.io.dicom import Tag
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.models.seg_model import SegModel
from dosma_tpu_torch.scan_sequences.scans import ScanSequence
from dosma_tpu_torch.tissues.tissue import Tissue
from dosma_tpu_torch.utils.cmd_line_utils import ActionWrapper

__all__ = ["QDess"]

_logger = logging.getLogger(__name__)


class QDess(ScanSequence):
    """Quantitative double-echo-in-steady-state (qDESS) MRI sequence.

    The sequence acquires two echoes (S1, S2) per excitation. Their ratio
    yields an analytic T2 estimate; echo 1 (or the echo RSS) doubles as the
    segmentation input.
    """

    NAME = "qdess"

    # GE private tags carrying the spoiler gradient area / time — required
    # inputs to the analytic T2 model.
    __GL_AREA_TAG__ = Tag(0x0019, 0x10B6)
    __TG_TAG__ = Tag(0x0019, 0x10B7)

    __NUM_ECHOS__ = 2
    __VOLUME_DIMENSIONS__ = 3

    def __init__(self, volumes: Sequence[MedicalVolume]):
        if len(volumes) != self.__NUM_ECHOS__:
            raise ValueError("QDess currently only supports 2 volumes.")
        super().__init__(volumes)

    def __validate_scan__(self) -> bool:
        return len(self.volumes) == self.__NUM_ECHOS__

    # ------------------------------------------------------------------
    def segment(
        self, model: SegModel, tissue: Union[Tissue, Sequence[Tissue]], use_rss: bool = False
    ):
        """Segment ``tissue`` on echo 1 (or the echo RSS) with ``model``.

        Multi-tissue models return a dict keyed by tissue ``STR_ID``; each
        tissue picks up its own channel.
        """
        tissues = list(tissue) if isinstance(tissue, Sequence) else [tissue]
        _logger.info("Segmenting %s...", ", ".join(t.FULL_NAME for t in tissues))

        seg_input = self.calc_rss() if use_rss else self.volumes[0]
        mask = model.generate_mask(seg_input)

        if isinstance(mask, dict):
            for tis in tissues:
                tis.set_mask(mask[tis.STR_ID])
                self.__add_tissue__(tis)
        else:
            (tis,) = tissues
            assert isinstance(tis, Tissue)
            tis.set_mask(mask)
            self.__add_tissue__(tis)
        return mask

    # ------------------------------------------------------------------
    def generate_t2_map(
        self,
        tissue: Tissue = None,
        suppress_fat: bool = False,
        suppress_fluid: bool = False,
        beta: float = 1.2,
        gl_area: float = None,
        tg: float = None,
        tr: float = None,
        te: float = None,
        alpha: float = None,
        diffusivity: float = 1.25e-9,
        t1: float = None,
        nan_bounds: Tuple[float, float] = (0, 100),
        nan_to_num: float = 0.0,
        decimals: int = 1,
    ) -> qv.T2:
        """Analytic T2 map from the two qDESS echoes.

        Every acquisition parameter left as ``None`` is resolved from the
        reference DICOM header (TR, TE, FlipAngle, and the GE private spoiler
        tags); ``t1`` falls back to ``tissue.T1_EXPECTED``. Values passed
        explicitly always win.
        """
        from dosma_tpu_torch.ops.qmri import qdess_t2_map

        if self.volumes is None:
            raise ValueError("volumes and ref_dicom fields must be initialized")
        if None in (
            self.get_metadata(self.__GL_AREA_TAG__, gl_area),
            self.get_metadata(self.__TG_TAG__, tg),
        ):
            raise ValueError(
                "Dicom headers do not contain tags for `gl_area` and `tg`. Please input manually"
            )

        def header(key, override):
            if override is not None:
                return float(override)
            # get_metadata honors set_metadata overrides BEFORE falling back
            # to the reference DICOM — the guard above accepts values stored
            # via set_metadata, so resolution must see them too.
            value = self.get_metadata(key, default=False)
            return float(value)

        tr_ms = header("RepetitionTime", tr)
        te_ms = header("EchoTime", te)
        alpha_deg = header("FlipAngle", alpha)
        tg_us = header(self.__TG_TAG__, tg)
        gl = header(self.__GL_AREA_TAG__, gl_area)
        t1_ms = float(tissue.T1_EXPECTED) if t1 is None else float(t1)

        if np.allclose(math.sin(math.radians(alpha_deg) / 2), 0):
            warnings.warn("sin(flip angle) is close to 0 - t2 map may fail.")

        # Card echoes give a card map; host echoes are computed on the
        # default device and give a host map (the input's device class).
        echo_1, echo_2 = (v.volume for v in self.volumes)
        t2map = qdess_t2_map(
            echo_1,
            echo_2,
            tr=tr_ms,
            te=te_ms,
            tg=tg_us,
            alpha=alpha_deg,
            gl_area=gl,
            t1=t1_ms,
            diffusivity=diffusivity,
            beta=beta,
            nan_bounds=nan_bounds,
            nan_to_num=nan_to_num,
            decimals=decimals,
            suppress_fat=suppress_fat,
            suppress_fluid=suppress_fluid,
        )
        t2_qv = qv.T2(self.volumes[0]._partial_clone(volume=t2map, headers=True))
        if tissue is not None:
            tissue.add_quantitative_value(t2_qv)
        return t2_qv

    # ------------------------------------------------------------------
    def calc_rss(self) -> MedicalVolume:
        """Root-sum-of-squares combination of the two echoes, float32."""
        return self._combine_echoes("rss")

    def _combine_echoes(self, method: str = "rss") -> MedicalVolume:
        from dosma_tpu_torch.ops.qmri import rms_combine, rss_combine

        if self.volumes is None:
            raise ValueError("Volumes must be initialized")
        assert len(self.volumes) == self.__NUM_ECHOS__, "2 Echos expected"

        combiners = {"rss": rss_combine, "rms": rms_combine}
        if method not in combiners:
            raise ValueError(f"`method={method}` is not supported")
        # Tensors combine where they lie; numpy echoes are computed on the
        # default device and come back as numpy.
        vol = combiners[method](*(v.volume for v in self.volumes))
        return self.volumes[0]._partial_clone(volume=vol, headers=True)

    # ------------------------------------------------------------------
    def _save(self, metadata, save_dir, fname_fmt=None, **kwargs):
        fmt = {MedicalVolume: "echo-{}", **(fname_fmt or {})}
        return super()._save(metadata, save_dir, fname_fmt=fmt, **kwargs)

    @classmethod
    def cmd_line_actions(cls):
        """CLI action metadata."""
        segment_action = ActionWrapper(
            name=cls.segment.__name__,
            help="generate automatic segmentation",
            param_help={"use_rss": "segment on the root-sum-of-squares of both echoes"},
            alternative_param_names={"use_rss": ["rss"]},
        )
        t2_action = ActionWrapper(
            name=cls.generate_t2_map.__name__,
            aliases=["t2"],
            param_help={
                "suppress_fat": "zero out low-SNR fat regions (echo-1 threshold)",
                "suppress_fluid": "zero out fluid regions (S1 - beta*S2 nulling)",
                "beta": "fluid-nulling weight for S1 - beta*S2",
                "gl_area": "spoiler gradient area; default read from tag 0x001910b6",
                "tg": "spoiler gradient time in microseconds; default read from tag 0x001910b7",
                "alpha": "flip angle in degrees; default read from tag 0x00181314",
                "diffusivity": "assumed tissue diffusivity (m^2/s), default 1.25e-9",
            },
            help="generate T2 map",
        )
        return [(cls.segment, segment_action), (cls.generate_t2_map, t2_action)]
