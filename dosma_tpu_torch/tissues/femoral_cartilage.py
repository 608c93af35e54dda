"""Femoral cartilage analytics (counterpart of
``dosma_tpu/tissues/femoral_cartilage.py``).

Region splitting: sagittal projection, least-squares circle fit, angular
binning of each slice (72 bins of 5°), and region bits across coronal
(anterior/central/posterior at θ = -105°/-75°), sagittal (medial/lateral at
the center-of-mass slice) and axial (deep/superficial at a radial threshold
of each (bin, slice)). The geometry runs in numpy on the host, on the
mask's index lists, so the bits match ``dosma_tpu`` exactly; the map is
gathered at the mask's voxels on its own device
(:func:`dosma_tpu_torch.ops.analytics.compressed_values`), and only those
values cross to the host, never the full map.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from dosma_tpu_torch.core.io.format_io import ImageDataFormat
from dosma_tpu_torch.core.med_volume import MedicalVolume
from dosma_tpu_torch.core.quant_vals import QuantitativeValueType
from dosma_tpu_torch.defaults import preferences
from dosma_tpu_torch.tissues.tissue import Tissue, largest_cc, unrolled_maps
from dosma_tpu_torch.utils import img_utils
from dosma_tpu_torch.utils.geometry_utils import cart2pol, circle_fit

__all__ = ["FemoralCartilage"]

# Visualization vmax bounds in milliseconds (ref ``femoral_cartilage.py:20-24``).
BOUNDS = {
    QuantitativeValueType.T2: 80.0,
    QuantitativeValueType.T1_RHO: 100.0,
    QuantitativeValueType.T2_STAR: 80.0,
}


class FemoralCartilage(Tissue):
    """Femoral cartilage: region splitting, unrolling, and per-region metrics."""

    ID = 1
    STR_ID = "fc"
    FULL_NAME = "femoral cartilage"
    T1_EXPECTED = 1200  # ms
    _PREFETCH_FULL_MAP = False  # compressed analytics: masked gather on device

    # Region bit keys (ref ``femoral_cartilage.py:53-67``).
    _POSTERIOR_KEY = 2**0
    _CENTRAL_KEY = 2**1
    _ANTERIOR_KEY = 2**2
    _CORONAL_KEYS = [_POSTERIOR_KEY, _CENTRAL_KEY, _ANTERIOR_KEY]

    _MEDIAL_KEY = 2**3
    _LATERAL_KEY = 2**4
    _SAGITTAL_KEYS = [_MEDIAL_KEY, _LATERAL_KEY]

    _DEEP_KEY = 2**5
    _SUPERFICIAL_KEY = 2**6
    _TOTAL_AXIAL_KEY = 2**7
    _AXIAL_KEYS = [_DEEP_KEY, _SUPERFICIAL_KEY, _TOTAL_AXIAL_KEY]

    _AXIAL_NAMES = ["deep", "superficial", "total"]
    _SAGITTAL_NAMES = ["medial", "lateral"]
    _CORONAL_NAMES = ["posterior", "central", "anterior"]

    ML_BOUNDARY = None
    ACP_BOUNDARY = None

    def __init__(self, weights_dir=None, medial_to_lateral=None):
        super().__init__(weights_dir=weights_dir)
        self.regions_mask = None
        self.theta_bins = None
        self.medial_to_lateral = medial_to_lateral

    # ------------------------------------------------------------------
    def _region_tables(
        self,
        mask_vol,
        base_vals=None,
        nz=None,
        thickness_divisor=0.5,
        num_bins=72,
        theta=(-270, 90),
    ):
        """Compressed region geometry shared by :meth:`split_regions` and
        ``__calc_quant_vals__``.

        All heavy work runs on the compressed mask-voxel index lists
        (``nz = nonzero(mask)``) — no full-volume temporaries. ``base_vals``
        are the RAW base-map values gathered at ``nz`` (``None`` when the
        base map IS the mask, i.e. the eager set_mask split); a voxel is
        *valid* when ``base_vals > 0`` (NaN excluded), matching the
        reference's ``mask * nan_to_num(base) > 0`` product form
        (ref ``femoral_cartilage.py:100-137``).
        """
        dtheta = 360 / num_bins
        theta_min, theta_max = tuple(theta)
        height, width, num_slices = mask_vol.shape

        if nz is None:
            nz = np.nonzero(mask_vol)
        my, mx, mz = nz
        mask_vals = mask_vol[my, mx, mz].astype(np.float64)
        if base_vals is None:
            keep = np.ones(len(my), dtype=bool)
        else:
            with np.errstate(invalid="ignore"):
                keep = base_vals > 0  # NaN > 0 is False, matching nan_to_num
        iy, ix, iz = my[keep], mx[keep], mz[keep]

        # STEP 1: sagittal any-projection + circle fit. The projected pixel
        # set is the unique (row, col) pairs among valid voxels, in the same
        # row-major order np.nonzero(valid.any(2)) produces.
        pix = np.unique(iy.astype(np.int64) * width + ix)
        if len(pix) < 3:
            raise ValueError(
                f"Mask for {self.FULL_NAME} has too few voxels ({len(pix)} projected "
                f"points) to fit the condyle circle."
            )
        xc_fit, yc_fit, _R = circle_fit(pix % width, pix // width)

        # STEP 2: angular binning (2D grids only — f32 to halve traffic).
        yv, xv = np.meshgrid(
            np.arange(height, dtype=np.float32),
            np.arange(width, dtype=np.float32),
            indexing="ij",
        )
        rho, th = cart2pol(xv - np.float32(xc_fit), np.float32(yc_fit) - yv)
        th = (th >= 90) * (th - 360) + (th < 90) * th  # range [-270, 90)
        assert (np.min(th) >= theta_min) and (np.max(th) < theta_max)
        theta_bins = np.floor((th - theta_min) / dtheta)

        # STEP 3: per-(bin, slice) radial thresholds — vectorized scatter
        # min/max over valid voxels (replaces ref ``:139-152`` loops).
        bins2d = theta_bins.astype(np.int32)
        keys = bins2d[iy, ix] * num_slices + iz.astype(np.int32)
        rho_valid = rho[iy, ix]

        nkeys = num_bins * num_slices
        rho_min = np.full(nkeys, np.inf, dtype=np.float32)
        rho_max = np.full(nkeys, -np.inf, dtype=np.float32)
        np.minimum.at(rho_min, keys, rho_valid)
        np.maximum.at(rho_max, keys, rho_valid)
        has_any = np.isfinite(rho_min)
        thresholds = np.zeros(nkeys, dtype=np.float32)
        thresholds[has_any] = (
            np.float32(thickness_divisor) * (rho_max[has_any] - rho_min[has_any])
            + rho_min[has_any]
        )

        # medial/lateral at center-of-mass slice, honoring scan direction.
        # Slice-wise weighted sum == scipy.ndimage.center_of_mass(mask *
        # nan_to_num(base_map))[-1] (same formula, f64 accumulation).
        if base_vals is None:
            weights = mask_vals**2
        else:
            weights = mask_vals[keep] * base_vals[keep]
        slice_sums = np.bincount(iz, weights=weights, minlength=num_slices)
        com_slicewise = float(
            (slice_sums * np.arange(num_slices)).sum() / slice_sums.sum()
        )
        boundary = int(np.ceil(com_slicewise))

        acp_boundary = [
            int(np.floor((-105 - theta_min) / dtheta)),
            int(np.floor((-75 - theta_min) / dtheta)),
        ]
        return {
            "nz": nz,
            "mask_vals": mask_vals,
            "keep": keep,
            "idx": (iy, ix, iz),
            "rho": rho,
            "th": th,
            "theta_bins": theta_bins,
            "bins2d": bins2d,
            "keys": keys,
            "thresholds": thresholds,
            "num_bins": num_bins,
            "num_slices": num_slices,
            "boundary": boundary,
            "acp_boundary": acp_boundary,
        }

    def _ml_key_row(self, boundary, num_slices):
        ml_row = np.empty(num_slices, dtype=np.uint16)
        if self.medial_to_lateral:
            ml_row[:boundary] = self._MEDIAL_KEY
            ml_row[boundary:] = self._LATERAL_KEY
        else:
            ml_row[:boundary] = self._LATERAL_KEY
            ml_row[boundary:] = self._MEDIAL_KEY
        return ml_row

    def split_regions(self, base_map, thickness_divisor=0.5, num_bins=72, theta=(-270, 90)):
        """Split mask into 3x2x3 anatomical regions (ref ``:86-194``)."""
        mask_vol = np.asarray(self.__mask__.volume)
        base = np.asarray(base_map)
        num_slices = mask_vol.shape[-1]
        if base is mask_vol:
            base_vals = None
            nz = np.nonzero(mask_vol)
        else:
            nz = np.nonzero(mask_vol)
            base_vals = base[nz].astype(np.float64)
        t = self._region_tables(
            mask_vol,
            base_vals=base_vals,
            nz=nz,
            thickness_divisor=thickness_divisor,
            num_bins=num_bins,
            theta=theta,
        )

        # Full-volume region bitmask assembly (only needed by callers that
        # want the dense volume — the analytics path stays compressed).
        th, rho = t["th"], t["rho"]
        acp_map = (
            self._ANTERIOR_KEY * (th < -105)
            + self._CENTRAL_KEY * np.logical_and(th >= -105, th < -75)
            + self._POSTERIOR_KEY * (th >= -75)
        ).astype(np.uint16)
        ml_row = self._ml_key_row(t["boundary"], num_slices)
        rhos_threshold_volume = t["thresholds"].reshape(num_bins, num_slices)[t["bins2d"]]

        # deep/superficial at the radial threshold (note: both bits set on
        # the threshold surface itself — reference parity). Assembled in
        # uint16 end to end; the only 3D comparisons are f32 vs f32.
        rho_col = rho[:, :, None]
        regions_volume = acp_map[:, :, None] + ml_row[None, None, :]
        deep_bits = (rho_col <= rhos_threshold_volume).astype(np.uint16)
        deep_bits <<= 5  # _DEEP_KEY
        regions_volume += deep_bits
        sup_bits = (rho_col >= rhos_threshold_volume).astype(np.uint16)
        sup_bits <<= 6  # _SUPERFICIAL_KEY
        regions_volume += sup_bits
        regions_volume += np.uint16(self._TOTAL_AXIAL_KEY)

        return regions_volume, t["theta_bins"], t["boundary"], t["acp_boundary"]

    def _region_bits_compressed(self, t):
        """Region bitmask at the kept (valid) voxels only — same bits the
        dense ``split_regions`` volume holds at those indices."""
        iy, ix, iz = t["idx"]
        th_sel = t["th"][iy, ix]
        rho_sel = t["rho"][iy, ix]
        thr_sel = t["thresholds"][t["keys"]]

        rm = np.where(
            th_sel < -105,
            np.uint16(self._ANTERIOR_KEY),
            np.where(
                th_sel < -75, np.uint16(self._CENTRAL_KEY), np.uint16(self._POSTERIOR_KEY)
            ),
        ).astype(np.uint16)
        ml_row = self._ml_key_row(t["boundary"], t["num_slices"])
        rm += ml_row[iz]
        rm += (rho_sel <= thr_sel).astype(np.uint16) << 5  # _DEEP_KEY
        rm += (rho_sel >= thr_sel).astype(np.uint16) << 6  # _SUPERFICIAL_KEY
        rm += np.uint16(self._TOTAL_AXIAL_KEY)
        return rm

    # ------------------------------------------------------------------
    def unroll(self, qv_map: np.ndarray, regions_mask: np.ndarray, theta_bins):
        """Unroll 3D qv maps to 2D (θ-bin x slice) total/superficial/deep maps
        (ref ``:196-285``) — vectorized with scatter-add accumulations."""
        # Size by the MAX bin value, not the count of distinct bins: a
        # degenerate circle fit can leave angular bins unpopulated, and
        # indexing raw bin values into a unique-count-sized array would
        # scatter out of bounds.
        num_bins = int(np.max(theta_bins)) + 1
        mask = np.asarray(self.__mask__.volume)

        qv_map = np.asarray(qv_map)
        if qv_map.shape != mask.shape:
            raise ValueError("t2_map and mask must have same shape")
        if len(qv_map.shape) != 3:
            raise ValueError("t2_map and mask must be 3D")

        num_slices = qv_map.shape[-1]

        # Extract the masked voxels once and do everything downstream on
        # the compressed arrays: the only full-volume pass left is the
        # uint8 nonzero. Equivalent to the dense formulation
        # ``where(nan_to_num(qv)*mask <= 0, nan, ...)`` — nan/≤0 voxels
        # are dropped rather than carried as NaN lanes.
        my, mx, mz = np.nonzero(mask)
        vals = np.nan_to_num(qv_map[my, mx, mz]) * mask[my, mx, mz]
        keep = vals > 0
        iy, ix, iz = my[keep], mx[keep], mz[keep]
        vq_sel = vals[keep]
        keys_sel = theta_bins.astype(np.int64)[iy, ix] * num_slices + iz
        rm_sel = regions_mask[iy, ix, iz]
        return self._unroll_tables(torch.from_numpy(vq_sel.astype(np.float64)),
                                   torch.from_numpy(keys_sel),
                                   torch.from_numpy(rm_sel.astype(np.int32)),
                                   num_bins, num_slices)

    def _unroll_tables(self, vq, keys, rm, num_bins, num_slices):
        """Scatter-mean the compressed values (tensors on any device) into
        (θ-bin x slice) host tables: total, superficial, deep; a bin with no
        value, or a mean of 0, is NaN."""
        from dosma_tpu_torch.ops.analytics import scatter_mean

        nkeys = num_bins * num_slices

        def table(lane):
            out = scatter_mean(keys if lane is None else keys[lane],
                               vq if lane is None else vq[lane], nkeys)
            out[out == 0] = np.nan
            return out.reshape(num_bins, num_slices)

        return (table(None), table((rm & self._SUPERFICIAL_KEY) != 0),
                table((rm & self._DEEP_KEY) != 0))

    # ------------------------------------------------------------------
    def quant_rows(self, quant_map: MedicalVolume, map_type):
        """The 18 regions' (3 axial x 2 sagittal x 3 coronal) rows and the
        deep / superficial / total unrolled maps.

        The map is gathered at the mask's voxels where it lies, and only
        those values (float32) cross to the host, for the region geometry:
        which voxels are valid and the center of mass. The statistics and
        the unrolled tables are float64 reductions on the map's device.
        """
        from dosma_tpu_torch.ops.analytics import compressed_values, summary, volume_tensor

        self._check_quant_map(quant_map, map_type)

        mask = np.asarray(self.__mask__.volume)
        num_slices = mask.shape[-1]
        nz = np.nonzero(mask)
        device = volume_tensor(quant_map.volume).device
        # RAW values (NaN preserved): validity and nan_to_num semantics are
        # applied below exactly as in the reference's product form.
        base_vals = compressed_values(quant_map.volume, nz)

        t = self._region_tables(mask, base_vals=base_vals, nz=nz)
        if self.ML_BOUNDARY is None:
            self.ML_BOUNDARY = t["boundary"]
        if self.ACP_BOUNDARY is None:
            self.ACP_BOUNDARY = t["acp_boundary"]

        keep = t["keep"]
        vq_sel = (t["mask_vals"] * np.nan_to_num(base_vals))[keep]
        rm_sel = self._region_bits_compressed(t)
        vq = torch.from_numpy(vq_sel).to(device)
        rm = torch.from_numpy(rm_sel.astype(np.int32)).to(device)
        # t["keys"] is already bin * num_slices + slice over the kept voxels.
        keys = torch.from_numpy(t["keys"].astype(np.int64)).to(device)

        pd_header = ["Subject", "Location", "Side", "Region", "Mean", "Std", "Median", "# Voxels"]
        pd_list = []
        for axial_ind, axial in enumerate(self._AXIAL_KEYS):
            for sagittal_ind, sagittal in enumerate(self._SAGITTAL_KEYS):
                for coronal_ind, coronal in enumerate(self._CORONAL_KEYS):
                    roi = axial | coronal | sagittal
                    row = summary(vq[(rm & roi) == roi])
                    pd_list.append(
                        [
                            self.pid,
                            self._AXIAL_NAMES[axial_ind],
                            self._SAGITTAL_NAMES[sagittal_ind],
                            self._CORONAL_NAMES[coronal_ind],
                            row["Mean"],
                            row["Std"],
                            row["Median"],
                            row["# Voxels"],
                        ]
                    )

        num_bins_unroll = int(np.max(t["theta_bins"])) + 1
        total, superficial, deep = self._unroll_tables(vq, keys, rm, num_bins_unroll, num_slices)
        maps = unrolled_maps(
            map_type, (("deep", deep), ("superficial", superficial), ("total", total)),
            ylabel="Angle (binned)",
        )
        return pd_header, pd_list, maps

    # ------------------------------------------------------------------
    def set_mask(self, mask: MedicalVolume, use_largest_cc: bool = True, split_regions: bool = True):
        """Set mask with largest-CC cleanup and eager region split (ref ``:406-434``)."""
        mask = mask.cpu()
        if use_largest_cc:
            msk = np.asarray(largest_cc(np.asarray(mask.A)), dtype=np.uint8)
        else:
            msk = np.asarray(mask.A, dtype=np.uint8)
        mask_copy = mask._partial_clone(volume=msk)
        super().set_mask(mask_copy)

        if split_regions:
            try:
                (
                    self.regions_mask,
                    self.theta_bins,
                    self.ML_BOUNDARY,
                    self.ACP_BOUNDARY,
                ) = self.split_regions(np.asarray(self.__mask__.volume))
            except (ValueError, TypeError) as e:
                warnings.warn(
                    f"Region splitting failed for {self.FULL_NAME} mask "
                    f"({e}); regional analytics unavailable until a valid "
                    f"mask is set."
                )
                self.regions_mask = None
                self.theta_bins = None

    # ------------------------------------------------------------------
    def __save_quant_data__(self, dirpath: str):
        """jet maps with per-qv vmax + xlsx export (ref ``:436-501``)."""
        from dosma_tpu_torch.tissues._plot import save_quant_maps_and_tables

        save_quant_maps_and_tables(dirpath, self.quant_vals, BOUNDS)

    def save_data(self, save_dirpath, data_format: ImageDataFormat = None):
        if data_format is None:
            data_format = preferences.image_data_format
        super().save_data(save_dirpath, data_format=data_format)
        save_dirpath = self.__save_dirpath__(save_dirpath)

        if self.regions_mask is None:
            return

        sagittal_region_mask, coronal_region_mask = self.__split_mask__()
        coronal_region_mask = (coronal_region_mask + 1) * 10
        sagittal_region_mask = sagittal_region_mask + 1
        joined_mask = coronal_region_mask + sagittal_region_mask
        labels = [
            "medial posterior", "medial central", "medial anterior",
            "lateral posterior", "lateral central", "lateral anterior",
        ]
        plt_dict = {
            "labels": labels, "xlabel": "Slice", "ylabel": "Angle (binned)",
            "title": "Unrolled Regions",
        }
        try:
            img_utils.write_regions(
                os.path.join(save_dirpath, "region_map"), joined_mask, plt_dict=plt_dict
            )
        except ValueError:
            warnings.warn("Could not write region map figure (region count mismatch).")

    def __binarize_region_mask__(self, region_mask, roi):
        return np.asarray(np.bitwise_and(region_mask, roi) == roi, dtype=bool)

    def __split_mask__(self):
        assert self.ML_BOUNDARY is not None and self.ACP_BOUNDARY is not None

        unrolled_total, _, _ = self.unroll(
            np.asarray(self.__mask__.volume, dtype=np.float32), self.regions_mask, self.theta_bins
        )

        acp_division = np.zeros(unrolled_total.shape)
        ac_threshold, cp_threshold = self.ACP_BOUNDARY
        acp_division[:ac_threshold, :] = self._ANTERIOR_KEY
        acp_division[ac_threshold:cp_threshold, :] = self._CENTRAL_KEY
        acp_division[cp_threshold:, :] = self._POSTERIOR_KEY

        ml_division = np.zeros(unrolled_total.shape)
        if self.medial_to_lateral:
            ml_division[..., : self.ML_BOUNDARY] = self._MEDIAL_KEY
            ml_division[..., self.ML_BOUNDARY :] = self._LATERAL_KEY
        else:
            ml_division[..., : self.ML_BOUNDARY] = self._LATERAL_KEY
            ml_division[..., self.ML_BOUNDARY :] = self._MEDIAL_KEY

        acp_division[np.isnan(unrolled_total)] = np.nan
        ml_division[np.isnan(unrolled_total)] = np.nan
        return acp_division, ml_division
