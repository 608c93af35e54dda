"""Request kind ``fit``: ``MonoExponentialFit.fit`` of one scan's echoes to a
T2 map, then ``T2.metric_rows`` of the map on the scan's label mask, the
rows on the host.

``residency: card`` keeps the echoes of a pool of scans on the card, as
after ``load_to_device``; ``residency: host`` keeps them in pageable host
arrays, as a DICOM read gives them, and the maps come back to the host as
the API returns them. A request takes the pool's scans in turn.
"""

from __future__ import annotations

import numpy as np
import torch

from qmri_bench import recipes
from qmri_bench.compare import as_flat64, map_numbers, merge, rows_gap
from qmri_bench.counts import monoexp_fit_work
from qmri_bench.reference.monoexp import relaxation_maps
from qmri_bench.reference.rows import region_rows

# Precision a step below the configuration's: float32 -> bfloat16, float64 -> float32.
LOWER = {"float32": torch.bfloat16, "float64": torch.float32}


class Workload:
    def __init__(self, cfg, traffic, seed, device):
        import dosma_tpu_torch as dt

        self.dt = dt
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.host = traffic["residency"] == "host"
        self.affine = recipes.sagittal_affine(cfg["spacing_mm"])
        self.labels = {int(k): v for k, v in cfg["labels"].items()}
        self.x = [float(t) for t in self.times()]
        self.shape = tuple(cfg["shape"])
        self.voxels = int(np.prod(self.shape))
        self.work = monoexp_fit_work(self.voxels, len(self.x))
        self.iterations = None
        self.kept = []

    def times(self):
        return self.cfg["echo_times_ms"]

    def make_pool(self, gen):
        return [recipes.config1_scan(self.cfg, gen, self.device)
                for _ in range(int(self.traffic["pool"]))]

    def make_mask(self):
        return recipes.config1_labels(self.cfg, self.device)

    def setup(self):
        dt = self.dt
        gen = recipes.generator(self.seed, self.device)
        pool = self.make_pool(gen)
        mask = self.make_mask()
        if self.host:
            self.scans = [[dt.MedicalVolume(v.cpu().numpy(), self.affine) for v in p] for p in pool]
            self.mask = dt.MedicalVolume(mask.cpu().numpy(), self.affine)
            del pool
        else:
            self.scans = [[dt.MedicalVolume(v, self.affine) for v in p] for p in pool]
            self.mask = dt.MedicalVolume(mask, self.affine)
        self.fitter = dt.MonoExponentialFit(
            bounds=tuple(self.cfg["fit"]["bounds"]), tc0=self.cfg["fit"]["tc0"],
            r2_threshold=self.cfg["fit"]["r2_threshold"],
            decimal_precision=self.cfg["fit"]["decimal_precision"])

    def request(self, k, spans):
        ys = self.scans[k % len(self.scans)]
        with spans("fit_call"):
            tc, r2 = self.fitter.fit(self.x, ys, mask=self.mask)
        with spans("rows"):
            rows = self.dt.T2(tc).metric_rows(self.mask, self.labels)
        return k % len(self.scans), tc.A, r2.A, rows

    def keep(self, out):
        self.kept.append(out)

    def release(self):
        self.fitter = None

    # -------------------------------------------------------------- checks
    def _inputs(self, scan):
        """The scan's echoes (T, N) and the mask (N,) on the device, as made."""
        ys = self.scans[scan]
        yT = torch.stack([torch.as_tensor(v.A).to(self.device).reshape(-1) for v in ys])
        return yT, torch.as_tensor(self.mask.A).to(self.device).reshape(-1)

    def numbers(self, control=False):
        """The worst of each compared number over the kept requests; with
        ``control`` the reference in the next lower precision answers in the
        program's place."""
        fit_cfg, prec = self.cfg["fit"], self.cfg["precision"]
        per, refs = [], {}
        for scan, tc, r2, rows in self.kept:
            yT, mask = self._inputs(scan)
            if scan not in refs:
                refs[scan] = relaxation_maps(self.x, yT, mask, fit_cfg)
            ref_tc, ref_r2 = refs[scan]
            if control:
                tc, r2 = relaxation_maps(self.x, yT, mask, fit_cfg, LOWER[prec["fit"]])
                rows = region_rows(tc, mask, self.labels, LOWER[prec["rows"]])
            tc, r2 = as_flat64(tc, self.device), as_flat64(r2, self.device)
            nums = map_numbers(tc, r2, ref_tc, ref_r2, mask, fit_cfg["decimal_precision"])
            nums["rows_gap"] = rows_gap(rows, tc, mask, self.labels)
            per.append(nums)
        return merge(per)
