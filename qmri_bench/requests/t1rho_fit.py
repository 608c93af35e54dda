"""Request kind ``t1rho_fit``: ``CubeQuant.generate_t1_rho_map(tissue=fc)``
of one registered spin-lock series on the card, the condyle arc as the
femoral cartilage's mask, then ``metric_rows`` of the map on that mask.
The rows and checks are those of the ``fit`` kind.
"""

from __future__ import annotations

import torch

from qmri_bench import recipes
from qmri_bench.requests import fit


class Workload(fit.Workload):
    def times(self):
        return self.cfg["spin_lock_times_ms"]

    def make_pool(self, gen):
        return [recipes.cubequant_scan(self.cfg, gen, self.device, self.traffic["rolled"])
                for _ in range(int(self.traffic["pool"]))]

    def make_mask(self):
        return torch.from_numpy(recipes.condyle_arc(self.shape)).to(self.device)

    def setup(self):
        dt = self.dt
        gen = recipes.generator(self.seed, self.device)
        pool = self.make_pool(gen)
        self.arc = self.make_mask()
        self.scans = [[dt.MedicalVolume(v, self.affine) for v in p] for p in pool]
        self.series = [dt.CubeQuant(vols, spin_lock_times=self.x) for vols in self.scans]
        self.fc = dt.FemoralCartilage()
        self.fc.set_mask(dt.MedicalVolume(self.arc.cpu().numpy(), self.affine))
        self.mask = dt.MedicalVolume(self.arc, self.affine)

    def request(self, k, spans):
        scan = k % len(self.series)
        with spans("fit_call"):
            qv = self.series[scan].generate_t1_rho_map(tissue=self.fc)
        with spans("rows"):
            rows = qv.metric_rows(self.fc.get_mask(), self.labels)
        # A study makes one tissue per knee: drop the map the tissue keeps.
        self.fc.quantitative_values.clear()
        return scan, qv.volumetric_map.A, qv.additional_volumes["r2"].A, rows

    def release(self):
        self.series = None

    def _inputs(self, scan):
        ys = self.scans[scan]
        yT = torch.stack([v.A.reshape(-1) for v in ys])
        return yT, self.arc.reshape(-1)
