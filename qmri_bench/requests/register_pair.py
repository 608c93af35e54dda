"""Request kind ``register_pair``: ``register(spin lock 1, spin lock k,
"parameters-affine.yaml", return_volumes=True, save_volumes=False)`` on
the card, the unit of work ``CubeQuant.intraregister`` repeats for each
later spin lock. k takes the traffic's ``moving_spin_locks`` in turn, and
the pool's series in turn after each round. The transform file goes to a
fixed directory under the temporary directory of the run's environment.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from qmri_bench import recipes
from qmri_bench.compare import merge
from qmri_bench.reference.warp import corner_error_vox, cubic_warp, index_map
from qmri_bench.requests.fit import LOWER


class Workload:
    def __init__(self, cfg, traffic, seed, device):
        import dosma_tpu_torch as dt

        self.dt = dt
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.affine = recipes.sagittal_affine(cfg["spacing_mm"])
        self.shape = tuple(cfg["shape"])
        self.moving = [int(k) for k in traffic["moving_spin_locks"]]
        self.voxels = None
        self.work = None
        self.iterations = int(sum(cfg["registration_iterations"]))
        self.out_dir = os.path.join(tempfile.gettempdir(), "qmri_bench", "register_pair")
        self.kept = []

    def setup(self):
        gen = recipes.generator(self.seed, self.device)
        self.pool = [recipes.cubequant_scan(self.cfg, gen, self.device, self.traffic["rolled"])
                     for _ in range(int(self.traffic["pool"]))]
        self.scans = [[self.dt.MedicalVolume(v, self.affine) for v in p] for p in self.pool]

    def request(self, k, spans):
        scan = (k // len(self.moving)) % len(self.scans)
        lock = self.moving[k % len(self.moving)]
        vols = self.scans[scan]
        with spans("register"):
            outputs, warped = self.dt.register(
                vols[0], vols[lock - 1], self.cfg["registration_parameters"],
                output_path=self.out_dir, return_volumes=True, rtype=tuple,
                save_volumes=False)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            with open(outputs[0].transform[0]) as f:
                matrix = np.asarray(json.load(f)["matrix"], np.float64)
        return scan, lock, matrix, warped[0].A

    def keep(self, out):
        self.kept.append(out)

    def release(self):
        self.scans = None

    def numbers(self, control=False):
        roll = np.asarray(self.cfg["roll_per_spin_lock"], np.float64)
        per = []
        for scan, lock, matrix, warped in self.kept:
            shift = (lock - 1) * roll
            moving = self.pool[scan][lock - 1]
            if control:
                b_roll = np.concatenate([np.eye(3), shift[:, None]], axis=1)
                matrix = self.affine @ np.vstack([b_roll, [0, 0, 0, 1]]) \
                    @ np.linalg.inv(self.affine)
                warped, _ = cubic_warp(moving, b_roll, self.shape,
                                       LOWER[self.cfg["precision"]["warp"]])
            b_map = index_map(matrix, self.affine, self.affine)
            ref, edge = cubic_warp(moving, b_map, self.shape)
            gap = (torch.as_tensor(warped).to(ref.device, torch.float64) - ref).abs()[~edge].max()
            per.append({"warp_gap": float(gap / ref.abs().max()),
                        "shift_error_vox": corner_error_vox(b_map, self.shape, shift)})
        return merge(per)
