"""Request kind ``segment``: ``generate_mask`` of one knee by the
configuration's segmentation model, the category volumes on the host as
the API returns them.

``residency: card`` keeps the pool's knees on the card as ``load_to_device``
leaves a uint16 DICOM series: int32 tensors. A request takes the pool's
knees in turn. The model is built through its public class with
``force_weights=True`` and given seeded weights (``unet_params``), whose
head biases give each class a seeded share of the knee (``fit_head``), so
that every class's mask has voxels on both sides of the threshold.

The check: the kept answers against the plain reference
(``reference/unet2d.py``, float64, TF32 off) of the same knee and weights,
in batches on the card once the program's state is freed.
``mask_off_share`` is the share of voxels, over every class, whose mask
differs from the reference's. The control gives it for the reference in
bfloat16 in the program's place, and under ``mask_off_share.tf32`` for the
reference in float32 with TF32 allowed (the program runs under
``cudnn_exact``, which keeps TF32 out): both have to fail the limit.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from qmri_bench import recipes
from qmri_bench.compare import merge
from qmri_bench.counts_unet import segment_work
from qmri_bench.reference import unet2d as reference

REFERENCE_BATCH = 16


def knee(cfg, gen: torch.Generator, device) -> torch.Tensor:
    """One knee ``(H, W, S)``: a smooth seeded field plus noise, rounded and
    clipped to uint16 intensities, held as int32 (``load_to_device``'s
    widening)."""
    k, shape = cfg["knee"], tuple(cfg["shape"])
    coarse = torch.rand((1, 1) + tuple(k["coarse_grid"]), generator=gen, device=device)
    field = F.interpolate(coarse, size=shape, mode="trilinear", align_corners=True)[0, 0]
    lo, hi = k["field_range"]
    noise = torch.randn(shape, generator=gen, device=device)
    v = lo + (hi - lo) * field + float(k["noise_sigma"]) * noise
    return v.round_().clamp_(*k["clip"]).to(torch.int32)


def unet_params(cfg, gen: torch.Generator, device) -> dict:
    """Weights in the Keras layouts (``{"down", "up", "final"}``; HWIO
    kernels, transpose kernels ``(kh, kw, out, in)``): He-normal kernels,
    zero biases and BatchNorm statistics drawn as the configuration says."""
    w, features = cfg["weights"], list(cfg["model"]["features"])
    classes = len(cfg["model"]["classes"])

    def conv(kh, cin, cout, transpose=False):
        k = torch.randn((kh, kh, cin, cout), generator=gen, device=device)
        k *= math.sqrt(2.0 / (kh * kh * cin))
        k = k.permute(0, 1, 3, 2).contiguous() if transpose else k
        return {"w": k, "b": torch.full((cout,), float(w["biases"]), device=device)}

    def uniform(f, lo_hi):
        lo, hi = lo_hi
        return torch.rand(f, generator=gen, device=device) * (hi - lo) + lo

    def bn(f):
        return {"gamma": uniform(f, w["bn_gamma_uniform"]),
                "beta": torch.randn(f, generator=gen, device=device) * w["bn_beta_std"],
                "mean": torch.randn(f, generator=gen, device=device) * w["bn_mean_std"],
                "var": uniform(f, w["bn_var_uniform"])}

    params = {"down": [], "up": [None] * (len(features) - 1), "final": None}
    cin = 1
    for f in features:
        params["down"].append({"conv1": conv(3, cin, f), "conv2": conv(3, f, f), "bn": bn(f)})
        cin = f
    for d in range(len(features) - 2, -1, -1):
        f = features[d]
        params["up"][d] = {"convT": conv(3, features[d + 1], f, transpose=True),
                           "conv1": conv(3, 2 * f, f), "conv2": conv(3, f, f), "bn": bn(f)}
    params["final"] = conv(1, features[0], classes)
    return params


def fit_head(cfg, params: dict, knees, gen: torch.Generator) -> torch.Tensor:
    """Set the head's biases so that class ``c`` covers about ``cover[c]`` of
    the knees, and return ``cover``: a seeded order of ``head_coverage``,
    each moved by U(-jitter, jitter). A bias is minus the ``1 - cover[c]``
    quantile of the class's head outputs (the reference, float64) on
    ``head_slices`` seeded slices of each knee. He-normal kernels on BatchNorm
    statistics drawn give outputs far from 0, so without it a class would
    cover all of the knee or none of it."""
    w, m = cfg["weights"], cfg["model"]
    device = knees[0].device
    n = len(w["head_coverage"])
    order = torch.rand(n, generator=gen, device=device).argsort()
    jitter = 2 * torch.rand(n, generator=gen, device=device) - 1
    jitter *= float(w["head_coverage_jitter"])
    cover = torch.tensor(w["head_coverage"], dtype=torch.float64, device=device)[order] + jitter
    p = reference.prepare(params, device)
    outs = []
    with torch.no_grad(), reference.precision():
        for k in knees:
            pick = torch.rand(k.shape[2], generator=gen, device=device).argsort()
            x = reference.whiten(k, m["whiten_eps"]).permute(2, 0, 1)[pick[: int(w["head_slices"])]]
            for s in range(0, x.shape[0], REFERENCE_BATCH):
                out = reference.logits(p, x[s : s + REFERENCE_BATCH, None])
                outs.append(out.permute(1, 0, 2, 3).reshape(n, -1))
    out = torch.cat(outs, dim=1)
    q = torch.stack([torch.quantile(out[c], 1 - cover[c]) for c in range(n)])
    head = params["final"]["b"]
    head.copy_((head.double() - q).to(head.dtype))
    return cover


class Workload:
    def __init__(self, cfg, traffic, seed, device):
        import dosma_tpu_torch as dt

        self.dt = dt
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.affine = recipes.sagittal_affine(cfg["spacing_mm"])
        self.shape = tuple(cfg["shape"])
        self.classes = list(cfg["model"]["classes"])
        self.voxels = int(np.prod(self.shape))
        self.work = segment_work(self.shape, cfg["model"]["features"], len(self.classes))
        self.iterations = None
        self.kept = []

    def setup(self):
        dt, m = self.dt, self.cfg["model"]
        gen = recipes.generator(self.seed, self.device)
        self.knees = [knee(self.cfg, gen, self.device) for _ in range(int(self.traffic["pool"]))]
        self.params = unet_params(self.cfg, gen, self.device)
        self.cover = fit_head(self.cfg, self.params, self.knees, gen)
        self.vols = [dt.MedicalVolume(k, self.affine) for k in self.knees]
        model = getattr(dt.models, m["class"])(self.shape[:2] + (1,), None, force_weights=True)
        if model.seg_model.precision != self.cfg["precision"]["forward"]:
            raise ValueError(f"the model runs {model.seg_model.precision}, the configuration "
                             f"{self.cfg['precision']['forward']}")
        model.seg_model.params = self.params
        model.batch_size = int(m["batch_size"])
        self.model = model

    def request(self, k, spans):
        scan = k % len(self.vols)
        masks = self.model.generate_mask(self.vols[scan])
        return scan, {c: masks[c].A for c in self.classes}

    def keep(self, out):
        self.kept.append(out)

    def release(self):
        self.model = None

    # -------------------------------------------------------------- checks
    def _segment(self, scan, **kw):
        """The reference's masks ``(H, W, S, C)`` of knee ``scan`` on the card."""
        m = self.cfg["model"]
        return reference.segment(self.params, self.knees[scan], m["whiten_eps"],
                                 threshold=float(m["threshold"]), batch_size=REFERENCE_BATCH,
                                 **kw).permute(1, 2, 0, 3)

    def numbers(self, control=False):
        """The worst ``mask_off_share`` over the kept requests; with
        ``control`` the reference in bfloat16 (and, apart, in float32 with
        TF32) answers in the program's place."""
        refs, lower, per = {}, {}, []
        for scan, masks in self.kept:
            if scan not in refs:
                refs[scan] = self._segment(scan)
            want = refs[scan]
            if control:
                if scan not in lower:
                    lower[scan] = (self._segment(scan, dtype=torch.bfloat16),
                                   self._segment(scan, dtype=torch.float32, tf32=True))
                bf16, tf32 = lower[scan]
                per.append({"mask_off_share": _off_share(bf16, want),
                            "mask_off_share.tf32": _off_share(tf32, want)})
                continue
            got = torch.from_numpy(np.stack([masks[c] for c in self.classes], axis=-1))
            per.append({"mask_off_share": _off_share(got.to(self.device), want)})
        return merge(per)


def _off_share(got: torch.Tensor, want: torch.Tensor) -> float:
    """Share of the voxels and classes whose masks differ; every voxel where
    the shapes differ."""
    if got.shape != want.shape:
        return 1.0
    return float((got != want).double().mean())
