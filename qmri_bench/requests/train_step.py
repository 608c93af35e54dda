"""Request kind ``train_step``: one ``SegTrainer.step`` of the
configuration's U-Net on the next batch of a pool of host batches.

Set-up: ``knees`` seeded knees on the card (``segment.knee``), each
whitened over all its voxels, and for each class a seeded smooth mask that
covers a seeded share of every knee (:func:`labels`); a seeded permutation
of the knees' sagittal slices fills ``pool`` host batches of
``batch_slices`` slices, float32 images ``(B, H, W, 1)`` and uint8 labels
``(B, H, W, C)``, made once, as a shuffling data loader with prefetch hands
them to a training loop. The trainer is ``SegTrainer`` on one card (its
1 x 1 mesh) at the configuration's learning rate, from the weights of
``segment.unet_params``. It takes ``origin_steps`` steps on the pool's
last batches, and its state then (parameters, both Adam moments, every
leaf's count) is copied aside as the origin.

A request: on the pool's first batch (``k % pool == 0``) the trainer's
state is set back to the origin, so that every pass over the pool repeats
the same steps and a kept step is one of the ``pool`` steps after the
origin, whatever the rate (float32's gaps grow with the steps a run
takes, and a faster program would take more). Then the state before the
step is copied into card buffers by one foreach copy and the counts read,
``trainer.step(images, labels)`` runs on batch ``k % pool``, and the
step's gradients (every leaf's ``.grad``) and the state after it are
copied by a second foreach copy and the counts read again. The buffers (7
x 4 bytes a parameter, 969 MB at full width) come from a free list and go
back to it once no answer holds them.

The check, once the program's state is freed, for every kept answer
against the plain float64 reference (``reference/unet2d_train.py``) from
the same state and batch, and one float64 Adam step on its gradients:

- ``loss_rel_gap``: the step's returned loss against the reference's, over
  the reference's;
- ``grad_rel_gap``: the whole gradient's gap, every leaf's elements in one
  vector, ``|g - g_ref| / |g_ref|``;
- ``grad_leaf_gap``: the largest of that gap leaf by leaf, which a wrong
  gradient of one small leaf moves by far more than the whole gradient's
  gap. The bottleneck block's gradients are small sums of large terms, so
  float32 misses them by ~1e-3 there; the limit is set against faults;
- ``param_off_share``: the share of parameters whose value after the step
  differs from the reference's step by more than ``PARAM_TOL_ULPS``
  float32 spacings of the reference's value plus ``PARAM_TOL_LR`` times
  the learning rate;
- ``param_leaf_off``: the largest such share in one leaf (a leaf the step
  leaves out reads 1);
- ``moment_rel_gap``: the larger of the two Adam moments' gaps after the
  step, each over every leaf at once, against the reference's moments (a
  state left unchanged reads 1 where the step moves it);
- ``count_gap``: the largest distance of a leaf's count rise from 1.

The control gives the same numbers for the reference in bfloat16 in the
program's place, and under ``<number>.tf32`` for the reference in float32
with TF32 allowed (the program runs under ``cudnn_exact``, which keeps TF32
out): each has to fail at least one limit.
"""

from __future__ import annotations

import math
import weakref

import torch
import torch.nn.functional as F

from qmri_bench import recipes
from qmri_bench.compare import merge
from qmri_bench.counts_train import train_step_work
from qmri_bench.reference import unet2d as net_reference
from qmri_bench.reference import unet2d_train as reference
from qmri_bench.requests.segment import knee, unet_params

# A parameter is off when it is further from the float64 step than 2
# float32 spacings of its value (the step's own rounding is half of one) plus
# a hundredth of the learning rate (Adam moves a parameter by about the
# learning rate, so an update a hundredth off is a gradient element some 3%
# off; a thousandth flags float32's own misses of the smallest gradient
# elements, on up to 1.6% of the parameters in the first steps).
PARAM_TOL_ULPS = 2.0
PARAM_TOL_LR = 1e-2


def labels(cfg, gen: torch.Generator, knee_shape, cover, device) -> torch.Tensor:
    """uint8 masks ``(H, W, S, C)``: class ``c`` a smooth seeded field
    thresholded so that it covers ``cover[c]`` of the voxels."""
    lab = cfg["labels"]
    masks = []
    for share in cover.tolist():
        coarse = torch.rand((1, 1) + tuple(lab["coarse_grid"]), generator=gen, device=device)
        field = F.interpolate(coarse, size=tuple(knee_shape), mode="trilinear",
                              align_corners=True)[0, 0]
        flat = field.reshape(-1).sort().values
        cut = flat[min(flat.numel() - 1, int(round((1.0 - share) * flat.numel())))]
        masks.append((field >= cut).to(torch.uint8))
    return torch.stack(masks, dim=-1)


class _Answer:
    """A request's answer: the batch, the loss, every leaf's Adam count
    before and after the step, and the buffers with the state before the
    step, the step's gradients and the state after it."""

    def __init__(self, batch, loss, counts, bufs):
        self.batch, self.loss, self.counts, self.bufs = batch, loss, counts, bufs


class Workload:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.classes = list(cfg["model"]["classes"])
        self.features = list(cfg["model"]["features"])
        tr = cfg["training"]
        self.batch_slices = int(tr["batch_slices"])
        h, w = (int(v) for v in cfg["shape"][:2])
        self.voxels = self.batch_slices * h * w
        self.work = train_step_work(self.batch_slices, h, w, self.features, len(self.classes))
        self.iterations = None
        self.kept = []
        self._free = []

    def setup(self):
        from dosma_tpu_torch.train import SegTrainer

        cfg, tr, dev = self.cfg, self.cfg["training"], self.device
        gen = recipes.generator(self.seed, dev)
        knees = [knee(cfg, gen, dev) for _ in range(int(self.traffic["knees"]))]
        params = unet_params(cfg, gen, dev)
        n = len(self.classes)
        order = torch.rand(n, generator=gen, device=dev).argsort()
        self.cover = torch.tensor(cfg["labels"]["coverage"], dtype=torch.float64,
                                  device=dev)[order]
        images, masks = [], []
        for k in knees:
            images.append(net_reference.whiten(k, cfg["model"]["whiten_eps"]).float()
                          .permute(2, 0, 1)[..., None])
            masks.append(labels(cfg, gen, k.shape, self.cover, dev).permute(2, 0, 1, 3))
        images, masks = torch.cat(images), torch.cat(masks)
        pick = torch.randperm(images.shape[0], generator=gen, device=dev)
        b = self.batch_slices
        self.batches = [(images[pick[s:s + b]].cpu().numpy(), masks[pick[s:s + b]].cpu().numpy())
                        for s in range(0, b * int(self.traffic["pool"]), b)]
        if any(x.shape[0] != b for x, _ in self.batches):
            raise ValueError(f"{len(knees)} knees give {images.shape[0]} slices, fewer than "
                             f"{self.traffic['pool']} batches of {b}")
        adam, lr = tr["adam"], float(tr["learning_rate"])
        trainer = SegTrainer(learning_rate=lr, num_classes=n, features=self.features,
                             params=params)
        group = trainer.optimizer.param_groups[0]
        if (group["lr"], tuple(group["betas"]), group["eps"]) != (
                lr, (adam["b1"], adam["b2"]), adam["eps"]):
            raise ValueError(f"the trainer's Adam runs {group}, the configuration {adam}")
        self.trainer = trainer
        self.names = list(trainer.params)
        self.leaves = [trainer.params[k] for k in self.names]
        for k in range(int(self.traffic["origin_steps"])):
            trainer.step(*self.batches[-1 - k])
        with torch.no_grad():
            self._origin = [t.clone() for t in self._slots()]
            self._origin_counts = [t.clone() for t in self._counts()]

    def _slots(self):
        """The trainer's parameters, then both Adam moments, in leaf order."""
        state = [self.trainer.optimizer.state[p] for p in self.leaves]
        return (self.leaves + [s["exp_avg"] for s in state]
                + [s["exp_avg_sq"] for s in state])

    def _counts(self):
        return [self.trainer.optimizer.state[p]["step"] for p in self.leaves]

    def _read_counts(self):
        return torch.stack(self._counts()).tolist()

    def _bufs(self):
        if self._free:
            return self._free.pop()
        return [torch.empty_like(p) for _ in range(7) for p in self.leaves]

    def request(self, k, spans):
        leaves, pool = self.leaves, len(self.batches)
        bufs = self._bufs()
        n = len(leaves)
        with torch.no_grad():
            if k % pool == 0:
                torch._foreach_copy_(self._slots(), self._origin)
                torch._foreach_copy_(self._counts(), self._origin_counts)
            torch._foreach_copy_(bufs[:3 * n], self._slots())
        before = self._read_counts()
        loss = self.trainer.step(*self.batches[k % pool])
        with torch.no_grad():
            torch._foreach_copy_(bufs[3 * n:], [p.grad for p in leaves] + self._slots())
        after = self._read_counts()
        out = _Answer(k % pool, loss, (before, after), bufs)
        weakref.finalize(out, self._free.append, bufs)
        return out

    def keep(self, out):
        self.kept.append(out)

    def release(self):
        self.trainer = self.leaves = self._origin = self._origin_counts = None
        self._free.clear()

    # -------------------------------------------------------------- checks
    def _state(self, out):
        """(params, mu, nu) before the step, its grads, and (params, mu, nu)
        after it, each a flat dict."""
        n = len(self.names)
        return [dict(zip(self.names, out.bufs[i * n:(i + 1) * n])) for i in range(7)]

    def _reference(self, params, batch, **kw):
        images, masks = self.batches[batch]
        x = torch.from_numpy(images).to(self.device).permute(0, 3, 1, 2)
        y = torch.from_numpy(masks).to(self.device).permute(0, 3, 1, 2)
        return reference.loss_and_grads(params, x, y, block=int(self.cfg["reference_block_slices"]),
                                        eps=float(self.cfg["training"]["loss_eps"]), **kw)

    def _step(self, before, grads, count):
        tr = self.cfg["training"]
        adam = tr["adam"]
        params, mu, nu = before
        return reference.adam_step(params, grads, mu, nu, count, float(tr["learning_rate"]),
                                   adam["b1"], adam["b2"], adam["eps"])

    def _numbers(self, got, want, counts):
        """The numbers of one step: ``got`` and ``want`` are ``(loss, grads,
        params, mu, nu)`` with the state after the step, ``counts`` every
        leaf's Adam count before and after it."""
        loss, grads, after, mu, nu = got
        want_loss, want_grads, want_after, want_mu, want_nu = want
        lr = float(self.cfg["training"]["learning_rate"])
        off = total = 0
        leaf_off, leaf_gap = 0.0, 0.0
        for k, p_ref in want_after.items():
            tol = PARAM_TOL_ULPS * _spacing32(p_ref) + PARAM_TOL_LR * lr
            diff = (after[k].to(torch.float64) - p_ref).abs()
            n_off = int((~(diff <= tol)).sum())
            off += n_off
            total += p_ref.numel()
            leaf_off = max(leaf_off, n_off / p_ref.numel())
            leaf_gap = max(leaf_gap, _rel_gap({k: grads[k]}, {k: want_grads[k]}))
        before, after_counts = counts
        return {"loss_rel_gap": abs(loss - want_loss) / abs(want_loss) if want_loss else math.inf,
                "grad_rel_gap": _rel_gap(grads, want_grads),
                "grad_leaf_gap": leaf_gap,
                "param_off_share": off / total,
                "param_leaf_off": leaf_off,
                "moment_rel_gap": max(_rel_gap(mu, want_mu), _rel_gap(nu, want_nu)),
                "count_gap": max(abs(a - b - 1.0) for a, b in zip(after_counts, before))}

    def numbers(self, control=False):
        """The worst of each number over the kept requests; with ``control``
        the reference in bfloat16 (and, apart, in float32 with TF32) answers
        in the program's place."""
        per = []
        for out in self.kept:
            params, mu, nu, grads, after, mu_after, nu_after = self._state(out)
            count = out.counts[0][0]
            want_loss, want_grads = self._reference(params, out.batch)
            want = (want_loss, want_grads) + self._step((params, mu, nu), want_grads, count)
            if not control:
                per.append(self._numbers((out.loss, grads, after, mu_after, nu_after), want,
                                         out.counts))
                continue
            row = {}
            for suffix, kw in (("", {"dtype": torch.bfloat16}),
                               (".tf32", {"dtype": torch.float32, "tf32": True})):
                loss, g = self._reference(params, out.batch, **kw)
                got = (loss, g) + self._step((params, mu, nu), g, count)
                nums = self._numbers(got, want, ([count], [count + 1.0]))
                row.update({k + suffix: v for k, v in nums.items()})
            per.append(row)
        return merge(per)


def _rel_gap(got, want) -> float:
    """``|x - x_ref| / |x_ref|`` over every leaf's elements at once (NaN as
    infinite)."""
    gap2 = sum(float(torch.linalg.vector_norm(got[k].to(torch.float64) - g)) ** 2
               for k, g in want.items())
    norm2 = sum(float(torch.linalg.vector_norm(g)) ** 2 for g in want.values())
    rel = math.sqrt(gap2 / norm2) if norm2 > 0 else (0.0 if gap2 == 0 else math.inf)
    return math.inf if math.isnan(rel) else rel


def _spacing32(x: torch.Tensor) -> torch.Tensor:
    """The float32 spacing at each value of ``x`` (float64)."""
    x32 = x.abs().to(torch.float32)
    return (torch.nextafter(x32, torch.full_like(x32, math.inf)) - x32).to(torch.float64)
