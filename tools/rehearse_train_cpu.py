#!/usr/bin/env python3
"""``chip_smoke.py`` phase 14's trainer on the CPU at small slices: what a
learning rate does to the first losses, and how close float32 gradients
come to float64.

Usage, from the repository root (no card needed):

    python3 tools/rehearse_train_cpu.py [--size 96] [--lrs 1e-3 1e-4]

The full-width U-Net (He-normal parameters from ``RandomState(0)``) takes 5
steps on phase 14's batch recipe (8 whitened slices of the knee, the
condyle arc's labels) cut to ``--size`` x ``--size``, once a learning
rate; then one slice's float32 gradients (``SegTrainer.loss_and_grads``)
are held against float64 leaf by leaf. It imports nothing of JAX.
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=96)
    parser.add_argument("--lrs", type=float, nargs="+", default=[1e-3, 1e-4])
    opts = parser.parse_args(argv)

    import dosma_tpu_torch as dt
    from dosma_tpu_torch.models.unet2d import FEATURES
    from dosma_tpu_torch.models.weights import params_from_state_dict, state_dict_from_params
    from dosma_tpu_torch.train import SegTrainer
    from dosma_tpu_torch.train.seg_trainer import dice_bce_loss, unet_train_forward

    dt.set_default_device("cpu")
    C.KNEE_SHAPE = (opts.size, opts.size, 24)
    C.TRAIN_SLICES = slice(4, 4 + C.TRAIN_BATCH)
    images, labels = C.knee_training_batch()
    params = C.he_normal_unet_params(np.random.RandomState(0), 1, FEATURES)
    for lr in opts.lrs:
        trainer = SegTrainer(params=params, learning_rate=lr)
        losses = [trainer.step(images, labels) for _ in range(C.TRAIN_STEPS)]
        print(f"lr {lr:g} at {opts.size}x{opts.size}: losses {[round(v, 4) for v in losses]}")

    _loss, g32 = SegTrainer(params=params).loss_and_grads(images[:1], labels[:1])
    p = {k: v.double().requires_grad_(True) for k, v in state_dict_from_params(params).items()}
    x = torch.from_numpy(images[:1]).permute(0, 3, 1, 2).double()
    y = torch.from_numpy(labels[:1]).permute(0, 3, 1, 2).double()
    dice_bce_loss(unet_train_forward(p, x), y).backward()
    g64 = params_from_state_dict({k: v.grad for k, v in p.items()})
    worst = max((float(np.linalg.norm(a.astype(np.float64) - b) / max(np.linalg.norm(b), 1e-300)),
                 path) for (path, a), (_p, b) in zip(C.leaf_items(g32), C.leaf_items(g64)))
    print(f"float32 gradients against float64 at {opts.size}x{opts.size}, one slice: worst "
          f"{worst[0]:.4g} at {worst[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
