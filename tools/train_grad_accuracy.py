#!/usr/bin/env python3
"""How close the U-Net trainer's float32 gradients on a CUDA card come to
float64 on the CPU, leaf by leaf, under each convolution backend.

Usage, from the repository root on a machine with one CUDA card:

    python3 tools/train_grad_accuracy.py [--top 8]

On ``chip_smoke.py`` phase 14's inputs (the full-width U-Net, He-normal
parameters from ``RandomState(0)``, one whitened 384x384 knee slice and the
condyle arc's labels) it takes the loss's gradient once in float64 on the
CPU, then in float32 on the CPU and on the card under: ``cudnn_exact``
(the trainer's: deterministic algorithms, no TF32), cuDNN's default
algorithms (TF32 off), and cuDNN switched off (PyTorch's own
convolutions). For each it prints the worst leaves by ``|g32 - g64| /
|g64|`` and the card's name and power limit. It imports nothing of JAX.
"""

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as C  # noqa: E402


def leaf_errors(g, ref):
    """{leaf path: |g - ref| / |ref|} over the nested dicts."""
    out = {}
    for (path, a), (_p, b) in zip(C.leaf_items(g), C.leaf_items(ref), strict=True):
        out[path] = float(np.linalg.norm(a.astype(np.float64) - b)
                          / max(np.linalg.norm(b), 1e-300))
    return out


def gradients(state, x, y):
    from dosma_tpu_torch.models.weights import params_from_state_dict
    from dosma_tpu_torch.train.seg_trainer import dice_bce_loss, unet_train_forward

    p = {k: v.detach().clone().requires_grad_(True) for k, v in state.items()}
    dice_bce_loss(unet_train_forward(p, x), y).backward()
    return params_from_state_dict({k: v.grad for k, v in p.items()})


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--top", type=int, default=8)
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_grad_accuracy: a CUDA card is required", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    from dosma_tpu_torch.models.unet2d import FEATURES, cudnn_exact
    from dosma_tpu_torch.models.weights import state_dict_from_params

    torch.backends.cuda.matmul.allow_tf32 = False
    images, labels = C.knee_training_batch()
    state = dict(state_dict_from_params(C.he_normal_unet_params(np.random.RandomState(0), 1,
                                                                FEATURES)))
    x = torch.from_numpy(images[:1]).permute(0, 3, 1, 2)
    y = torch.from_numpy(labels[:1]).permute(0, 3, 1, 2)
    g64 = gradients({k: v.double() for k, v in state.items()}, x.double(), y.double())

    @contextlib.contextmanager
    def cudnn(enabled, deterministic):
        cd = torch.backends.cudnn
        prev = cd.enabled, cd.deterministic, cd.allow_tf32
        cd.enabled, cd.deterministic, cd.allow_tf32 = enabled, deterministic, False
        try:
            yield
        finally:
            cd.enabled, cd.deterministic, cd.allow_tf32 = prev

    dev = torch.device("cuda", 0)
    on_card = {k: v.to(dev) for k, v in state.items()}
    backends = {"cudnn_exact (deterministic, no TF32)": cudnn_exact,
                "cuDNN default algorithms (no TF32)": lambda: cudnn(True, False),
                "cuDNN off (PyTorch's convolutions)": lambda: cudnn(False, False)}
    print(card)
    runs = {"float32 on the CPU": lambda: gradients(state, x, y)}
    for name, scope in backends.items():
        def on(scope=scope):
            with scope():
                return gradients(on_card, x.to(dev), y.to(dev))
        runs[name] = on
    for name, run in runs.items():
        g = run()
        errs = sorted(leaf_errors(g, g64).items(), key=lambda kv: -kv[1])
        print(f"{name}: worst leaves by |g32 - g64| / |g64|")
        for path, e in errs[:opts.top]:
            print(f"  {e:.4g}  {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
