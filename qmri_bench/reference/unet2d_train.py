"""Plain training step of the 2D U-Net of ``reference/unet2d.py``: the loss,
its gradients and one Adam step, the reference of the ``train_step``
request kind.

- Parameters: a flat dict under the names of the U-Net's state dict
  (``down.{d}.conv1.weight``, ``up.{d}.convT.bias``, ``down.{d}.bn.var``,
  ``final.weight``, ...) in PyTorch's layouts, a convolution's kernel
  ``(out, in, kh, kw)`` and a transpose convolution's ``(in, out, kh, kw)``.
  :func:`nested` views them in the Keras layouts that ``unet2d.logits``
  reads (both kernels permuted ``(2, 3, 1, 0)``), so the gradients come
  back in PyTorch's layouts.
- Forward: ``unet2d.logits`` and a sigmoid. Every leaf is trained, the
  BatchNorm statistics included: BatchNorm normalises by its stored
  ``mean`` and ``var`` leaves, as in inference, and not by the batch's
  statistics as Keras' training mode does.
- Loss: Dice + BCE over the whole batch, from five sums of the
  probabilities clamped to ``[eps, 1 - eps]`` (eps 1e-6): the BCE terms
  ``l log p + (1 - l) log(1 - p)``, ``p l``, ``p``, ``l`` and the element
  count; BCE is minus the mean term, Dice ``1 - (2 sum(p l) + eps) /
  (sum(p) + sum(l) + eps)``.
- Gradients by autograd, in blocks of slices so that a batch fits on the
  card: one pass without gradients gives the whole batch's five sums, then
  each block's forward and backward takes the sums' weighted sum, weighted
  by the loss's derivatives at the whole batch's sums. That is exact: the
  loss depends on the batch only through those sums.
- Adam as ``optax.adam``: ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2)
  g^2``, the count plus one, then ``p - lr (m / (1 - b1^count)) /
  (sqrt(v / (1 - b2^count)) + eps)``, eps outside the square root.

float64 with TF32 off by default; a lower ``dtype`` (and ``tf32=True``)
gives the controls that the check's limits have to fail. Imports nothing of
the program under test.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from qmri_bench.reference.unet2d import logits, precision

__all__ = ["LOSS_EPS", "nested", "batch_sums", "loss_of_sums", "loss_and_grads", "adam_step"]

LOSS_EPS = 1e-6


def nested(flat: Dict[str, torch.Tensor]) -> Dict:
    """The parameter dict that ``unet2d.logits`` reads, as views of the flat
    state-dict leaves ``flat``."""
    def leaf(name):
        t = flat[name]
        return t.permute(2, 3, 1, 0) if t.dim() == 4 else t

    def conv(prefix):
        return {"w": leaf(f"{prefix}.weight"), "b": leaf(f"{prefix}.bias")}

    def block(prefix):
        return {"conv1": conv(f"{prefix}.conv1"), "conv2": conv(f"{prefix}.conv2"),
                "bn": {k: leaf(f"{prefix}.bn.{k}") for k in ("gamma", "beta", "mean", "var")}}

    depth = 1 + max(int(k.split(".")[1]) for k in flat if k.startswith("down."))
    up = []
    for d in range(depth - 1):
        up.append({**block(f"up.{d}"), "convT": conv(f"up.{d}.convT")})
    return {"down": [block(f"down.{d}") for d in range(depth)], "up": up,
            "final": conv("final")}


def batch_sums(outputs: torch.Tensor, labels: torch.Tensor,
               eps: float = LOSS_EPS) -> torch.Tensor:
    """The five sums of the loss over the head's outputs ``outputs`` (before
    the sigmoid) and ``labels`` (same shape)."""
    p = torch.clamp(torch.sigmoid(outputs), eps, 1 - eps)
    terms = labels * torch.log(p) + (1 - labels) * torch.log(1 - p)
    count = torch.tensor(float(p.numel()), dtype=p.dtype, device=p.device)
    return torch.stack([terms.sum(), (p * labels).sum(), p.sum(), labels.sum(), count])


def loss_of_sums(s: torch.Tensor, eps: float = LOSS_EPS) -> torch.Tensor:
    """Dice + BCE of the sums of :func:`batch_sums`."""
    return -(s[0] / s[4]) + 1.0 - (2 * s[1] + eps) / (s[2] + s[3] + eps)


def loss_and_grads(params: Dict[str, torch.Tensor], images: torch.Tensor,
                   labels: torch.Tensor, *, block: Optional[int] = None,
                   dtype=torch.float64, tf32: bool = False, eps: float = LOSS_EPS):
    """``(loss, grads)`` of the batch ``images`` ``(B, 1, H, W)`` and
    ``labels`` ``(B, C, H, W)`` at ``params`` (flat, any dtype and device),
    computed in ``dtype`` on the images' device; ``grads`` flat like
    ``params``, in ``dtype``. ``block`` slices at a time (None: the whole
    batch in one pass)."""
    device = images.device
    leaves = {k: v.detach().to(device=device, dtype=dtype).requires_grad_(True)
              for k, v in params.items()}
    p = nested(leaves)
    x, y = images.to(dtype), labels.to(dtype)
    n = x.shape[0]
    with precision(tf32):
        if block is None or block >= n:
            loss = loss_of_sums(batch_sums(logits(p, x), y, eps), eps)
            loss.backward()
        else:
            with torch.no_grad():
                total = sum(batch_sums(logits(p, x[s:s + block]), y[s:s + block], eps)
                            for s in range(0, n, block))
            total.requires_grad_(True)
            loss = loss_of_sums(total, eps)
            (weights,) = torch.autograd.grad(loss, total)
            for s in range(0, n, block):
                part = batch_sums(logits(p, x[s:s + block]), y[s:s + block], eps)
                (weights * part).sum().backward()
    return float(loss.detach()), {k: v.grad for k, v in leaves.items()}


def adam_step(params, grads, mu, nu, count: float, lr: float, b1: float = 0.9,
              b2: float = 0.999, eps: float = 1e-8):
    """One Adam step of the flat dicts in the grads' dtype from the state
    after ``count`` steps: ``(params, mu, nu)`` after it."""
    t = float(count) + 1.0
    c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
    out_p, out_m, out_v = {}, {}, {}
    for k, g in grads.items():
        m = b1 * mu[k].to(g.dtype) + (1 - b1) * g
        v = b2 * nu[k].to(g.dtype) + (1 - b2) * g * g
        out_p[k] = params[k].to(g.dtype) - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
        out_m[k], out_v[k] = m, v
    return out_p, out_m, out_v
