"""U-Net segmentation training with Dice + BCE on a ``(data, model)`` mesh
(counterpart of ``dosma_tpu/train/seg_trainer.py``).

``dosma_tpu`` jits one SPMD program over a 2-D mesh: the slice batch is
sharded over ``data``, conv kernels and biases at least 256 channels wide
over ``model``. The port runs one process a rank (``parallel/sharding.py``)
and writes the same program out by hand:

- **data parallelism.** Each ``data`` rank takes its block of the batch.
  Dice is a global quantity, so the partial sums (BCE sum, Σ p·l, Σ p,
  Σ l, the element count) are all-reduced over ``data`` *before* the loss
  is formed; that all-reduce passes the gradient through unchanged, so each
  rank back-propagates the global loss into its own contributions, and the
  parameter gradients are then summed (not averaged) over ``data``.
- **tensor parallelism.** A wide convolution keeps its block of output
  channels (dim 0 of a ``Conv2d`` weight, dim 1 of a ``ConvTranspose2d``
  weight; its bias and BatchNorm vectors when they are wide too). Its input
  passes an identity whose backward all-reduces the input gradient over
  ``model``; its output channels are all-gathered, and the gather's
  backward takes this rank's slice of the (replicated) gradient. The rest
  of the network is replicated.
- **every leaf is trained**, BatchNorm ``mean`` and ``var`` included, as
  ``jax.value_and_grad`` over the whole pytree and ``optax.adam`` over
  every leaf do in ``dosma_tpu``. The inference model
  (``models/unet2d.py``) is untouched.
- **Adam** is ``torch.optim.Adam`` with optax's defaults (b1 0.9, b2 0.999,
  eps 1e-8 outside the square root), pinned to its ``foreach``
  implementation.

Every forward and backward runs inside ``unet2d.cudnn_exact()``. A world
of one rank without a process group communicates nothing.

:meth:`SegTrainer.step` records the span ``dosma.train`` with its stages
``dosma.train.place`` (the host conversion and the crossing),
``.forward`` (the forward and the loss), ``.backward`` (``loss.backward()``
and, on several ranks, the gradients' all-reduce), ``.optimizer`` (the Adam
step) and ``.loss`` (the loss read back).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dosma_tpu_torch.core.device import as_tensor
from dosma_tpu_torch.models.unet2d import BN_EPS, cudnn_exact, init_unet2d_params
from dosma_tpu_torch.models.weights import params_from_state_dict, state_dict_from_params
from dosma_tpu_torch.parallel.sharding import Mesh, NamedSharding, PartitionSpec, make_mesh
from dosma_tpu_torch.utils.profiling import annotate

__all__ = [
    "SegTrainer",
    "adam_state_from_optax",
    "dice_bce_loss",
    "make_sharded_train_step",
    "param_shardings",
    "unet_train_forward",
]

# Conv output channels are sharded over the model axis once the JAX
# package's rule selects the leaf (its Keras last axis at least this wide).
_TP_MIN_CHANNELS = 256

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


# ----------------------------------------------------------------------
# Collectives with the gradients the program needs
# ----------------------------------------------------------------------
class _AllReduceSum(torch.autograd.Function):
    """Sum over ``group`` forward; the gradient passes through unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient is summed over the model group (each
    rank's sharded convolution sees only its own output channels)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All-gather dim 1 over the model group; the backward takes this rank's
    slice of the gradient, which every rank computed in full."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.width = rank, x.shape[1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=1)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(1, ctx.rank * ctx.width, ctx.width).contiguous(), None, None, None


# ----------------------------------------------------------------------
# Loss
# ----------------------------------------------------------------------
def dice_bce_loss(probs: torch.Tensor, labels: torch.Tensor, eps: float = 1e-6,
                  group=None) -> torch.Tensor:
    """Soft-Dice + binary cross-entropy of the whole batch.

    With ``group``, each rank holds a block of the batch: the partial sums
    are all-reduced over ``group`` before the loss is formed, so every rank
    returns the loss of the whole batch.
    """
    probs = torch.clamp(probs, eps, 1 - eps)
    terms = labels * torch.log(probs) + (1 - labels) * torch.log(1 - probs)
    count = torch.tensor(float(probs.numel()), dtype=probs.dtype, device=probs.device)
    sums = torch.stack([terms.sum(), (probs * labels).sum(), probs.sum(), labels.sum(), count])
    if group is not None:
        sums = _AllReduceSum.apply(sums, group)
    bce = -(sums[0] / sums[4])
    dice = 1.0 - (2 * sums[1] + eps) / (sums[2] + sums[3] + eps)
    return bce + dice


# ----------------------------------------------------------------------
# Layouts
# ----------------------------------------------------------------------
def _shard_dim(name: str, shape) -> Optional[int]:
    """The dim of a state-dict leaf sharded over the model axis, or None.

    The leaves are those ``dosma_tpu`` shards: a kernel whose Keras last
    axis is at least ``_TP_MIN_CHANNELS`` wide (that axis is dim 0 in
    PyTorch's layout of both kinds of convolution) and 1-D leaves as wide.
    A convolution is split over its output channels.
    """
    if shape[0] < _TP_MIN_CHANNELS or len(shape) not in (1, 4):
        return None
    return 1 if name.endswith("convT.weight") else 0


def param_shardings(params: Dict[str, torch.Tensor], mesh: Mesh, model_axis: str = "model"):
    """:class:`NamedSharding` of each leaf of a U-Net state dict (PyTorch
    layouts, :func:`~dosma_tpu_torch.models.weights.state_dict_from_params`):
    wide convolutions split over their output channels on ``model_axis``,
    everything else replicated."""
    out = {}
    for name, leaf in params.items():
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        dim = _shard_dim(name, shape)
        if dim is not None:
            spec[dim] = model_axis
        out[name] = NamedSharding(mesh, PartitionSpec(*spec))
    return out


class _TensorParallel:
    """This rank's place on the model axis and the leaves sharded over it."""

    def __init__(self, mesh: Mesh, model_axis: str, sharded):
        self.group = mesh.group(model_axis)
        self.rank = mesh.axis_rank(model_axis)
        self.size = mesh.axis_size(model_axis)
        self.sharded = frozenset(sharded)

    def copy(self, h):
        return _CopyToModel.apply(h, self.group)

    def gather(self, h):
        return _GatherChannels.apply(h, self.group, self.rank, self.size)


def _bn(p, prefix, x):
    inv = torch.rsqrt(p[f"{prefix}.bn.var"] + BN_EPS)
    return (x - p[f"{prefix}.bn.mean"][:, None, None]) * inv[:, None, None] \
        * p[f"{prefix}.bn.gamma"][:, None, None] + p[f"{prefix}.bn.beta"][:, None, None]


def _block(p, prefix, h, tp):
    """Two 3x3 SAME convolutions with ReLU, then BatchNorm; a wide block
    computes its own output channels and gathers them after each conv."""
    sharded = tp is not None and f"{prefix}.conv1.weight" in tp.sharded
    for conv in ("conv1", "conv2"):
        if sharded:
            h = tp.copy(h)
        h = F.relu(F.conv2d(h, p[f"{prefix}.{conv}.weight"], p[f"{prefix}.{conv}.bias"],
                            padding=1))
        if conv == "conv2":
            h = _bn(p, prefix, h)
        if sharded:
            h = tp.gather(h)
    return h


def _up(p, d, h, stride, tp):
    """The decoder's TF-SAME transpose convolution (``unet2d.
    conv_transpose_same``); a wide one computes its own output channels."""
    w, b = p[f"up.{d}.convT.weight"], p[f"up.{d}.convT.bias"]
    sharded = tp is not None and f"up.{d}.convT.weight" in tp.sharded
    bias_sharded = tp is not None and f"up.{d}.convT.bias" in tp.sharded
    if sharded:
        h = tp.copy(h)
    out = F.conv_transpose2d(h, w, stride=stride)
    pb = (w.shape[-1] - stride) // 2
    out = out[:, :, pb:pb + h.shape[2] * stride, pb:pb + h.shape[3] * stride]
    if sharded and not bias_sharded:
        out = tp.gather(out)
    out = out + b[:, None, None]
    if bias_sharded:
        out = tp.gather(out)
    return out


def unet_train_forward(p: Dict[str, torch.Tensor], x: torch.Tensor,
                       tp: Optional[_TensorParallel] = None) -> torch.Tensor:
    """``models.unet2d.UNet2D``'s forward over a state dict ``p`` whose
    leaves (BatchNorm statistics included) may all require gradients.
    ``x`` (B, C, H, W) → sigmoid probabilities (B, num_classes, H, W)."""
    depth = 1 + max(int(k.split(".")[1]) for k in p if k.startswith("down."))
    skips, h = [], x
    for d in range(depth):
        h = _block(p, f"down.{d}", h, tp)
        skips.append(h)
        if d < depth - 1:
            size = 2 if h.shape[2] % 2 == 0 else 3
            h = F.max_pool2d(h, size, stride=size)
    for d in range(depth - 2, -1, -1):
        target = skips[d]
        up = _up(p, d, h, 2 if target.shape[2] % 2 == 0 else 3, tp)
        h = _block(p, f"up.{d}", torch.cat([up, target], dim=1), tp)
    return torch.sigmoid(F.conv2d(h, p["final.weight"], p["final.bias"]))


# ----------------------------------------------------------------------
# Train step
# ----------------------------------------------------------------------
def adam_state_from_optax(count, mu, nu) -> Dict:
    """optax's ``ScaleByAdamState`` leaves (numpy; ``mu`` and ``nu`` nested
    like the JAX package's parameters) as the port's optimizer state:
    ``{"count", "mu", "nu"}`` with full CPU tensors in PyTorch layouts."""
    return {"count": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "mu": dict(state_dict_from_params(mu)), "nu": dict(state_dict_from_params(nu))}


class _Step:
    """The parameters of one rank, its optimizer and the train step."""

    def __init__(self, mesh, learning_rate, data_axis, model_axis, full: Dict[str, torch.Tensor]):
        self.mesh, self.data_axis = mesh, data_axis
        self.shapes = {k: tuple(v.shape) for k, v in full.items()}
        self.shardings = param_shardings(full, mesh, model_axis)
        dev = mesh.device
        self.params = {
            k: v[self.shardings[k].local_slices(v.shape)].to(dev, torch.float32, copy=True)
            .contiguous().requires_grad_(True)
            for k, v in full.items()
        }
        sharded = [k for k, s in self.shardings.items() if any(a is not None for a in s.spec)]
        self.tp = None if mesh.group(model_axis) is None else \
            _TensorParallel(mesh, model_axis, sharded)
        self.optimizer = torch.optim.Adam(
            list(self.params.values()), lr=learning_rate, betas=(ADAM_B1, ADAM_B2), eps=ADAM_EPS,
            foreach=True,
        )
        # The state exists from the start, so a checkpoint can restore into it.
        for p in self.params.values():
            self.optimizer.state[p] = {
                "step": torch.tensor(0.0, dtype=torch.float32),
                "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
            }

    def place_batch(self, images, labels):
        """This data rank's block of NHWC host arrays, as NCHW float32 on
        the rank's device: made float32 on the host, then one crossing each
        (counted by ``h2d.bytes``)."""
        sharding = NamedSharding(self.mesh, PartitionSpec(self.data_axis))
        rows = sharding.local_slices(np.shape(images))
        dev = self.mesh.device
        return tuple(
            as_tensor(np.asarray(a)[rows].astype(np.float32, copy=False), dev).permute(0, 3, 1, 2)
            for a in (images, labels))

    def backward(self, images, labels) -> torch.Tensor:
        """The loss of the whole batch; every leaf's ``grad`` holds its
        gradient summed over the data ranks."""
        for p in self.params.values():
            p.grad = None
        group = self.mesh.group(self.data_axis)
        with cudnn_exact():
            with annotate("dosma.train.forward"):
                probs = unet_train_forward(self.params, images, self.tp)
                loss = dice_bce_loss(probs, labels, group=group)
            with annotate("dosma.train.backward"):
                loss.backward()
                if group is not None:
                    grads = [p.grad for p in self.params.values()]
                    flat = torch.cat([g.reshape(-1) for g in grads])
                    dist.all_reduce(flat, group=group)
                    offset = 0
                    for g in grads:
                        g.copy_(flat[offset:offset + g.numel()].view_as(g))
                        offset += g.numel()
        return loss.detach()

    def train_step(self, images, labels) -> torch.Tensor:
        """One Adam step of this rank's parameters on NCHW blocks; the loss."""
        loss = self.backward(images, labels)
        with annotate("dosma.train.optimizer"):
            self.optimizer.step()
        return loss


def _build_step(mesh, learning_rate, data_axis, model_axis, num_classes, features,
                params) -> _Step:
    if params is None:
        params = init_unet2d_params(torch.Generator().manual_seed(0), num_classes=num_classes,
                                    features=features)
    return _Step(mesh, learning_rate, data_axis, model_axis, dict(state_dict_from_params(params)))


def make_sharded_train_step(
    mesh: Mesh,
    learning_rate: float = 1e-3,
    data_axis: str = "data",
    model_axis: str = "model",
    num_classes: int = 1,
    features=None,
    params: Optional[Dict] = None,
):
    """Build ``(params, optimizer, train_step, place_batch)`` on ``mesh``.

    ``params`` (this rank's blocks, PyTorch layouts, each requiring a
    gradient) start from ``params`` (the JAX package's nested dict, numpy,
    JAX or torch leaves) or from He-normal draws of seed 0
    (:func:`~dosma_tpu_torch.models.unet2d.init_unet2d_params`).
    ``train_step(images, labels)`` steps ``optimizer`` over ``params`` on the
    NCHW blocks of ``place_batch(images, labels)`` (NHWC host arrays) and
    returns the loss.
    """
    step = _build_step(mesh, learning_rate, data_axis, model_axis, num_classes, features, params)
    return step.params, step.optimizer, step.train_step, step.place_batch


class SegTrainer:
    """U-Net segmentation training on a ``(data, model)`` mesh.

    Without ``mesh``: the world split into ``data`` x ``model`` ranks, with
    model parallelism 2 when the world is even (one rank and no process
    group: a 1 x 1 mesh on the default device). ``params`` carries the JAX
    package's nested parameter dict across.
    """

    def __init__(self, mesh: Optional[Mesh] = None, learning_rate: float = 1e-3,
                 num_classes: int = 1, features=None, params: Optional[Dict] = None):
        if mesh is None:
            n = dist.get_world_size() if dist.is_initialized() else 1
            model_par = 2 if n % 2 == 0 and n >= 2 else 1
            mesh = make_mesh((n // model_par, model_par), ("data", "model"))
        self.mesh = mesh
        self._step = _build_step(mesh, learning_rate, "data", "model", num_classes, features,
                                 params)
        self.params, self.optimizer = self._step.params, self._step.optimizer

    def step(self, images: np.ndarray, labels: np.ndarray) -> float:
        """One optimisation step on NHWC host batches; returns the loss."""
        with annotate("dosma.train"):
            with annotate("dosma.train.place"):
                images, labels = self._step.place_batch(images, labels)
            loss = self._step.train_step(images, labels)
            with annotate("dosma.train.loss"):
                return float(loss)

    def loss_and_grads(self, images: np.ndarray, labels: np.ndarray):
        """The loss and the raw gradients of one batch, without a step:
        ``(loss, grads)``, the gradients whole on every rank, as the JAX
        package's nested dict (numpy leaves, Keras layouts)."""
        loss = self._step.backward(*self._step.place_batch(images, labels))
        grads = {k: self._full(k, p.grad) for k, p in self.params.items()}
        return float(loss), params_from_state_dict(grads)

    def host_params(self) -> Dict:
        """The parameters, whole, as the JAX package's nested dict."""
        return params_from_state_dict({k: self._full(k, p.detach())
                                       for k, p in self.params.items()})

    def _full(self, name: str, local: torch.Tensor) -> torch.Tensor:
        spec = self._step.shardings[name].spec
        dims = [d for d, a in enumerate(spec) if a is not None]
        if not dims or self.mesh.group(spec[dims[0]]) is None:
            return local
        parts = [torch.empty_like(local) for _ in range(self.mesh.axis_size(spec[dims[0]]))]
        dist.all_gather(parts, local.contiguous(), group=self.mesh.group(spec[dims[0]]))
        return torch.cat(parts, dim=dims[0])

    # ------------------------------------------------------------------
    # Optimizer state and checkpoints
    # ------------------------------------------------------------------
    def state(self) -> Dict:
        """``{"params", "opt_state"}`` as sharded arrays (``DTensor``s on
        the mesh; plain tensors without a process group) that share this
        rank's storage: the payload and the restore target of
        :mod:`~dosma_tpu_torch.train.checkpoint`."""
        def wrap(name, t):
            return self._step.shardings[name].from_local(t.detach(), self._step.shapes[name])

        opt = self.optimizer.state
        first = next(iter(self.params.values()))
        return {
            "params": {k: wrap(k, p) for k, p in self.params.items()},
            "opt_state": {
                "count": opt[first]["step"],
                "mu": {k: wrap(k, opt[p]["exp_avg"]) for k, p in self.params.items()},
                "nu": {k: wrap(k, opt[p]["exp_avg_sq"]) for k, p in self.params.items()},
            },
        }

    def load_opt_state(self, state: Dict):
        """Set the Adam state from ``{"count", "mu", "nu"}`` (full tensors in
        PyTorch layouts: :func:`adam_state_from_optax`)."""
        with torch.no_grad():
            for k, p in self.params.items():
                rows = self._step.shardings[k].local_slices(self._step.shapes[k])
                s = self.optimizer.state[p]
                s["exp_avg"].copy_(torch.as_tensor(state["mu"][k])[rows])
                s["exp_avg_sq"].copy_(torch.as_tensor(state["nu"][k])[rows])
        self._set_count(state["count"])

    def _set_count(self, count):
        for p in self.params.values():
            self.optimizer.state[p]["step"] = torch.tensor(float(count), dtype=torch.float32)

    def save(self, ckpt_dir: str, step: int) -> str:
        from dosma_tpu_torch.train.checkpoint import save_checkpoint

        state = self.state()
        return save_checkpoint(ckpt_dir, step, state["params"], state["opt_state"])

    def restore(self, ckpt_dir: str, step: Optional[int] = None):
        """Load a checkpoint (saved at any world size) into this trainer's
        parameters and optimizer state, in place."""
        from dosma_tpu_torch.train.checkpoint import restore_checkpoint

        state = self.state()
        count = state["opt_state"]["count"] = state["opt_state"]["count"].clone()
        restore_checkpoint(ckpt_dir, step, target=state)
        self._set_count(count)
