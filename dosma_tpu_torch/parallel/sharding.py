"""Several cards for the port: sharded fits, registrations, inference and
volume placement (counterpart of ``dosma_tpu/parallel/sharding.py``).

``dosma_tpu`` drives every device from one process (a ``jax`` ``Mesh``, a
``NamedSharding`` and ``shard_map``). The port follows PyTorch's idiom:
SPMD, one process a card (``torchrun``, or ``init_process_group`` given
its address, world size and rank). Its semantics are the JAX package's:

- every rank calls an entry point with the same full host inputs, computes
  its own block, and all-gathers the result, so every rank returns the
  whole (the same arguments and return values as ``dosma_tpu``);
- :class:`Mesh` names the axes of the ranks of the default process group.
  It wraps a ``torch.distributed`` ``DeviceMesh`` when a group is
  initialised, and nothing when none is: a world of one rank then needs no
  process group and no environment variable, computes on the default device
  (``core/device.py``: the first card, or the CPU when asked) and calls no
  collective. A user may call ``init_process_group`` afterwards;
- a sharded volume is a ``DTensor`` on the mesh with ``Shard(axis)``
  placements (uneven sizes split as ``torch.chunk`` splits them), the
  counterpart of a ``jax.Array`` laid out by a ``NamedSharding``. It is
  spelled :class:`NamedSharding` ``(mesh, PartitionSpec(...))``, as in JAX.
  On a mesh without a group it is a plain tensor on the default device.

Under a process group each rank computes on ``cuda:LOCAL_RANK`` whatever
the backend, and on the CPU only when the caller asked for it: a CPU tensor
as the input, or, for host inputs, the CPU as the default device
(:func:`Mesh.device_for`). A card tensor's block is never moved to the host.
A failed build, launch or collective raises: nothing falls back.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dosma_tpu_torch.core.device import as_tensor, compute_device

__all__ = [
    "Mesh",
    "NamedSharding",
    "PartitionSpec",
    "get_mesh",
    "make_mesh",
    "shard_voxels",
    "sharded_lm_fit",
    "sharded_register_chain_batch",
    "sharded_unet_inference",
]


def _rank_device(*arrays) -> torch.device:
    """Where this rank of a process group computes ``arrays``: the device
    type that :func:`~dosma_tpu_torch.core.device.compute_device` picks (the
    first tensor's, else the default device's), on this rank's card
    ``cuda:LOCAL_RANK``. Host inputs with no card and no CPU asked for raise."""
    if compute_device(*arrays).type == "cpu":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


class Mesh:
    """Named axes over the ranks of the default process group.

    ``device_mesh`` is the ``torch.distributed`` ``DeviceMesh`` of an
    initialised group, or None for a world of one rank without one (every
    axis then has size 1 and nothing is communicated).
    """

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], device_mesh=None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes {self.axis_names} differ in length")

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def device_for(self, *arrays) -> torch.device:
        """The device this rank computes ``arrays`` on: the first tensor's
        device type, else the default device's; under a process group on
        this rank's card."""
        return _rank_device(*arrays) if self.device_mesh is not None else compute_device(*arrays)

    @property
    def device(self) -> torch.device:
        """The device this rank computes host inputs on."""
        return self.device_for()

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_rank(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_local_rank(axis)

    def group(self, axis: str):
        """The process group along ``axis`` (None without a device mesh)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        return f"Mesh({dict(zip(self.axis_names, self.shape))}, grouped={self.device_mesh is not None})"


# (shape, axes, device type) -> Mesh of the world group held beside them: a
# DeviceMesh creates its process groups once. Holding the group keeps its id
# from being reused; a new world (destroy, then init again) empties the cache.
_MESHES = {}
_MESH_WORLD = [None]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh of ``shape`` over the world (rank = row-major coordinate).

    Without an initialised process group ``shape`` must hold one rank.
    """
    shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
    if not dist.is_initialized():
        if int(np.prod(shape)) != 1:
            raise ValueError(f"a {shape} mesh needs an initialised process group")
        return Mesh(shape, axis_names)
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not hold the world of {world} ranks")
    if _MESH_WORLD[0] is not dist.group.WORLD:
        _MESHES.clear()
        _MESH_WORLD[0] = dist.group.WORLD
    device = _rank_device()
    key = (shape, axis_names, device.type)
    if key not in _MESHES:
        from torch.distributed.device_mesh import init_device_mesh

        if device.type == "cuda":
            torch.cuda.set_device(device)
        _MESHES[key] = Mesh(shape, axis_names,
                            init_device_mesh(device.type, shape, mesh_dim_names=axis_names))
    return _MESHES[key]


def get_mesh(axis_name: str = "data") -> Mesh:
    """1-D data-parallel mesh over the world (one rank without a group)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((world,), (axis_name,))


class PartitionSpec(tuple):
    """A mesh axis name (or None) for each dimension of an array, as
    ``jax.sharding.PartitionSpec``: ``PartitionSpec(None, None, "data")``
    shards the third dimension over the ``data`` axis."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


class NamedSharding:
    """An array laid out on ``mesh`` by ``spec`` (a :class:`PartitionSpec`):
    the port's counterpart of ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh: Mesh, spec: Sequence = ()):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)
        for axis in self.spec:
            if axis is not None and axis not in mesh.axis_names:
                raise ValueError(f"{axis!r} is not an axis of {mesh}")

    def placements(self, ndim: int) -> list:
        """``DTensor`` placements, one for each mesh axis."""
        from torch.distributed.tensor import Replicate, Shard

        spec = tuple(self.spec) + (None,) * (ndim - len(self.spec))
        return [Shard(spec.index(name)) if name in spec else Replicate()
                for name in self.mesh.axis_names]

    def local_slices(self, shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of an array of ``shape``: ``torch.chunk``'s
        split of each sharded dimension (ceil-sized blocks, the last ones
        smaller or empty)."""
        out = [slice(None)] * len(shape)
        for dim, axis in enumerate(self.spec):
            if axis is None:
                continue
            n, k = int(shape[dim]), self.mesh.axis_size(axis)
            size = -(-n // k)
            start = min(self.mesh.axis_rank(axis) * size, n)
            out[dim] = slice(start, min(start + size, n))
        return tuple(out)

    def from_local(self, local: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
        """This rank's block ``local`` as the sharded array of ``shape`` (a
        plain tensor without a device mesh)."""
        if self.mesh.device_mesh is None:
            return local
        from torch.distributed.tensor import DTensor

        shape = torch.Size(shape)
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh.device_mesh, self.placements(len(shape)),
                                  run_check=False, shape=shape, stride=stride)

    def place(self, array) -> torch.Tensor:
        """A full host array or tensor (the same on every rank) laid out by
        this sharding: each rank copies only its own block to its device."""
        local = array[self.local_slices(array.shape)]
        return self.from_local(as_tensor(local, self.mesh.device_for(array)), tuple(array.shape))


# ----------------------------------------------------------------------
# Rows over the data axis
# ----------------------------------------------------------------------
def _pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    n = arr.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return arr, 0
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad)
    return np.pad(arr, widths, mode="edge"), pad


def shard_voxels(arr, mesh: Mesh, axis_name: str = "data"):
    """This rank's block of a voxel-batched array ``(N, ...)`` and the pad
    count.

    N is edge-padded to a multiple of the axis size (the padding rows are
    computed like any other and dropped by the caller) and split into equal
    blocks, as ``dosma_tpu``'s ``shard_voxels`` lays them out. The block
    lies on :meth:`Mesh.device_for` ``(arr)``: a tensor's on its device type,
    a host array's on the default device's (under a group, this rank's card).
    """
    k = mesh.axis_size(axis_name)
    device = mesh.device_for(arr)
    if isinstance(arr, torch.Tensor):
        pad = (-arr.shape[0]) % k
        if pad:
            arr = torch.cat([arr, arr[-1:].expand(pad, *arr.shape[1:])])
    else:
        arr, pad = _pad_to_multiple(np.asarray(arr), k, axis=0)
    n = arr.shape[0] // k
    r = mesh.axis_rank(axis_name)
    return as_tensor(arr[r * n:(r + 1) * n], device), pad


def _gather_rows(t: torch.Tensor, mesh: Mesh, axis_name: str) -> torch.Tensor:
    """Every rank's equal block of rows, concatenated in rank order."""
    group = mesh.group(axis_name)
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.axis_size(axis_name))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def _host_out(t: torch.Tensor, host: bool):
    return t.cpu().numpy() if host else t


# ----------------------------------------------------------------------
# Fits
# ----------------------------------------------------------------------
_KERNELS = ("auto", "pallas_monoexp", "pallas_biexp", "pallas_generic", "generic")


def _is_library_model(model_fn, name: str) -> bool:
    """True when ``model_fn`` IS the port's library model (identity only: a
    user function that shares the name may use another parametrization)."""
    from dosma_tpu_torch.core import fitting

    return model_fn is getattr(fitting, name)


def _with_arity(model_fn, nparams: int):
    """``model_fn(x_col, params)`` (``lm_fit``'s form) as ``f(x, p0, ...,
    p{P-1})``, the form :func:`~dosma_tpu_torch.ops.generic_lm.compile_model`
    traces."""
    forms = {
        1: lambda x, a: model_fn(x, (a,)),
        2: lambda x, a, b: model_fn(x, (a, b)),
        3: lambda x, a, b, c: model_fn(x, (a, b, c)),
        4: lambda x, a, b, c, d: model_fn(x, (a, b, c, d)),
    }
    f = forms.get(nparams, model_fn)
    f.__name__ = getattr(model_fn, "__name__", "model")
    return f


def sharded_lm_fit(
    model_fn,
    x,
    y,
    p0,
    mesh: Optional[Mesh] = None,
    kernel: str = "auto",
    axis_name: str = "data",
    **kwargs,
):
    """Data-parallel :func:`dosma_tpu_torch.ops.nlls.lm_fit`: ``y`` (N, T)
    has its voxel axis split over the ``axis_name`` ranks; each rank fits its
    block with one launch of a kernel and the rows are all-gathered.

    ``model_fn`` is the library :func:`~dosma_tpu_torch.core.fitting.
    monoexponential` / :func:`~dosma_tpu_torch.core.fitting.biexponential`
    (recognised by identity), or ``model_fn(x_col, params)`` as ``lm_fit``
    takes it. ``p0`` is (P,) or per voxel (N, P), split like ``y``.

    ``kernel`` keeps ``dosma_tpu``'s names; the fit runs on the rank's
    device (a CUDA card: the kernel; the CPU: its plain version):

    - ``"auto"``: ``monoexp_lm`` for the library monoexponential,
      ``biexp_lm`` for the library biexponential, otherwise the generic
      kernel of the model (``generic_lm.compile_model``), or, for a model
      its whitelist refuses, ``lm_fit`` with a warning naming the node;
    - ``"pallas_monoexp"`` / ``"pallas_biexp"``: force ``monoexp_lm`` /
      ``biexp_lm``;
    - ``"pallas_generic"`` / ``"generic"``: the generic kernel (``lm_fit``
      for a refused model) whatever the model.

    Returns ``(popt (N, P), r2 (N,), converged (N,))``: numpy arrays for a
    host ``y``, tensors on the rank's device for a tensor ``y``.
    """
    from dosma_tpu_torch.ops.generic_lm import ModelRefused, compile_model, generic_lm
    from dosma_tpu_torch.ops.nlls import lm_fit

    if kernel not in _KERNELS:
        raise ValueError(f"Unknown kernel {kernel!r}")
    if mesh is None:
        mesh = get_mesh(axis_name)
    host = not isinstance(y, torch.Tensor)
    N = y.shape[0]
    x = np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x, np.float32)

    y_local, _pad = shard_voxels(y if not host else np.asarray(y), mesh, axis_name)
    p0 = torch.as_tensor(np.asarray(p0, np.float32) if not isinstance(p0, torch.Tensor) else p0,
                         dtype=torch.float32, device=y_local.device)
    p0_local = shard_voxels(p0, mesh, axis_name)[0] if p0.ndim == 2 else p0

    mono, biexp = _is_library_model(model_fn, "monoexponential"), \
        _is_library_model(model_fn, "biexponential")
    if kernel == "pallas_monoexp" or (kernel == "auto" and mono):
        from dosma_tpu_torch.ops.monoexp import _detect_uniform_x, monoexp_lm

        # Worked out once from the host x, as dosma_tpu does before shard_map.
        kwargs.setdefault("uniform_x", _detect_uniform_x(x))
        popt, r2, conv = monoexp_lm(x, y_local, p0_local, **kwargs)
    elif kernel == "pallas_biexp" or (kernel == "auto" and biexp):
        from dosma_tpu_torch.ops.biexp import biexp_lm

        popt, r2, conv = biexp_lm(x, y_local, p0_local, **kwargs)
    else:
        nparams = int(p0.shape[-1])
        if mono or biexp:
            curve = model_fn

            def model_fn(x_col, params, _f=curve):  # noqa: F811
                return _f(x_col, *params)
        else:
            curve = _with_arity(model_fn, nparams)
        try:
            program = compile_model(curve, nparams)
        except ModelRefused as e:
            warnings.warn(
                f"The generic CUDA kernel does not take {getattr(curve, '__name__', curve)!r} "
                f"({e}); fitting it with lm_fit on {y_local.device}."
            )
            popt, r2, conv = lm_fit(model_fn, x, y_local, p0_local, **kwargs)
        else:
            popt, r2, conv = generic_lm(program, x, y_local, p0_local, **kwargs)

    popt, r2, conv = (_gather_rows(t, mesh, axis_name)[:N] for t in (popt, r2, conv))
    return tuple(_host_out(t, host) for t in (popt, r2, conv))


# ----------------------------------------------------------------------
# Registration
# ----------------------------------------------------------------------
def sharded_register_chain_batch(
    fixed_arr,
    fixed_affine,
    moving_arrs,
    moving_affine,
    stage_cfgs,
    fixed_mask=None,
    use_mask=None,
    mesh: Optional[Mesh] = None,
    axis_name: str = "data",
):
    """A batch registration with its MOVING axis split over the ranks.

    Each rank runs :func:`dosma_tpu_torch.ops.registration.
    register_chain_batch` on its moving images (the multi-stage pyramid
    chain of each, stage seeds offset by the image's global index, then one
    ``warp_grid`` launch for its stack); the fixed image is replicated.
    Matrix stages only: a B-spline stage raises ``ValueError``.

    Returns ``(Ms (M, S, 4, 4) host float64, warped (M, ...))``: the warped
    stack gathered from every rank (numpy for host moving images, else a
    tensor on the rank's device).
    """
    from dosma_tpu_torch.ops.registration import register_chain_batch

    stage_cfgs = list(stage_cfgs)
    if any(cfg.transform == "bspline" for cfg in stage_cfgs):
        raise ValueError("sharded_register_chain_batch supports matrix stages only")
    if mesh is None:
        mesh = get_mesh(axis_name)
    host = not isinstance(moving_arrs, torch.Tensor)
    moving = np.asarray(moving_arrs, np.float32) if host else moving_arrs
    n_img = moving.shape[0]
    local, _pad = shard_voxels(moving, mesh, axis_name)
    first = mesh.axis_rank(axis_name) * local.shape[0]
    Ms, warped, _info = register_chain_batch(
        fixed_arr, fixed_affine, local, moving_affine, stage_cfgs, fixed_mask=fixed_mask,
        use_mask=use_mask, first_index=first,
    )
    Ms = _gather_rows(torch.as_tensor(Ms, device=local.device), mesh, axis_name)[:n_img]
    warped = _gather_rows(warped, mesh, axis_name)[:n_img]
    return Ms.cpu().numpy(), _host_out(warped, host)


# ----------------------------------------------------------------------
# Inference
# ----------------------------------------------------------------------
def sharded_unet_inference(model, v, mesh: Optional[Mesh] = None, batch_size: int = 16,
                           axis_name: str = "data"):
    """U-Net probabilities of the slices ``v`` (N, H, W, C) with the slice
    axis split over the ranks (edge-padded to a multiple of their number).

    ``model`` is a :class:`~dosma_tpu_torch.models.unet2d.Unet2D` or any
    object with the JAX package's ``params`` dict. Each rank runs
    ``UNet2D`` on its slices, ``batch_size`` at a time, inside
    ``cudnn_exact``. Returns host float32 ``(N, H, W, num_classes)``.
    """
    from dosma_tpu_torch.models.unet2d import UNet2D, cudnn_exact

    if mesh is None:
        mesh = get_mesh(axis_name)
    n = v.shape[0]
    local, _pad = shard_voxels(v if isinstance(v, torch.Tensor) else np.asarray(v), mesh,
                               axis_name)
    dev = local.device
    net = model.network(dev) if hasattr(model, "network") else \
        UNet2D.from_params(model.params).to(dev).eval()
    x = local.permute(0, 3, 1, 2).to(next(net.parameters()).dtype)
    with torch.inference_mode(), cudnn_exact():
        outs = [net(x[s:s + batch_size]) for s in range(0, x.shape[0], batch_size)]
        out = torch.cat(outs).to(torch.float32).permute(0, 2, 3, 1).contiguous()
    return _gather_rows(out, mesh, axis_name)[:n].cpu().numpy()
