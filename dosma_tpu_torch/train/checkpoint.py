"""Training checkpoints (counterpart of ``dosma_tpu/train/checkpoint.py``).

``dosma_tpu`` saves with Orbax under ``ckpt_dir/step_N``. The port keeps the
layout and writes each step with ``torch.distributed.checkpoint``: every
rank writes its own blocks of sharded arrays (``DTensor``) once, plain
tensors are written by one rank, and a restore reads into the target's
placements, so a state saved at one world size restores at another. Without
a process group it reads and writes in this process alone. Host (numpy)
leaves are saved as CPU tensors.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(ckpt_dir), f"step_{step}")


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_tensors(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree
    return torch.from_numpy(np.array(tree))


def _dcp(fn, state, path):
    """``torch.distributed.checkpoint.save`` / ``load`` of ``state`` at
    ``path``, in this process alone when no process group is initialised."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        fn(state, checkpoint_id=path, no_dist=not dist.is_initialized())


def save_checkpoint(ckpt_dir: str, step: int, params: Any, opt_state: Any = None) -> str:
    """Save params (+ optional optimizer state) under ``ckpt_dir/step_N``.

    Leaves may be tensors, ``DTensor``s or host arrays, nested in dicts and
    lists. Every rank of the process group must call it.
    """
    import torch.distributed.checkpoint as dcp

    path = _step_path(ckpt_dir, step)
    payload = {"params": _as_tensors(params)}
    if opt_state is not None:
        payload["opt_state"] = _as_tensors(opt_state)
    _dcp(dcp.save, payload, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None, target: Any = None):
    """Restore the checkpoint payload dict ({"params", "opt_state"?}).

    ``target``: a payload of the same structure whose arrays the restore
    fills in place on their own placements (pass a trainer's live state:
    :meth:`~dosma_tpu_torch.train.seg_trainer.SegTrainer.state`); it is
    returned. Without it, every array is restored whole, as a CPU tensor,
    in the saved structure.
    """
    import torch.distributed.checkpoint as dcp

    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {ckpt_dir}")
    path = _step_path(ckpt_dir, step)
    if target is not None:
        with torch.no_grad():
            _dcp(dcp.load, target, path)
        return target

    meta = dcp.FileSystemReader(path).read_metadata()
    flat = {k: torch.empty(m.size, dtype=m.properties.dtype)
            for k, m in meta.state_dict_metadata.items()}
    _dcp(dcp.load, flat, path)
    out = {}
    for key, tensor in flat.items():
        *parents, leaf = meta.planner_data[key]
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = tensor
    return _lists(out)


def _lists(node):
    """Nested dicts keyed 0..n-1 (DCP's flattening of lists) back to lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node
