"""DICOM series to volumes on a card, the host → card copies overlapping
the parse (counterpart of ``dosma_tpu/core/io/prefetch.py``).

Three phases overlap:

1. file bytes: one bulk read via a thread pool;
2. per-group pixel parsing, deferred inside ``DicomReader.iter_groups``:
   group *k+1* is parsed only after group *k* has been yielded;
3. each group's stacked pixels are staged in a pinned host tensor and
   copied with ``non_blocking=True`` on a side CUDA stream, so the copy of
   group *k* runs while the generator parses group *k+1*.

With ``sharding`` (``parallel.sharding.NamedSharding``) each rank stages and
copies only its own block of each group, and the volumes are ``DTensor``s
on the sharding's mesh.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from dosma_tpu_torch.core.device import Device, as_tensor, get_default_device

__all__ = ["load_to_device"]


def load_to_device(
    path_or_files,
    group_by: Union[str, int, Sequence] = "EchoNumbers",
    device=None,
    sharding=None,
    num_workers: int = 4,
    ignore_ext: bool = False,
):
    """Load a DICOM series and place each grouped volume on ``device``.

    Returns a list of :class:`MedicalVolume` whose arrays are tensors on
    ``device`` (default: the port's default device, the first CUDA card;
    without a card this raises unless the caller asked for the CPU), or,
    with ``sharding``, laid out by it: each rank reads the series and copies
    its own block to its device (a mesh without a process group places the
    whole volume on the default device).
    Headers and affines stay on the host. uint16 / uint32 pixels arrive as
    int32 / int64 (widened on the card, after the narrow bytes crossed).
    The caller's current stream is made to wait for the copies, so the
    volumes can be used on it at once.
    """
    from dosma_tpu_torch.core.io.dicom_io import DicomReader

    if sharding is not None:
        device = sharding.mesh.device
    else:
        device = (get_default_device() if device is None else Device(device)).ptdevice
    groups = DicomReader(num_workers=num_workers, ignore_ext=ignore_ext).iter_groups(
        path_or_files, group_by=group_by
    )

    def block(vol):
        """The host pixels this rank places, and the volume's full shape."""
        arr = np.asarray(vol.volume)
        return (arr if sharding is None else arr[sharding.local_slices(arr.shape)]), arr.shape

    def placed(vol, tensor, shape):
        if sharding is not None:
            tensor = sharding.from_local(tensor, shape)
        return vol._partial_clone(volume=tensor)

    if device.type != "cuda":
        out = []
        for vol in groups:
            arr, shape = block(vol)
            out.append(placed(vol, as_tensor(np.ascontiguousarray(arr), device), shape))
        return out

    caller = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(caller)  # work the caller queued before stays first
    out = []
    for vol in groups:
        arr, shape = block(vol)
        pinned = torch.empty(arr.shape, dtype=torch.from_numpy(arr[:0]).dtype, pin_memory=True)
        pinned.numpy()[...] = arr
        # torch's pinned-memory allocator records the copy on ``side`` and
        # reuses the buffer only once the copy is done, so it may be dropped.
        with torch.cuda.stream(side):
            local = as_tensor(pinned.to(device, non_blocking=True))
        local.record_stream(caller)
        out.append(placed(vol, local, shape))
    caller.wait_stream(side)
    return out
