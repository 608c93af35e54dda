"""Device abstraction over host memory and CUDA cards.

Counterpart of ``dosma_tpu/core/device.py``. A :class:`Device` is either the
host CPU or one CUDA card, and maps one to one onto a ``torch.device``.
Asking for a CUDA device on a machine without one raises: a device is never
silently replaced by the CPU.

The package's entry points compute host (numpy) data on the *default
device*: the first CUDA card, unless the caller asks for another one with
:func:`set_default_device` or, for a scope, :func:`default_device`
(``with default_device("cpu"): ...``). A tensor that already lies on a
device is computed there. On a machine with no card, asking for the default
device without having asked for the CPU raises.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional, Union

import numpy as np
import torch

__all__ = [
    "Device",
    "as_tensor",
    "cpu_device",
    "get_device",
    "to_device",
    "get_default_device",
    "set_default_device",
    "default_device",
]


class Device:
    """A compute device: the host CPU or one CUDA card.

    Accepted constructors:
        - ``Device(-1)`` or ``Device("cpu")`` → host CPU
        - ``Device(k)`` for ``k >= 0`` → CUDA card ``k``
        - ``Device("cuda")`` / ``Device("cuda:k")`` → CUDA card 0 / ``k``
        - ``Device(torch.device)`` → the same device
        - ``Device(Device)`` → copy
    """

    def __init__(self, device: Union[str, int, "Device", torch.device] = -1):
        if isinstance(device, Device):
            self._type, self._index = device._type, device._index
            return
        if isinstance(device, (int, np.integer)) and not isinstance(device, bool):
            device = "cpu" if int(device) == -1 else f"cuda:{int(device)}"
        if isinstance(device, str):
            if device.lower() in ("cpu", "cpu:-1", "cpu:0"):
                device = "cpu"
            device = torch.device(device.lower())
        if not isinstance(device, torch.device):
            raise ValueError(f"Invalid device: {device!r}")

        if device.type == "cpu":
            self._type, self._index = "cpu", -1
            return
        if device.type != "cuda":
            raise ValueError(f"Unsupported device type {device.type!r}")
        if not torch.cuda.is_available():
            raise RuntimeError(f"{device} requested, but no CUDA device is available")
        index = 0 if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise ValueError(
                f"cuda:{index} requested, but only {torch.cuda.device_count()} CUDA devices exist"
            )
        self._type, self._index = "cuda", index

    @property
    def type(self) -> str:
        return self._type

    @property
    def index(self) -> int:
        return self._index

    @property
    def ptdevice(self) -> torch.device:
        """The equivalent ``torch.device``."""
        if self._type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self._index)

    def __eq__(self, other) -> bool:
        if not isinstance(other, Device):
            try:
                other = Device(other)
            except (RuntimeError, ValueError, TypeError):
                return False
        return self._type == other._type and self._index == other._index

    def __hash__(self):
        return hash((self._type, self._index))

    def __repr__(self):
        if self._type == "cpu":
            return "Device(type='cpu')"
        return f"Device(type={self._type!r}, index={self._index})"


cpu_device = Device(-1)

_default_device: Optional[Device] = None  # None: the first CUDA card


def get_default_device() -> Device:
    """The device on which entry points compute host data.

    The first CUDA card unless :func:`set_default_device` or
    :func:`default_device` chose another; raises ``RuntimeError`` when no
    card is available and the CPU was not asked for.
    """
    return Device("cuda") if _default_device is None else _default_device


def set_default_device(device: Union[str, int, Device, torch.device, None]) -> None:
    """Set the default device for host data; ``None`` restores the first card."""
    global _default_device
    _default_device = None if device is None else Device(device)


@contextlib.contextmanager
def default_device(device: Union[str, int, Device, torch.device]) -> Iterator[Device]:
    """Scope in which host data is computed on ``device``."""
    global _default_device
    previous = _default_device
    _default_device = Device(device)
    try:
        yield _default_device
    finally:
        _default_device = previous


def compute_device(*arrays) -> torch.device:
    """Where an entry point computes: the device of the first tensor among
    ``arrays`` (the caller chose it), else the default device."""
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return get_default_device().ptdevice


# torch has no CPU comparison, arithmetic or flip for these unsigned types
# (numpy and jax do); the signed type twice as wide holds every value exactly.
_WIDEN = {torch.uint16: torch.int32, torch.uint32: torch.int64}


def as_tensor(array, device=None) -> torch.Tensor:
    """``array`` (ndarray or tensor) as a tensor on ``device`` (default: a
    tensor stays where it is, an ndarray goes to the CPU without a copy).

    The one place a host array becomes a tensor: uint16 becomes int32 and
    uint32 becomes int64, after the move, so the narrow bytes cross to the
    card. Host (numpy) arrays keep their dtype.
    """
    if not isinstance(array, torch.Tensor):
        array = torch.from_numpy(np.ascontiguousarray(array))
    if device is not None:
        array = array.to(device)
    wide = _WIDEN.get(array.dtype)
    return array if wide is None else array.to(wide)


def get_device(array) -> Device:
    """The :class:`Device` that ``array`` (ndarray, tensor or volume) lives on."""
    if isinstance(getattr(array, "device", None), Device):
        return array.device
    if isinstance(array, torch.Tensor):
        return Device(array.device)
    return cpu_device


def to_device(array, device: Union[int, str, Device, torch.device], **kwargs) -> Any:
    """Move ``array`` (ndarray / tensor / MedicalVolume) to ``device``.

    Host data stays a numpy array on the CPU; anything moved to a card
    becomes a ``torch.Tensor`` there.
    """
    device = Device(device)
    if hasattr(array, "to") and not isinstance(array, (np.ndarray, torch.Tensor)):
        return array.to(device, **kwargs)
    if device == cpu_device:
        return array.cpu().numpy() if isinstance(array, torch.Tensor) else np.asarray(array)
    if not isinstance(array, torch.Tensor):
        array = torch.from_numpy(np.ascontiguousarray(array))
    return as_tensor(array.to(device.ptdevice, **kwargs))
