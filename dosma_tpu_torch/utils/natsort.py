"""Natural sorting (replacement for the ``natsort`` package, unavailable here).

Splits digit runs so ``I2.dcm < I10.dcm``. API subset used by the I/O layer:
``natsorted``, ``index_natsorted``.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Sequence

__all__ = ["natsort_key", "natsorted", "index_natsorted"]

_SPLIT = re.compile(r"(\d+)")


def natsort_key(value) -> tuple:
    """Key function implementing natural ordering for strings and mixed tuples."""
    if isinstance(value, (tuple, list)):
        return tuple(natsort_key(v) for v in value)
    if isinstance(value, (int, float)):
        return (("", value),)
    s = str(value)
    parts = _SPLIT.split(s)
    key = []
    for p in parts:
        if p.isdigit():
            key.append(("", int(p)))
        elif p:
            key.append((p, -1))
    return tuple(key)


def natsorted(seq: Sequence, key: Optional[Callable] = None) -> List:
    keyfn = (lambda x: natsort_key(key(x))) if key is not None else natsort_key
    return sorted(seq, key=keyfn)


def index_natsorted(seq: Sequence, key: Optional[Callable] = None) -> List[int]:
    keyfn = (lambda i: natsort_key(key(seq[i]))) if key is not None else (lambda i: natsort_key(seq[i]))
    return sorted(range(len(seq)), key=keyfn)
