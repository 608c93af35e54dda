"""Dataset / DataElement / Tag model (pydicom-compatible surface).

The reference accesses headers as ``ds.EchoTime``, ``ds["EchoTime"].value``,
``0x001910B6 in ds``, ``ds[tag].value`` etc. (e.g.
``dosma/core/med_volume.py:690-700``,
``dosma/scan_sequences/scans.py:88-116``). This module
provides that surface without pydicom.
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

from dosma_tpu_torch.core.io.dicom import tags as T

__all__ = ["Tag", "DataElement", "Dataset"]


class Tag(int):
    """A DICOM tag as a single int ``(group << 16) | element``."""

    def __new__(cls, arg, elem: Optional[int] = None):
        if elem is not None:
            return super().__new__(cls, ((arg & 0xFFFF) << 16) | (elem & 0xFFFF))
        if isinstance(arg, tuple):
            return super().__new__(cls, ((arg[0] & 0xFFFF) << 16) | (arg[1] & 0xFFFF))
        if isinstance(arg, str):
            kw = T.KEYWORD_TO_TAG.get(arg)
            if kw is None:
                raise KeyError(f"Unknown DICOM keyword: {arg}")
            return super().__new__(cls, kw)
        return super().__new__(cls, int(arg))

    @property
    def group(self) -> int:
        return (int(self) >> 16) & 0xFFFF

    @property
    def element(self) -> int:
        return int(self) & 0xFFFF

    @property
    def is_private(self) -> bool:
        return self.group % 2 == 1

    @property
    def keyword(self) -> str:
        return T.TAG_TO_KEYWORD.get(int(self), "")

    def __repr__(self):
        return f"({self.group:04X},{self.element:04X})"


def _infer_vr(tag: Tag, value: Any) -> str:
    vr = T.TAG_TO_VR.get(int(tag))
    if vr:
        return vr
    if isinstance(value, bytes):
        return "OB"
    if isinstance(value, int):
        return "IS"
    if isinstance(value, float):
        return "DS"
    if isinstance(value, (list, tuple)) and value and isinstance(value[0], (int, float)):
        return "DS"
    return "LO"


_IMMUTABLE = frozenset((str, int, float, bool, bytes, type(None)))


def _copy_value(value, memo):
    """A deep copy of an element's value. Immutable scalars, and lists of
    them (the common values of a header), skip ``copy.deepcopy``'s
    generic walk, which costs more than the rest of a header's copy."""
    import copy as _copy

    if type(value) in _IMMUTABLE:
        return value
    if type(value) is list and all(type(v) in _IMMUTABLE for v in value):
        return value.copy()
    return _copy.deepcopy(value, memo)


class DataElement:
    """One DICOM attribute: tag + VR + value."""

    __slots__ = ("tag", "VR", "value")

    def __init__(self, tag, VR: str, value: Any):
        self.tag = Tag(tag)
        self.VR = VR
        self.value = value

    @property
    def keyword(self) -> str:
        return self.tag.keyword

    def __eq__(self, other):
        return (
            isinstance(other, DataElement)
            and int(self.tag) == int(other.tag)
            and self.VR == other.VR
            and self.value == other.value
        )

    def __repr__(self):
        name = self.keyword or "Private"
        val = self.value
        if isinstance(val, bytes) and len(val) > 16:
            val = f"<{len(val)} bytes>"
        return f"{self.tag!r} {self.VR} {name}: {val!r}"


class Dataset:
    """Ordered collection of DataElements with keyword attribute access."""

    def __init__(self, elements: Optional[dict] = None):
        # Bypass __setattr__ for internal state.
        object.__setattr__(self, "_dict", dict(elements) if elements else {})
        object.__setattr__(self, "file_meta", None)

    # -- dict-like interface -------------------------------------------------
    def _resolve(self, key) -> Tag:
        if isinstance(key, DataElement):
            return key.tag
        return Tag(key)

    def __contains__(self, key) -> bool:
        try:
            return int(self._resolve(key)) in self._dict
        except KeyError:
            return False

    def __getitem__(self, key) -> DataElement:
        tag = self._resolve(key)
        try:
            return self._dict[int(tag)]
        except KeyError:
            raise KeyError(f"Tag {tag!r} not found in dataset")

    def __setitem__(self, key, value):
        tag = self._resolve(key)
        if isinstance(value, DataElement):
            self._dict[int(tag)] = value
        else:
            self._dict[int(tag)] = DataElement(tag, _infer_vr(tag, value), value)

    def __delitem__(self, key):
        del self._dict[int(self._resolve(key))]

    def __iter__(self) -> Iterator[DataElement]:
        for tag in sorted(self._dict):
            yield self._dict[tag]

    def __len__(self) -> int:
        return len(self._dict)

    def keys(self):
        return [Tag(t) for t in sorted(self._dict)]

    def get(self, key, default=None):
        try:
            return self[key].value
        except KeyError:
            return default

    def add_new(self, tag, VR: str, value):
        tag = Tag(tag)
        self._dict[int(tag)] = DataElement(tag, VR, value)

    def set_value(self, key, value, create: bool = True):
        """Set value for ``key``, creating the element if needed."""
        tag = self._resolve(key)
        if int(tag) in self._dict:
            self._dict[int(tag)].value = value
        elif create:
            self[tag] = value
        else:
            raise KeyError(f"Tag {tag!r} not found in dataset")

    # -- attribute access ----------------------------------------------------
    def __getattr__(self, name: str):
        if name.startswith("_") or name in ("file_meta",):
            raise AttributeError(name)
        tag = T.KEYWORD_TO_TAG.get(name)
        if tag is not None and tag in self._dict:
            return self._dict[tag].value
        raise AttributeError(f"Dataset has no attribute {name!r}")

    def __setattr__(self, name: str, value):
        if name.startswith("_") or name == "file_meta":
            object.__setattr__(self, name, value)
            return
        tag = T.KEYWORD_TO_TAG.get(name)
        if tag is None:
            raise TypeError(f"Unknown DICOM keyword: {name}")
        self[tag] = value

    def __dir__(self):
        return sorted(set(list(super().__dir__()) + [e.keyword for e in self if e.keyword]))

    # -- misc ----------------------------------------------------------------
    def copy(self) -> "Dataset":
        import copy as _copy

        return _copy.deepcopy(self)

    def __deepcopy__(self, memo):
        import copy as _copy

        new = Dataset()
        elements = {}
        for t, e in self._dict.items():
            value = e.value
            if type(value) not in _IMMUTABLE:
                value = _copy_value(value, memo)
            # The tag is already a Tag: skip DataElement's conversion.
            el = object.__new__(DataElement)
            el.tag, el.VR, el.value = e.tag, e.VR, value
            elements[t] = el
        object.__setattr__(new, "_dict", elements)
        object.__setattr__(new, "file_meta", _copy.deepcopy(self.file_meta, memo))
        return new

    def __eq__(self, other):
        return isinstance(other, Dataset) and self._dict == other._dict

    def __repr__(self):
        lines = [repr(e) for e in self]
        return "\n".join(lines) if lines else "Dataset()"

    # Pickle support (object arrays of headers are pickled in scan save/load).
    def __getstate__(self):
        return {
            "elements": [(int(e.tag), e.VR, e.value) for e in self._dict.values()],
            "file_meta": self.file_meta.__getstate__() if self.file_meta is not None else None,
        }

    def __setstate__(self, state):
        object.__setattr__(self, "_dict", {})
        object.__setattr__(self, "file_meta", None)
        for tag, vr, value in state["elements"]:
            self._dict[tag] = DataElement(tag, vr, value)
        if state.get("file_meta") is not None:
            fm = Dataset()
            fm.__setstate__(state["file_meta"])
            object.__setattr__(self, "file_meta", fm)
