"""DICOM Part-10 reader: Implicit/Explicit VR LE, Explicit VR BE, Deflated.

From-scratch binary parser (pydicom is unavailable in this environment).
Supports the features the framework needs: file meta parsing, nested
sequences (defined and undefined length), private tags, uncompressed and
encapsulated (compressed) pixel data, and the Deflated Explicit VR LE
transfer syntax (PS3.5 A.5). Unknown transfer syntaxes raise a clear error.
"""

from __future__ import annotations

import io
import os
import struct
from typing import BinaryIO, List, Union

import numpy as np

from dosma_tpu_torch.core.io.dicom import tags as T
from dosma_tpu_torch.core.io.dicom.dataset import Dataset, Tag

__all__ = ["read_dicom", "read_dicom_bytes", "pixel_array"]

_UNDEFINED_LENGTH = 0xFFFFFFFF
_ITEM_TAG = 0xFFFEE000
_ITEM_DELIM_TAG = 0xFFFEE00D
_SEQ_DELIM_TAG = 0xFFFEE0DD


def _parse_value(vr: str, raw: bytes, endian: str = "<"):
    if vr in T.BINARY_VR_FMT:
        fmt, size = T.BINARY_VR_FMT[vr]
        n = len(raw) // size
        if n == 0:
            return None
        vals = list(struct.unpack(f"{endian}{n}{fmt}", raw[: n * size]))
        return vals[0] if n == 1 else vals
    if vr in T.NUMERIC_STRING_VRS:
        s = raw.decode("latin-1").strip("\x00 ")
        if not s:
            return None
        parts = [p.strip() for p in s.split("\\")]
        conv = float if vr == "DS" else int
        try:
            vals = [conv(p) for p in parts if p != ""]
        except ValueError:
            vals = parts
        if not vals:
            return None
        return vals[0] if len(vals) == 1 else vals
    if vr in T.STRING_VRS:
        s = raw.decode("latin-1", errors="replace").rstrip("\x00 ")
        if "\\" in s:
            return s.split("\\")
        return s
    # OB / OW / UN / unknown: raw bytes
    return raw


def _read_exact(fp: BinaryIO, n: int) -> bytes:
    data = fp.read(n)
    if len(data) != n:
        raise EOFError(f"Unexpected end of DICOM stream (wanted {n} bytes, got {len(data)})")
    return data


def _read_element_header(fp: BinaryIO, explicit: bool, endian: str = "<"):
    """Returns (tag_int, vr, length) or None at EOF."""
    hdr = fp.read(8)
    if len(hdr) < 8:
        if len(hdr) == 0:
            return None
        raise EOFError("Truncated DICOM element header")
    group, elem = struct.unpack(f"{endian}HH", hdr[:4])
    tag = (group << 16) | elem

    if tag in (_ITEM_TAG, _ITEM_DELIM_TAG, _SEQ_DELIM_TAG):
        (length,) = struct.unpack(f"{endian}I", hdr[4:8])
        return tag, None, length

    if explicit:
        vr = hdr[4:6].decode("ascii", errors="replace")
        if vr in T.LONG_VRS:
            (length,) = struct.unpack(f"{endian}I", _read_exact(fp, 4))
        else:
            (length,) = struct.unpack(f"{endian}H", hdr[6:8])
    else:
        # Private tags (odd group) resolve later, creator-gated, in the
        # dataset loop; standard tags resolve from the public dictionary.
        if (tag >> 16) % 2 == 1:
            vr = "UN"
        else:
            vr = T.TAG_TO_VR.get(tag, "UN")
        (length,) = struct.unpack(f"{endian}I", hdr[4:8])
    return tag, vr, length


def _read_sequence(fp: BinaryIO, explicit: bool, length: int, endian: str = "<") -> List[Dataset]:
    """Read SQ items. ``length`` may be undefined (0xFFFFFFFF)."""
    items = []
    end = None if length == _UNDEFINED_LENGTH else fp.tell() + length
    while True:
        if end is not None and fp.tell() >= end:
            break
        hdr = _read_element_header(fp, explicit, endian)
        if hdr is None:
            break
        tag, _vr, item_len = hdr
        if tag == _SEQ_DELIM_TAG:
            break
        if tag != _ITEM_TAG:
            raise ValueError(f"Expected Item tag in sequence, got {Tag(tag)!r}")
        if item_len == _UNDEFINED_LENGTH:
            items.append(_read_dataset(fp, explicit, stop_at_item_delim=True, endian=endian))
        else:
            sub = io.BytesIO(_read_exact(fp, item_len))
            items.append(_read_dataset(sub, explicit, endian=endian))
    return items


def _read_encapsulated(fp: BinaryIO):
    """Read encapsulated pixel data (PS3.5 A.4): BOT item + fragments."""
    from dosma_tpu_torch.core.io.dicom.codecs import EncapsulatedPixelData

    bot: List[int] = []
    fragments: List[bytes] = []
    first = True
    while True:
        group, elem, length = struct.unpack("<HHI", _read_exact(fp, 8))
        tag = (group << 16) | elem
        if tag == _SEQ_DELIM_TAG:
            break
        if tag != _ITEM_TAG:
            raise ValueError(f"Expected Item tag in encapsulated pixel data, got {Tag(tag)!r}")
        payload = _read_exact(fp, length)
        if first:
            first = False
            if length:
                bot = list(struct.unpack(f"<{length // 4}I", payload))
            continue  # first item is always the Basic Offset Table
        fragments.append(payload)
    return EncapsulatedPixelData(fragments, bot)


def _read_dataset(
    fp: BinaryIO,
    explicit: bool,
    stop_at_item_delim: bool = False,
    stop_before_pixels: bool = False,
    endian: str = "<",
) -> Dataset:
    ds = Dataset()
    private_creators: dict = {}
    while True:
        hdr = _read_element_header(fp, explicit, endian)
        if hdr is None:
            break
        tag, vr, length = hdr
        if tag == _ITEM_DELIM_TAG and stop_at_item_delim:
            break
        if tag in (_ITEM_DELIM_TAG, _SEQ_DELIM_TAG):
            continue
        if vr == "SQ" or (length == _UNDEFINED_LENGTH and vr in ("UN", None)):
            value = _read_sequence(fp, explicit, length, endian)
            ds.add_new(tag, "SQ", value)
            continue
        if tag == T.DICT["PixelData"][0] and stop_before_pixels:
            break
        if length == _UNDEFINED_LENGTH:
            # Encapsulated (compressed) pixel data: item-framed fragments.
            ds.add_new(tag, vr or "OB", _read_encapsulated(fp))
            continue
        raw = _read_exact(fp, length)
        if vr is None or vr == "UN":
            vr = _resolve_implicit_vr(tag, private_creators)
        ds.add_new(tag, vr, _parse_value(vr, raw, endian))
        group, elem = tag >> 16, tag & 0xFFFF
        if group % 2 == 1 and 0x0010 <= elem <= 0x00FF:
            # Private-creator element: remember which vendor owns block
            # ``elem`` of this group.
            try:
                private_creators[(group, elem)] = str(ds[tag].value)
            except Exception:
                pass
    return ds


def _resolve_implicit_vr(tag: int, private_creators: dict) -> str:
    group = tag >> 16
    if group % 2 == 1:
        entry = T.PRIVATE_TAG_VR.get(tag)
        if entry is not None:
            prefix, vr = entry
            block = (tag >> 8) & 0xFF
            creator = private_creators.get((group, block), "")
            if isinstance(creator, bytes):
                creator = creator.decode("latin-1", errors="replace")
            if str(creator).strip().startswith(prefix):
                return vr
        return "UN"
    return T.TAG_TO_VR.get(tag, "UN")


def read_dicom_bytes(data: bytes, stop_before_pixels: bool = False) -> Dataset:
    """Parse a DICOM Part-10 (or raw dataset) byte string."""
    fp = io.BytesIO(data)

    # Part-10 preamble.
    preamble = fp.read(132)
    if len(preamble) >= 132 and preamble[128:132] == b"DICM":
        pass  # positioned after magic
    else:
        fp.seek(0)

    # File meta group (0002): always Explicit VR LE.
    file_meta = Dataset()
    transfer_syntax = T.IMPLICIT_VR_LE
    pos = fp.tell()
    probe = fp.read(2)
    fp.seek(pos)
    if len(probe) == 2 and struct.unpack("<H", probe)[0] == 0x0002:
        while True:
            pos = fp.tell()
            probe = fp.read(2)
            if len(probe) < 2:
                break
            group = struct.unpack("<H", probe)[0]
            fp.seek(pos)
            if group != 0x0002:
                break
            hdr = _read_element_header(fp, explicit=True)
            tag, vr, length = hdr
            raw = _read_exact(fp, length)
            file_meta.add_new(tag, vr, _parse_value(vr, raw))
        ts = file_meta.get("TransferSyntaxUID")
        if ts:
            transfer_syntax = ts

    endian = "<"
    if transfer_syntax == T.EXPLICIT_VR_BE:
        # Retired but present in legacy (notably GE) archives: the data
        # set is explicit VR with BIG-endian values; file meta stays LE.
        endian = ">"
    elif transfer_syntax == T.DEFLATED_EXPLICIT_VR_LE:
        # PS3.5 A.5: everything after the file meta group is one raw
        # (headerless, RFC 1951) deflate stream wrapping an Explicit VR LE
        # dataset. Inflate, then parse as usual. The reference gets this
        # free through pydicom (``dosma/core/io/dicom_io.py:264-270``).
        import zlib

        fp = io.BytesIO(zlib.decompress(fp.read(), wbits=-zlib.MAX_WBITS))
    elif transfer_syntax not in (T.IMPLICIT_VR_LE, T.EXPLICIT_VR_LE):
        from dosma_tpu_torch.core.io.dicom.codecs import (
            COMPRESSED_SYNTAXES,
            unsupported_syntax_error,
        )

        if transfer_syntax not in COMPRESSED_SYNTAXES:
            raise unsupported_syntax_error(transfer_syntax)
    # Every syntax other than Implicit VR LE encodes the dataset explicit.
    explicit = transfer_syntax != T.IMPLICIT_VR_LE

    # Heuristic fallback when no file meta: detect explicit VR by probing.
    if len(file_meta) == 0:
        pos = fp.tell()
        probe = fp.read(6)
        fp.seek(pos)
        if len(probe) == 6:
            maybe_vr = probe[4:6].decode("ascii", errors="replace")
            explicit = maybe_vr.isalpha() and maybe_vr.isupper()

    ds = _read_dataset(fp, explicit, stop_before_pixels=stop_before_pixels, endian=endian)
    ds.file_meta = file_meta if len(file_meta) else None
    return ds


def read_dicom(path_or_file: Union[str, os.PathLike, BinaryIO], stop_before_pixels: bool = False) -> Dataset:
    """Read a DICOM file from a path or file-like object."""
    if hasattr(path_or_file, "read"):
        return read_dicom_bytes(path_or_file.read(), stop_before_pixels=stop_before_pixels)
    with open(path_or_file, "rb") as f:
        return read_dicom_bytes(f.read(), stop_before_pixels=stop_before_pixels)


def pixel_array(ds: Dataset) -> np.ndarray:
    """Decode uncompressed PixelData into an ndarray of shape (Rows, Columns)
    or (NumberOfFrames, Rows, Columns)."""
    if "PixelData" not in ds:
        raise AttributeError("Dataset has no PixelData")
    raw = ds["PixelData"].value
    bits = int(ds.get("BitsAllocated", 16))
    from dosma_tpu_torch.core.io.dicom.codecs import EncapsulatedPixelData, decode_frames

    signed = int(ds.get("PixelRepresentation", 0)) == 1
    if isinstance(raw, EncapsulatedPixelData):
        ts = ds.file_meta.get("TransferSyntaxUID") if ds.file_meta is not None else None
        nframes = ds.get("NumberOfFrames")
        out = decode_frames(
            raw,
            ts,
            rows=int(ds.get("Rows")),
            cols=int(ds.get("Columns")),
            samples=int(ds.get("SamplesPerPixel", 1)),
            bits_allocated=bits,
            nframes=int(nframes) if nframes else 1,
        )
        # Coerce to the dtype the header declares. Codecs that work on
        # unsigned sample bytes need a same-width REINTERPRET when
        # PixelRepresentation=1 (the bytes ARE two's-complement); codecs
        # that decode true signed components (J2K Ssiz sign bit) may
        # surface a wider container (e.g. int32 for 16-bit) whose values
        # fit the declared width by construction — narrow those. Other
        # widths (e.g. 1-bit data) keep the decoder's output.
        if bits not in (8, 16, 32):
            return out
        target = np.dtype(("i" if signed else "u") + str(bits // 8))
        if out.dtype != target:
            if signed and out.dtype.kind == "u" and out.dtype.itemsize == target.itemsize:
                out = out.view(target)
            else:
                out = out.astype(target)
        return out
    rows = int(ds.get("Rows"))
    cols = int(ds.get("Columns"))
    samples = int(ds.get("SamplesPerPixel", 1))
    nframes = ds.get("NumberOfFrames")
    nframes = int(nframes) if nframes else 1

    if bits == 8:
        dtype = np.int8 if signed else np.uint8
    elif bits == 16:
        dtype = np.int16 if signed else np.uint16
    elif bits == 32:
        dtype = np.int32 if signed else np.uint32
    else:
        raise ValueError(f"Unsupported BitsAllocated: {bits}")

    ts = ds.file_meta.get("TransferSyntaxUID") if ds.file_meta is not None else None
    byteorder = ">" if ts == T.EXPLICIT_VR_BE else "<"
    arr = np.frombuffer(raw, dtype=np.dtype(dtype).newbyteorder(byteorder))
    if byteorder == ">":
        arr = arr.astype(np.dtype(dtype).newbyteorder("="))  # native for downstream
    expected = rows * cols * samples * nframes
    arr = arr[:expected]
    if samples > 1:
        shape = (nframes, rows, cols, samples) if nframes > 1 else (rows, cols, samples)
    else:
        shape = (nframes, rows, cols) if nframes > 1 else (rows, cols)
    return arr.reshape(shape)


# Attach pixel_array as a Dataset property (pydicom-compatible surface).
def _pixel_array_prop(self):
    return pixel_array(self)


Dataset.pixel_array = property(_pixel_array_prop)
