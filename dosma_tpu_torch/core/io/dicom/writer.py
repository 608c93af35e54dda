"""DICOM Part-10 writer: Explicit VR Little Endian.

Counterpart to :mod:`dosma_tpu_torch.core.io.dicom.reader`. Serializes a
:class:`Dataset` (including nested sequences and private tags) to a valid
Part-10 file readable by pydicom/other toolkits.
"""

from __future__ import annotations

import os
import secrets
import struct
from typing import BinaryIO, Union

import numpy as np

from dosma_tpu_torch.core.io.dicom import tags as T
from dosma_tpu_torch.core.io.dicom.dataset import DataElement, Dataset

__all__ = ["write_dicom", "generate_uid"]


def generate_uid() -> str:
    """Generate a DICOM UID under the 2.25 (UUID-derived) root."""
    return f"{T.UID_ROOT}.{int.from_bytes(secrets.token_bytes(12), 'big')}"


def _encode_value(vr: str, value) -> bytes:
    if value is None:
        return b""
    if vr in T.BINARY_VR_FMT:
        fmt, _size = T.BINARY_VR_FMT[vr]
        vals = value if isinstance(value, (list, tuple)) else [value]
        return struct.pack(f"<{len(vals)}{fmt}", *[int(v) if fmt in "HhIi" else float(v) for v in vals])
    if vr in T.NUMERIC_STRING_VRS:
        vals = value if isinstance(value, (list, tuple)) else [value]
        if vr == "DS":
            parts = []
            for v in vals:
                s = f"{float(v):.10g}"
                parts.append(s[:16])
            s = "\\".join(parts)
        else:
            s = "\\".join(str(int(v)) for v in vals)
        raw = s.encode("ascii")
    elif vr in T.STRING_VRS:
        if isinstance(value, (list, tuple)):
            s = "\\".join(str(v) for v in value)
        else:
            s = str(value)
        raw = s.encode("latin-1")
        if vr == "UI":
            if len(raw) % 2:
                raw += b"\x00"
            return raw
    elif isinstance(value, bytes):
        raw = value
    else:
        raw = str(value).encode("latin-1")
    if len(raw) % 2:
        # PS3.5: binary VRs pad with NUL; text VRs pad with space.
        raw += b"\x00" if vr in ("OB", "OW", "OL", "OD", "OF", "UN") else b" "
    return raw


def _write_element(fp: BinaryIO, elem: DataElement):
    from dosma_tpu_torch.core.io.dicom.codecs import EncapsulatedPixelData

    tag = elem.tag
    vr = elem.VR
    fp.write(struct.pack("<HH", tag.group, tag.element))

    if isinstance(elem.value, EncapsulatedPixelData):
        # Encapsulated pixel data: OB, undefined length, item-framed.
        fp.write(b"OB\x00\x00")
        fp.write(struct.pack("<I", 0xFFFFFFFF))
        bot = elem.value.basic_offset_table
        fp.write(struct.pack("<HHI", 0xFFFE, 0xE000, 4 * len(bot)))
        if bot:
            fp.write(struct.pack(f"<{len(bot)}I", *bot))
        for frag in elem.value.fragments:
            if len(frag) % 2:
                frag += b"\x00"
            fp.write(struct.pack("<HHI", 0xFFFE, 0xE000, len(frag)) + frag)
        fp.write(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
        return

    if vr == "SQ":
        body = b""
        for item in elem.value:
            item_bytes = _dataset_bytes(item)
            body += struct.pack("<HHI", 0xFFFE, 0xE000, len(item_bytes)) + item_bytes
        fp.write(b"SQ\x00\x00")
        fp.write(struct.pack("<I", len(body)))
        fp.write(body)
        return

    raw = _encode_value(vr, elem.value)
    if vr in T.LONG_VRS:
        fp.write(vr.encode("ascii") + b"\x00\x00")
        fp.write(struct.pack("<I", len(raw)))
    else:
        if len(raw) > 0xFFFF:
            # Fall back to UN long form for oversize values.
            fp.write(b"UN\x00\x00")
            fp.write(struct.pack("<I", len(raw)))
        else:
            fp.write(vr.encode("ascii"))
            fp.write(struct.pack("<H", len(raw)))
    fp.write(raw)


def _dataset_bytes(ds: Dataset, include_group2: bool = False) -> bytes:
    import io

    buf = io.BytesIO()
    for elem in ds:
        if elem.tag.group == 0x0002 and not include_group2:
            continue
        _write_element(buf, elem)
    return buf.getvalue()


def _build_file_meta(ds: Dataset, transfer_syntax: str = None) -> Dataset:
    fm = Dataset()
    existing = ds.file_meta
    sop_class = ds.get("SOPClassUID", T.MR_IMAGE_STORAGE)
    sop_instance = ds.get("SOPInstanceUID") or generate_uid()
    fm.add_new(T.DICT["FileMetaInformationVersion"][0], "OB", b"\x00\x01")
    fm.add_new(T.DICT["MediaStorageSOPClassUID"][0], "UI", sop_class)
    fm.add_new(T.DICT["MediaStorageSOPInstanceUID"][0], "UI", sop_instance)
    fm.add_new(T.DICT["TransferSyntaxUID"][0], "UI", transfer_syntax or T.EXPLICIT_VR_LE)
    fm.add_new(T.DICT["ImplementationClassUID"][0], "UI", f"{T.UID_ROOT}.1.999")
    if existing is not None:
        for elem in existing:
            if elem.tag.element in (0x0000,):
                continue
            if int(elem.tag) == T.DICT["TransferSyntaxUID"][0]:
                continue  # transfer syntax is decided above
            fm.add_new(elem.tag, elem.VR, elem.value)
    return fm


def write_dicom(
    ds: Dataset,
    path_or_file: Union[str, os.PathLike, BinaryIO],
    transfer_syntax: str = None,
):
    """Write ``ds`` as a Part-10 file.

    ``transfer_syntax`` selects the encoding: default Explicit VR Little
    Endian; pass a UID from :data:`codecs.COMPRESSED_SYNTAXES` (RLE or
    JPEG Lossless) to compress PixelData on the way out. A dataset whose
    PixelData is already :class:`EncapsulatedPixelData` keeps its fragments
    and the transfer syntax recorded in ``ds.file_meta``.
    """
    from dosma_tpu_torch.core.io.dicom import codecs

    pixel_elem = ds["PixelData"] if "PixelData" in ds else None
    already_encapsulated = pixel_elem is not None and isinstance(
        pixel_elem.value, codecs.EncapsulatedPixelData
    )
    if transfer_syntax is None and already_encapsulated:
        transfer_syntax = ds.file_meta.get("TransferSyntaxUID") if ds.file_meta else None
        if transfer_syntax not in codecs.COMPRESSED_SYNTAXES:
            raise ValueError(
                "Dataset carries encapsulated PixelData but no known compressed "
                "TransferSyntaxUID; pass transfer_syntax= explicitly"
            )
    stored_syntax = ds.file_meta.get("TransferSyntaxUID") if ds.file_meta else None
    if transfer_syntax in codecs.COMPRESSED_SYNTAXES and (
        not already_encapsulated or transfer_syntax != stored_syntax
    ):
        # Compress — or TRANSCODE when the stored fragments use a different
        # syntax (pixel_array decodes them first).
        from dosma_tpu_torch.core.io.dicom.reader import pixel_array

        nframes = ds.get("NumberOfFrames")
        nframes = int(nframes) if nframes else 1
        encapsulated = codecs.encode_frames(pixel_array(ds), transfer_syntax, nframes=nframes)
        ds = ds.copy()
        ds.add_new(T.DICT["PixelData"][0], "OB", encapsulated)
        if transfer_syntax in (
            codecs.JPEG_BASELINE, codecs.JPEG_EXTENDED,
            codecs.JPEG_LS_NEAR_LOSSLESS, codecs.JPEG_2000,
        ):
            # Lossy provenance (PS3.3 C.7.6.1.1.5): downstream quantitative
            # pipelines must be able to detect degraded pixel data.
            ds.add_new(0x00282110, "CS", "01")
            methods = {
                codecs.JPEG_BASELINE: "ISO_10918_1",
                codecs.JPEG_EXTENDED: "ISO_10918_1",
                codecs.JPEG_LS_NEAR_LOSSLESS: "ISO_14495_1",
                codecs.JPEG_2000: "ISO_15444_1",
            }
            ds.add_new(0x00282114, "CS", methods[transfer_syntax])
    elif (
        transfer_syntax in (None, T.EXPLICIT_VR_LE, T.DEFLATED_EXPLICIT_VR_LE)
        and already_encapsulated
    ):
        # Decompress request: expand the fragments back to native bytes so
        # the written file matches the uncompressed syntax it declares.
        from dosma_tpu_torch.core.io.dicom.reader import pixel_array

        arr = pixel_array(ds)
        ds = ds.copy()
        ds.add_new(T.DICT["PixelData"][0], "OW", np.ascontiguousarray(arr).tobytes())
        if transfer_syntax != T.DEFLATED_EXPLICIT_VR_LE:
            transfer_syntax = T.EXPLICIT_VR_LE
    elif transfer_syntax not in (None, T.EXPLICIT_VR_LE, T.DEFLATED_EXPLICIT_VR_LE) and not (
        transfer_syntax in codecs.COMPRESSED_SYNTAXES
    ):
        raise NotImplementedError(f"Cannot write transfer syntax {transfer_syntax}")

    own = False
    if hasattr(path_or_file, "write"):
        fp = path_or_file
    else:
        fp = open(path_or_file, "wb")
        own = True
    try:
        fp.write(b"\x00" * 128 + b"DICM")

        fm = _build_file_meta(ds, transfer_syntax)
        fm_bytes = _dataset_bytes(fm, include_group2=True)
        # Group length element first (required by Part 10).
        fp.write(struct.pack("<HH", 0x0002, 0x0000))
        fp.write(b"UL")
        fp.write(struct.pack("<H", 4))
        fp.write(struct.pack("<I", len(fm_bytes)))
        fp.write(fm_bytes)

        body = _dataset_bytes(ds)
        if transfer_syntax == T.DEFLATED_EXPLICIT_VR_LE:
            # PS3.5 A.5: the post-meta dataset is one raw RFC 1951 stream.
            import zlib

            co = zlib.compressobj(9, zlib.DEFLATED, -zlib.MAX_WBITS)
            body = co.compress(body) + co.flush()
        fp.write(body)
    finally:
        if own:
            fp.close()
