"""JPEG 2000 codec dispatch for DICOM pixel data.

Covers the last two compressed transfer syntaxes:

- **JPEG 2000 Lossless** ``1.2.840.10008.1.2.4.90`` (reversible 5/3 DWT)
  — decoded by the FROM-SCRATCH in-repo codec
  (:mod:`dosma_tpu_torch.core.io.dicom.j2k`: MQ coder, EBCOT tier-1/2, tag
  trees, inverse 5/3 DWT), like every other codec in this package.
- **JPEG 2000** ``1.2.840.10008.1.2.4.91`` (irreversible 9/7 DWT, lossy)
  — delegated to Pillow/OpenJPEG, the reference's own design point for
  J2K (pydicom handler dispatch,
  ``dosma/core/io/dicom_io.py:264-270``).

Encoding: lossless export uses the from-scratch in-repo ENCODER too
(:func:`dosma_tpu_torch.core.io.dicom.j2k.j2k_encode` — forward 5/3, tier-1 MQ
encoding, tag-tree packet headers; OpenJPEG decodes its output bit-exactly
in tests). Only lossy encode rides Pillow; when Pillow lacks OpenJPEG
that path surfaces an actionable transcode error.

DICOM PS3.5 A.4.4 encapsulates the raw JPEG 2000 CODESTREAM (SOC marker
``FF4F``), not a JP2 container — Pillow writes raw codestreams when the
target filename carries a ``.j2k`` suffix, so encoding goes through a
temp file.
"""

from __future__ import annotations

import io
import os
import tempfile

import numpy as np

__all__ = ["jpeg_2000_decode", "jpeg_2000_encode", "pil_j2k_available"]


def pil_j2k_available() -> bool:
    try:
        from PIL import features

        return bool(features.check("jpg_2000"))
    except Exception:  # pragma: no cover - Pillow absent
        return False


def _require_pil():
    if not pil_j2k_available():
        raise NotImplementedError(
            "JPEG 2000 support requires Pillow built with OpenJPEG "
            "(PIL.features.check('jpg_2000')). Install pillow with openjpeg, "
            "or transcode the series (e.g. `gdcmconv --raw`)."
        )


def jpeg_2000_decode(data: bytes) -> np.ndarray:
    """Decode a JPEG 2000 codestream (or JP2 container) to an ndarray.

    The LOSSLESS profile (reversible 5/3, transfer syntax .90 — the only
    J2K form the reference pipelines produce) decodes with the from-
    scratch in-repo codec (:mod:`dosma_tpu_torch.core.io.dicom.j2k`); lossy 9/7
    codestreams (syntax .91) and exotic coding options fall through to
    Pillow/OpenJPEG when present.
    """
    from dosma_tpu_torch.core.io import _native
    from dosma_tpu_torch.core.io.dicom.j2k import Unsupported, j2k_decode

    try:
        if _native.codecs_available():
            return _native.j2k_decode(data)
        return j2k_decode(data)
    except Unsupported:
        pass  # 9/7 lossy / out-of-profile options -> Pillow below
    except NotImplementedError:
        # Native says out-of-profile: give the Python twin a chance (it
        # may support the feature) before Pillow.
        try:
            return j2k_decode(data)
        except Unsupported:
            pass
    _require_pil()
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    arr = np.asarray(im)
    if arr.dtype == np.int32:
        # OpenJPEG surfaces >8-bit grayscale as mode "I"; DICOM samples are
        # unsigned here (PixelRepresentation handled by the caller).
        arr = arr.astype(np.uint16)
    return arr


def jpeg_2000_encode(frame: np.ndarray, lossless: bool = True) -> bytes:
    """Encode one grayscale frame as a raw JPEG 2000 codestream.

    Lossless (the DICOM .90 form) encodes with the from-scratch in-repo
    codec; lossy (9/7) rides Pillow/OpenJPEG.
    """
    arr = np.ascontiguousarray(frame)
    if arr.ndim != 2:
        raise NotImplementedError("JPEG 2000 encoder supports 1 component")
    if lossless and arr.dtype in (np.uint8, np.uint16, np.int8, np.int16):
        from dosma_tpu_torch.core.io.dicom.j2k import j2k_encode

        return j2k_encode(arr)
    _require_pil()
    from PIL import Image

    if arr.dtype == np.uint8:
        im = Image.frombytes("L", (arr.shape[1], arr.shape[0]), arr.tobytes())
    elif arr.dtype == np.uint16:
        im = Image.frombytes("I;16", (arr.shape[1], arr.shape[0]), arr.tobytes())
    else:
        raise ValueError("JPEG 2000 encoder expects uint8/uint16 input")

    # Pillow only emits a RAW codestream (DICOM's required form) when the
    # filename ends in .j2k; BytesIO targets get a JP2 container.
    fd, path = tempfile.mkstemp(suffix=".j2k")
    os.close(fd)
    try:
        if lossless:
            im.save(path, irreversible=False)
        else:
            im.save(path, irreversible=True, quality_mode="rates", quality_layers=[10])
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)
