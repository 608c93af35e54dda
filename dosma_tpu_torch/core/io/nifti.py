"""NIfTI-1 file format reader/writer (numpy only).

A copy of ``dosma_tpu/core/io/nifti.py``, which the port cannot import
(importing ``dosma_tpu`` loads jax). It implements the NIfTI-1 binary format
directly: 348-byte header, sform/qform affine handling, Fortran-order data
layout, ``.nii``/``.nii.gz`` support, and optional memory-mapping for
uncompressed files. Files written by either package read back identically
in the other.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

__all__ = ["read_nifti", "write_nifti"]

_HDR_SIZE = 348
_MAGIC_SINGLE = b"n+1\x00"

# NIfTI datatype codes.
_DTYPE_TO_CODE = {
    np.dtype(np.uint8): (2, 8),
    np.dtype(np.int16): (4, 16),
    np.dtype(np.int32): (8, 32),
    np.dtype(np.float32): (16, 32),
    np.dtype(np.complex64): (32, 64),
    np.dtype(np.float64): (64, 64),
    np.dtype(np.int8): (256, 8),
    np.dtype(np.uint16): (512, 16),
    np.dtype(np.uint32): (768, 32),
    np.dtype(np.int64): (1024, 64),
    np.dtype(np.uint64): (1280, 64),
    np.dtype(np.complex128): (1792, 128),
    np.dtype(bool): (2, 8),
}
_CODE_TO_DTYPE = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 32: np.complex64,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
    1024: np.int64, 1280: np.uint64, 1792: np.complex128,
}

_HDR_STRUCT = struct.Struct(
    "<i"    # sizeof_hdr
    "10s"   # data_type (unused)
    "18s"   # db_name (unused)
    "i"     # extents
    "h"     # session_error
    "c"     # regular
    "B"     # dim_info
    "8h"    # dim
    "3f"    # intent_p1-3
    "h"     # intent_code
    "h"     # datatype
    "h"     # bitpix
    "h"     # slice_start
    "8f"    # pixdim
    "f"     # vox_offset
    "f"     # scl_slope
    "f"     # scl_inter
    "h"     # slice_end
    "B"     # slice_code
    "B"     # xyzt_units
    "f"     # cal_max
    "f"     # cal_min
    "f"     # slice_duration
    "f"     # toffset
    "i"     # glmax
    "i"     # glmin
    "80s"   # descrip
    "24s"   # aux_file
    "h"     # qform_code
    "h"     # sform_code
    "6f"    # quatern_b,c,d, qoffset_x,y,z
    "4f"    # srow_x
    "4f"    # srow_y
    "4f"    # srow_z
    "16s"   # intent_name
    "4s"    # magic
)
assert _HDR_STRUCT.size == _HDR_SIZE, _HDR_STRUCT.size


def _quaternion_to_affine(b, c, d, qfac, pixdim, offsets) -> np.ndarray:
    a2 = 1.0 - (b * b + c * c + d * d)
    a = np.sqrt(max(a2, 0.0))
    R = np.array(
        [
            [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
            [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
        ]
    )
    spacing = np.array([pixdim[0], pixdim[1], pixdim[2] * (qfac if qfac != 0 else 1.0)])
    affine = np.eye(4)
    affine[:3, :3] = R * spacing[np.newaxis, :]
    affine[:3, 3] = offsets
    return affine


def _affine_to_quaternion(affine) -> Tuple[float, float, float, float, np.ndarray]:
    """Return (qb, qc, qd, qfac, spacing) for the qform encoding of ``affine``."""
    R = np.array(affine[:3, :3], dtype=np.float64)
    spacing = np.sqrt((R**2).sum(axis=0))
    spacing[spacing == 0] = 1.0
    Rn = R / spacing[np.newaxis, :]
    qfac = 1.0
    if np.linalg.det(Rn) < 0:
        Rn = Rn.copy()
        Rn[:, 2] *= -1
        qfac = -1.0
    # Rotation matrix → quaternion (Shepperd's method, numerically safe).
    t = np.trace(Rn)
    if t > 0:
        w = np.sqrt(1.0 + t) / 2.0
        b = (Rn[2, 1] - Rn[1, 2]) / (4 * w)
        c = (Rn[0, 2] - Rn[2, 0]) / (4 * w)
        d = (Rn[1, 0] - Rn[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(Rn)))
        if i == 0:
            s = np.sqrt(1.0 + Rn[0, 0] - Rn[1, 1] - Rn[2, 2]) * 2
            w = (Rn[2, 1] - Rn[1, 2]) / s
            b, c, d = s / 4, (Rn[0, 1] + Rn[1, 0]) / s, (Rn[0, 2] + Rn[2, 0]) / s
        elif i == 1:
            s = np.sqrt(1.0 + Rn[1, 1] - Rn[0, 0] - Rn[2, 2]) * 2
            w = (Rn[0, 2] - Rn[2, 0]) / s
            b, c, d = (Rn[0, 1] + Rn[1, 0]) / s, s / 4, (Rn[1, 2] + Rn[2, 1]) / s
        else:
            s = np.sqrt(1.0 + Rn[2, 2] - Rn[0, 0] - Rn[1, 1]) * 2
            w = (Rn[1, 0] - Rn[0, 1]) / s
            b, c, d = (Rn[0, 2] + Rn[2, 0]) / s, (Rn[1, 2] + Rn[2, 1]) / s, s / 4
    if w < 0:
        b, c, d = -b, -c, -d
    return float(b), float(c), float(d), qfac, spacing


def read_nifti(path: str, mmap: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Read a ``.nii``/``.nii.gz`` file → (array, 4x4 RAS+ affine).

    Applies scl_slope/scl_inter rescaling when present (as nibabel's
    ``get_fdata`` does). ``mmap=True`` memory-maps uncompressed files.
    """
    is_gz = path.endswith(".gz")
    opener = gzip.open if is_gz else open
    with opener(path, "rb") as f:
        hdr_bytes = f.read(_HDR_SIZE)
        if len(hdr_bytes) < _HDR_SIZE:
            raise ValueError(f"File too small to be NIfTI: {path}")
        sizeof_hdr = struct.unpack("<i", hdr_bytes[:4])[0]
        byteorder = "<"
        if sizeof_hdr != _HDR_SIZE:
            if struct.unpack(">i", hdr_bytes[:4])[0] == _HDR_SIZE:
                # Big-endian NIfTI (legacy SPARC/PowerPC-era tools): same
                # layout, every field byte-swapped. Write stays LE.
                byteorder = ">"
            else:
                raise ValueError(f"Not a NIfTI-1 file: {path}")
        hdr_struct = (
            _HDR_STRUCT if byteorder == "<"
            else struct.Struct(">" + _HDR_STRUCT.format[1:])
        )
        fields = hdr_struct.unpack(hdr_bytes)
        (
            _, _, _, _, _, _, _dim_info,
            d0, d1, d2, d3, d4, d5, d6, d7,
            _i1, _i2, _i3, _intent_code,
            datatype, _bitpix, _slice_start,
            p0, p1, p2, p3, p4, p5, p6, p7,
            vox_offset, scl_slope, scl_inter,
            _se, _sc, _xu, _cmax, _cmin, _sd, _toff, _gmax, _gmin,
            _descrip, _aux,
            qform_code, sform_code,
            qb, qc, qd, qx, qy, qz,
            sx0, sx1, sx2, sx3,
            sy0, sy1, sy2, sy3,
            sz0, sz1, sz2, sz3,
            _intent_name, magic,
        ) = fields

        ndim = int(d0)
        if not 1 <= ndim <= 7:
            raise ValueError(f"Invalid NIfTI dim[0]={ndim} in {path}")
        shape = tuple(int(x) for x in (d1, d2, d3, d4, d5, d6, d7)[:ndim])
        if any(x < 1 for x in shape):
            raise ValueError(f"Invalid NIfTI dims {shape} in {path}")
        dtype_name = _CODE_TO_DTYPE.get(int(datatype))
        if dtype_name is None:  # np.dtype(None) would silently mean float64
            raise ValueError(f"Unsupported NIfTI datatype code {datatype}")
        dtype = np.dtype(dtype_name).newbyteorder(byteorder)
        n_items = int(np.prod(shape)) if shape else 0
        offset = int(vox_offset) if vox_offset else _HDR_SIZE + 4

        # Guard against headers whose dims claim more data than the file
        # holds — trusting them means allocating the claimed size (a lying
        # 30000^3 header would try ~100 TB before any shape check).
        expected = n_items * dtype.itemsize
        if not is_gz:
            available = os.path.getsize(path) - offset
            if available < expected:
                raise ValueError(
                    f"NIfTI header claims {expected} data bytes but file has "
                    f"{max(available, 0)}: {path}"
                )

        if mmap and not is_gz:
            arr = np.memmap(path, dtype=dtype, mode="c", offset=offset, shape=shape, order="F")
        else:
            f.seek(offset)
            # Chunked read: a short stream fails with a clean error instead
            # of a giant up-front allocation.
            chunks, got = [], 0
            while got < expected:
                piece = f.read(min(64 * 1024 * 1024, expected - got))
                if not piece:
                    raise ValueError(
                        f"NIfTI header claims {expected} data bytes but stream "
                        f"ended after {got}: {path}"
                    )
                chunks.append(piece)
                got += len(piece)
            raw = b"".join(chunks) if len(chunks) != 1 else chunks[0]
            # frombuffer over bytes is READ-ONLY; copy so in-place volume
            # math (mv *= 2, mv[...] = 0) works like the reference.
            arr = np.frombuffer(raw, dtype=dtype).reshape(shape, order="F").copy(order="F")
        if byteorder == ">":
            # Normalize to native order: downstream host-to-device copies and C paths
            # assume native-endian buffers. (Materializes mmap'd BE files.)
            arr = np.asarray(arr, dtype=dtype.newbyteorder("="), order="F")

    # Affine: prefer sform, then qform, then pixdim diagonal.
    if sform_code > 0:
        affine = np.array(
            [
                [sx0, sx1, sx2, sx3],
                [sy0, sy1, sy2, sy3],
                [sz0, sz1, sz2, sz3],
                [0, 0, 0, 1],
            ],
            dtype=np.float64,
        )
    elif qform_code > 0:
        affine = _quaternion_to_affine(qb, qc, qd, p0, (p1, p2, p3), (qx, qy, qz))
    else:
        affine = np.diag([p1 or 1.0, p2 or 1.0, p3 or 1.0, 1.0])

    # nibabel semantics: slope of 0 or NaN means "no scaling at all" (the
    # intercept is ignored too — it is frequently stale garbage); NaN
    # intercept likewise means unset.
    if not np.isfinite(scl_slope) or scl_slope == 0.0:
        scl_slope, scl_inter = 1.0, 0.0
    if not np.isfinite(scl_inter):
        scl_inter = 0.0
    if scl_slope != 1.0 or scl_inter != 0.0:
        arr = arr * np.float64(scl_slope) + np.float64(scl_inter)

    return arr, affine


def write_nifti(path: str, arr: np.ndarray, affine: np.ndarray):
    """Write ``arr`` (+ affine) as a single-file NIfTI-1 (.nii or .nii.gz)."""
    arr = np.asarray(arr)
    if arr.dtype == bool:
        arr = arr.astype(np.uint8)
    if arr.dtype not in _DTYPE_TO_CODE:
        arr = arr.astype(np.float32)
    datatype, bitpix = _DTYPE_TO_CODE[arr.dtype]
    ndim = arr.ndim
    if ndim > 7:
        raise ValueError("NIfTI supports at most 7 dimensions")
    dim = [ndim] + list(arr.shape) + [1] * (7 - ndim)

    affine = np.asarray(affine, dtype=np.float64)
    qb, qc, qd, qfac, spacing = _affine_to_quaternion(affine)
    pixdim = [float(qfac)] + list(spacing) + [0.0] * 4
    pixdim = pixdim[:8]

    vox_offset = float(_HDR_SIZE + 4)  # header + 4-byte extension flag

    hdr = _HDR_STRUCT.pack(
        _HDR_SIZE,
        b"", b"", 0, 0, b"r", 0,
        *[int(x) for x in dim],
        0.0, 0.0, 0.0, 0,
        datatype, bitpix, 0,
        *[float(x) for x in pixdim],
        vox_offset, 1.0, 0.0,
        0, 0, 2 | 8,  # xyzt_units: mm | sec
        0.0, 0.0, 0.0, 0.0, 0, 0,
        b"dosma_tpu", b"",
        1, 2,  # qform_code=1 (scanner), sform_code=2 (aligned)
        float(qb), float(qc), float(qd),
        float(affine[0, 3]), float(affine[1, 3]), float(affine[2, 3]),
        *[float(x) for x in affine[0, :4]],
        *[float(x) for x in affine[1, :4]],
        *[float(x) for x in affine[2, :4]],
        b"", _MAGIC_SINGLE,
    )

    body = hdr + b"\x00\x00\x00\x00" + arr.tobytes(order="F")
    if path.endswith(".gz"):
        _gzip_write(path, body)
    else:
        with open(path, "wb") as f:
            f.write(body)


def _gzip_write(path: str, body: bytes, level: int = 1, chunk_mb: int = 8):
    """Write ``body`` to ``path`` as gzip, compressing 8 MB chunks in a
    thread pool and concatenating the members.

    Concatenated gzip members are a valid gzip stream (RFC 1952 §2.2) —
    Python's ``gzip``, zlib, nibabel, and every standard tool decompress
    them transparently. Level 1 matches nibabel's default (the reference's
    write path) and measures 2.5x over the previous level-6 stream on int16
    MRI volumes at ~2 pp compression-ratio cost; zlib releases the GIL, so
    on multi-core hosts the chunks additionally compress in parallel.
    ``mtime=0`` keeps output deterministic.
    """
    import concurrent.futures as cf

    chunk = chunk_mb * 1024 * 1024
    if len(body) <= chunk:
        with open(path, "wb") as f:
            f.write(gzip.compress(body, compresslevel=level, mtime=0))
        return
    # memoryview slices: no second copy of the body (gzip.compress takes
    # any buffer-protocol object).
    mv = memoryview(body)
    pieces = [mv[i : i + chunk] for i in range(0, len(body), chunk)]
    workers = min(8, os.cpu_count() or 1, len(pieces))
    with cf.ThreadPoolExecutor(workers) as ex:
        outs = ex.map(lambda p: gzip.compress(p, compresslevel=level, mtime=0), pieces)
        with open(path, "wb") as f:
            for out in outs:
                f.write(out)
