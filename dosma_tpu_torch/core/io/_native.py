"""Bridge to the port's host C++ libraries (``csrc/host/*.cpp``).

Counterpart of ``dosma_tpu/core/io/_native.py``, built from the port's own
copies of ``native/dosma_io.cpp`` and ``native/dosma_codecs.cpp``:

- ``dosma_io``: batched threaded file reading (DICOM series).
- ``dosma_codecs``: compressed-pixel codecs (RLE Lossless, JPEG Lossless
  SOF3, JPEG Baseline/Extended SOF0/SOF1, JPEG-LS T.87, lossless JPEG 2000)
  — the bit-serial scans are ~50-1000x faster in C++ than the pure-Python
  twins, which stay the plain versions they are held against.

Each library is compiled with g++ on first use into ``dosma_tpu_torch/_build/``
(:func:`dosma_tpu_torch.ops._build.load_host_library`: hashed file name,
built to a private name and renamed, so concurrent first builds do not
race). A failed build raises: :func:`available` and
:func:`codecs_available` are true or raise, never quietly false.
"""

from __future__ import annotations

import ctypes
from typing import List


def _load():
    from dosma_tpu_torch.ops._build import load_host_library

    return load_host_library("dosma_io")


def _load_codecs():
    from dosma_tpu_torch.ops._build import load_host_library

    return load_host_library("dosma_codecs")


def available() -> bool:
    return _load() is not None


def codecs_available() -> bool:
    return _load_codecs() is not None


def rle_decode(data: bytes, rows: int, cols: int, samples: int, bits_allocated: int):
    """RLE-decode one frame via C++; returns (rows, cols[, samples]) ndarray."""
    import numpy as np

    lib = _load_codecs()
    nbytes = bits_allocated // 8
    out = np.empty(rows * cols * samples * nbytes, np.uint8)
    rc = lib.dosma_rle_decode(
        ctypes.c_char_p(data), ctypes.c_longlong(len(data)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rows, cols, samples, nbytes,
    )
    if rc != 0:
        raise ValueError(f"native RLE decode failed (code {rc})")
    dtype = np.dtype({1: ">u1", 2: ">u2", 4: ">u4"}[nbytes])
    arr = out.view(dtype).reshape(rows, cols, samples)
    return arr[..., 0] if samples == 1 else arr


def rle_encode(arr) -> bytes:
    """RLE-encode one frame via C++ (byte-identical to the Python encoder)."""
    import numpy as np

    lib = _load_codecs()
    a = np.ascontiguousarray(arr)
    if a.ndim == 2:
        a = a[..., None]
    rows, cols, samples = a.shape
    nbytes = a.dtype.itemsize
    src = np.ascontiguousarray(a.astype(a.dtype.newbyteorder(">"), copy=False)).view(np.uint8)
    cap = 64 + (rows * cols + rows * cols // 128 + 2) * samples * nbytes + 64
    out = np.empty(cap, np.uint8)
    lib.dosma_rle_encode.restype = ctypes.c_longlong
    n = lib.dosma_rle_encode(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        rows, cols, samples, nbytes,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_longlong(cap),
    )
    if n < 0:
        raise ValueError(f"native RLE encode failed (code {n})")
    return out[:n].tobytes()


def jpeg_lossless_encode(arr, precision: int, predictor: int = 1, point_transform: int = 0) -> bytes:
    """JPEG-lossless encode via C++ (byte-identical to the Python encoder)."""
    import numpy as np

    lib = _load_codecs()
    a = np.ascontiguousarray(np.asarray(arr), dtype=np.uint16)
    if a.ndim != 2:
        raise ValueError("JPEG lossless encoder supports single-component 2D frames")
    rows, cols = a.shape
    cap = rows * cols * 5 + 4096
    out = np.empty(cap, np.uint8)
    lib.dosma_jpeg_lossless_encode.restype = ctypes.c_longlong
    n = lib.dosma_jpeg_lossless_encode(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        rows, cols, precision, predictor, point_transform,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ctypes.c_longlong(cap),
    )
    if n < 0:
        raise ValueError(f"native JPEG lossless encode failed (code {n})")
    return out[:n].tobytes()


def jpeg_lossless_decode(data: bytes):
    """Decode a single-component SOF3 stream via C++; returns uint16 array."""
    import numpy as np

    lib = _load_codecs()
    meta = (ctypes.c_int * 4)()
    rc = lib.dosma_jpeg_lossless_decode(
        ctypes.c_char_p(data), ctypes.c_longlong(len(data)),
        None, ctypes.c_longlong(0), meta, 1,
    )
    if rc != 0:
        raise ValueError(f"native JPEG lossless header parse failed (code {rc})")
    rows, cols = meta[0], meta[1]
    out = np.empty((rows, cols), np.uint16)
    rc = lib.dosma_jpeg_lossless_decode(
        ctypes.c_char_p(data), ctypes.c_longlong(len(data)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_longlong(out.size), meta, 0,
    )
    if rc != 0:
        raise ValueError(f"native JPEG lossless decode failed (code {rc})")
    return out


def jpeg_baseline_decode(data: bytes):
    """Decode a single-component SOF0/SOF1 stream via C++.

    Returns uint8 for 8-bit precision, uint16 for 12-bit — matching the
    Python decoder. Color/progressive streams raise ValueError so the
    dispatch falls back to the Python path.
    """
    import numpy as np

    lib = _load_codecs()
    meta = (ctypes.c_int * 4)()
    rc = lib.dosma_jpeg_baseline_decode(
        ctypes.c_char_p(data), ctypes.c_longlong(len(data)),
        None, ctypes.c_longlong(0), meta, 1,
    )
    if rc != 0:
        raise ValueError(f"native JPEG baseline header parse failed (code {rc})")
    rows, cols, precision = meta[0], meta[1], meta[2]
    out = np.empty((rows, cols), np.uint16)
    rc = lib.dosma_jpeg_baseline_decode(
        ctypes.c_char_p(data), ctypes.c_longlong(len(data)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_longlong(out.size), meta, 0,
    )
    if rc != 0:
        raise ValueError(f"native JPEG baseline decode failed (code {rc})")
    return out.astype(np.uint8) if precision == 8 else out


def jpeg_ls_decode(data: bytes):
    """Decode a single-component JPEG-LS stream via C++.

    Returns uint8 for precision <= 8, uint16 otherwise — matching the
    Python decoder. Multi-component/mapping-table streams raise
    ValueError so the dispatch falls back to the Python path.
    """
    import numpy as np

    lib = _load_codecs()
    meta = (ctypes.c_int * 4)()
    rc = lib.dosma_jpeg_ls_decode(
        ctypes.c_char_p(data), ctypes.c_longlong(len(data)),
        None, ctypes.c_longlong(0), meta, 1,
    )
    if rc != 0:
        raise ValueError(f"native JPEG-LS header parse failed (code {rc})")
    rows, cols, precision = meta[0], meta[1], meta[2]
    out = np.empty((rows, cols), np.uint16)
    rc = lib.dosma_jpeg_ls_decode(
        ctypes.c_char_p(data), ctypes.c_longlong(len(data)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_longlong(out.size), meta, 0,
    )
    if rc != 0:
        raise ValueError(f"native JPEG-LS decode failed (code {rc})")
    return out.astype(np.uint8) if precision <= 8 else out


def jpeg_ls_encode(arr, near: int = 0) -> bytes:
    """Encode a grayscale frame as JPEG-LS via C++ (byte-identical to the
    Python encoder)."""
    import numpy as np

    a = np.ascontiguousarray(arr)
    if a.ndim != 2 or a.dtype.kind != "u" or a.dtype.itemsize > 2:
        raise ValueError("native JPEG-LS encoder expects a 2D uint8/uint16 array")
    precision = 8 * a.dtype.itemsize  # P == sample width (PS3.5)
    a16 = a.astype(np.uint16)
    lib = _load_codecs()
    # Worst case: every sample takes the LIMIT escape (~2*(bpp+8) bits)
    # plus 8/7 stuffing overhead — ~8 bytes/sample at 16-bit. A short cap
    # would silently drop pathological frames onto the 1000x-slower
    # Python path.
    cap = a.size * 8 + 4096
    buf = ctypes.create_string_buffer(cap)
    lib.dosma_jpeg_ls_encode.restype = ctypes.c_longlong
    n = lib.dosma_jpeg_ls_encode(
        a16.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int(a.shape[0]), ctypes.c_int(a.shape[1]),
        ctypes.c_int(precision), ctypes.c_int(int(near)),
        ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8)), ctypes.c_longlong(cap),
    )
    if n < 0:
        raise ValueError(f"native JPEG-LS encode failed (code {n})")
    return ctypes.string_at(buf, n)


def read_dicom_files(files: List[str]):
    """Parse many DICOM files via the C++ helper; returns list of Datasets.

    The C++ layer handles file reading + gunzip-free byte slurping in
    parallel; element parsing stays in Python for full fidelity.
    """
    from dosma_tpu_torch.core.io.dicom import read_dicom_bytes

    blobs = read_files_bytes(files)
    return [read_dicom_bytes(b) for b in blobs]


def read_files_bytes(files: List[str]) -> List[bytes]:
    """Read many files into memory using the C++ threaded reader."""
    lib = _load()
    lib.dosma_read_files.restype = ctypes.c_int
    n = len(files)
    c_paths = (ctypes.c_char_p * n)(*[f.encode() for f in files])
    sizes = (ctypes.c_longlong * n)()
    # First pass: get sizes.
    if lib.dosma_file_sizes(c_paths, n, sizes) != 0:
        raise IOError("native file size probe failed")
    bufs = [ctypes.create_string_buffer(max(int(s), 1)) for s in sizes]
    buf_ptrs = (ctypes.c_char_p * n)(*[ctypes.cast(b, ctypes.c_char_p) for b in bufs])
    if lib.dosma_read_files(c_paths, n, buf_ptrs, sizes) != 0:
        raise IOError("native file read failed")
    return [bufs[i].raw[: int(sizes[i])] for i in range(n)]


def j2k_decode(data: bytes):
    """Decode a lossless JPEG 2000 codestream via C++ (twin of
    :func:`dosma_tpu_torch.core.io.dicom.j2k.j2k_decode`).

    Returns (H, W) or (H, W, C); dtype follows the component depth.
    Raises ``NotImplementedError`` for out-of-profile codestreams (9/7
    lossy, quantized, special code-block styles) so the caller can fall
    through, and ``ValueError`` on corrupt streams.
    """
    import numpy as np

    lib = _load_codecs()
    meta = (ctypes.c_int * 5)()
    fn = lib.dosma_j2k_decode
    fn.restype = ctypes.c_int
    rc = fn(
        ctypes.c_char_p(data), ctypes.c_longlong(len(data)),
        None, ctypes.c_longlong(0), meta, 1,
    )
    if rc == -2:
        raise NotImplementedError("native J2K: out-of-profile codestream")
    if rc != 0:
        raise ValueError(f"native J2K header parse failed (code {rc})")
    h, w, ncomp, maxdepth, any_signed = meta[0], meta[1], meta[2], meta[3], meta[4]
    out = np.empty((h, w, ncomp), np.int32)
    rc = fn(
        ctypes.c_char_p(data), ctypes.c_longlong(len(data)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_longlong(out.size), meta, 0,
    )
    if rc == -2:
        raise NotImplementedError("native J2K: out-of-profile codestream")
    if rc != 0:
        raise ValueError(f"native J2K decode failed (code {rc})")
    # Dtype policy mirrors the Python twin (j2k.py): unsigned components
    # narrow to uint8/uint16; signed images keep a signed dtype (casting
    # -1 to uint8 would wrap to 255).
    if any_signed:
        out = out.astype(np.int16) if maxdepth <= 8 else out
    elif maxdepth <= 8:
        out = out.astype(np.uint8)
    else:
        out = out.astype(np.uint16)
    return out[..., 0] if ncomp == 1 else out
