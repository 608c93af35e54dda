"""The port's DICOM pixel codecs against the JAX package's, file by file.

Every transfer syntax that ``tests/core/io/test_compressed_dicom.py`` covers
is written by ``dosma_tpu``'s writer and decoded by both packages: bit-equal
pixel arrays of the same dtype, through the port's native (C++) codecs,
built here with g++ from ``dosma_tpu_torch/csrc/host/``, and through its
pure-Python codecs (the plain versions). Frames the port compresses are
byte-identical to ``dosma_tpu``'s, by either route, and ``dosma_tpu`` reads
the files the port writes.
"""

import io

import numpy as np
import pytest

from dosma_tpu.core.io.dicom import codecs as jcodecs
from dosma_tpu.core.io.dicom import read_dicom_bytes as j_read_bytes
from dosma_tpu.core.io.dicom import tags as JT
from dosma_tpu.core.io.dicom import write_dicom as j_write
from dosma_tpu_torch.core.io import _native
from dosma_tpu_torch.core.io.dicom import codecs as tcodecs
from dosma_tpu_torch.core.io.dicom import read_dicom_bytes as t_read_bytes
from dosma_tpu_torch.core.io.dicom import write_dicom as t_write
from tests.util import build_dicom_dataset


@pytest.fixture(autouse=True)
def _compute_on_cpu():
    """The port's entry points compute host data on the card by default;
    these tests ask for the CPU."""
    from dosma_tpu_torch.core.device import default_device

    with default_device("cpu"):
        yield


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """Which of the port's codecs decode and encode: the C++ library or the
    pure-Python plain versions."""
    if request.param == "python":
        monkeypatch.setattr(_native, "codecs_available", lambda: False)
    else:
        assert _native.codecs_available()  # builds the library, or raises
    return request.param


def _smooth(shape, peak):
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    return peak / 2 + (peak / 2 - 1) * np.sin(yy / 9.0) * np.cos(xx / 7.0)


def _frame(kind):
    rs = np.random.RandomState(5)
    if kind == "u16":
        return (rs.rand(24, 40) * 3000).astype(np.uint16)
    if kind == "u8":
        return (rs.rand(24, 40) * 255).astype(np.uint8)
    if kind == "smooth8":
        return _smooth((24, 40), 200.0).astype(np.uint8)
    if kind == "smooth12":
        return _smooth((24, 40), 4000.0).astype(np.uint16)
    raise ValueError(kind)


# name: (transfer syntax, frame kind, BitsStored)
_CASES = {
    "rle_u16": (jcodecs.RLE_LOSSLESS, "u16", 16),
    "rle_u8": (jcodecs.RLE_LOSSLESS, "u8", 8),
    "jpeg_lossless": (jcodecs.JPEG_LOSSLESS, "u16", 16),
    "jpeg_lossless_sv1": (jcodecs.JPEG_LOSSLESS_SV1, "u16", 16),
    "jpeg_baseline_8bit": (jcodecs.JPEG_BASELINE, "smooth8", 8),
    "jpeg_extended_12bit": (jcodecs.JPEG_EXTENDED, "smooth12", 12),
    "jpeg_ls_lossless": (jcodecs.JPEG_LS_LOSSLESS, "u16", 16),
    "jpeg_ls_near_lossless": (jcodecs.JPEG_LS_NEAR_LOSSLESS, "u16", 16),
    "jpeg_2000_lossless": (jcodecs.JPEG_2000_LOSSLESS, "u16", 16),
    "deflated": (JT.DEFLATED_EXPLICIT_VR_LE, "u16", 16),
    "explicit_le": (JT.EXPLICIT_VR_LE, "u16", 16),
}
_ENCAPSULATED = [k for k, (ts, _, _) in _CASES.items() if ts in jcodecs.COMPRESSED_SYNTAXES]


def _dataset(case):
    ts, kind, bits_stored = _CASES[case]
    frame = _frame(kind)
    ds = build_dicom_dataset(frame)
    ds.BitsAllocated = frame.dtype.itemsize * 8
    ds.BitsStored = bits_stored
    ds.HighBit = bits_stored - 1
    ds["PixelData"] = frame.tobytes()
    return ts, frame, ds


def _jax_file(case) -> bytes:
    ts, _, ds = _dataset(case)
    buf = io.BytesIO()
    j_write(ds, buf, transfer_syntax=ts)
    return buf.getvalue()


@pytest.mark.parametrize("case", list(_CASES))
def test_decode_matches_jax(case, route):
    raw = _jax_file(case)
    ref = j_read_bytes(raw).pixel_array
    got = t_read_bytes(raw).pixel_array
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("case", _ENCAPSULATED)
def test_encoded_frames_match_jax(case, route):
    ts, frame, _ = _dataset(case)
    ref = jcodecs.encode_frames(frame, ts)
    got = tcodecs.encode_frames(frame, ts)
    assert got.fragments == ref.fragments


@pytest.mark.parametrize("case", list(_CASES))
def test_jax_reads_the_ports_file(case, route):
    ts, _, ds = _dataset(case)
    plain = io.BytesIO()
    j_write(ds, plain)  # uncompressed, then read and written again by the port
    port_ds = t_read_bytes(plain.getvalue())
    buf = io.BytesIO()
    t_write(port_ds, buf, transfer_syntax=ts)
    back = j_read_bytes(buf.getvalue())
    assert back.file_meta.get("TransferSyntaxUID") == ts
    np.testing.assert_array_equal(back.pixel_array, j_read_bytes(_jax_file(case)).pixel_array)
    assert back.Rows == ds.Rows and back.EchoTime == ds.EchoTime


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_native_and_python_rle_agree(dtype):
    frame = (np.random.RandomState(1).rand(17, 23, 3) * np.iinfo(dtype).max).astype(dtype)
    enc = tcodecs.rle_encode_frame(frame)
    assert _native.rle_encode(frame) == enc
    bits = 8 * np.dtype(dtype).itemsize
    np.testing.assert_array_equal(_native.rle_decode(enc, 17, 23, 3, bits),
                                  tcodecs.rle_decode_frame(enc, 17, 23, 3, bits))


@pytest.mark.parametrize("predictor", list(range(1, 8)))
def test_native_and_python_jpeg_lossless_agree(predictor):
    frame = (np.random.RandomState(predictor).rand(13, 19) * 65535).astype(np.uint16)
    enc = tcodecs.jpeg_lossless_encode(frame, precision=16, predictor=predictor)
    assert _native.jpeg_lossless_encode(frame, 16, predictor=predictor) == enc
    np.testing.assert_array_equal(_native.jpeg_lossless_decode(enc),
                                  tcodecs.jpeg_lossless_decode(enc))
    np.testing.assert_array_equal(_native.jpeg_lossless_decode(enc), frame)


# case: (native decoder of _native, pure-Python decoder module, its function)
_DIRECT = {
    "jpeg_baseline_8bit": ("jpeg_baseline_decode", "jpeg_baseline", "jpeg_baseline_decode"),
    "jpeg_extended_12bit": ("jpeg_baseline_decode", "jpeg_baseline", "jpeg_baseline_decode"),
    "jpeg_ls_lossless": ("jpeg_ls_decode", "jpeg_ls", "jpeg_ls_decode"),
    "jpeg_ls_near_lossless": ("jpeg_ls_decode", "jpeg_ls", "jpeg_ls_decode"),
    "jpeg_2000_lossless": ("j2k_decode", "j2k", "j2k_decode"),
}


@pytest.mark.parametrize("case", list(_DIRECT))
def test_native_decoder_is_taken_and_agrees(case):
    """The native decoder accepts the stream (no fallback hides a refusal)
    and agrees with its pure-Python twin bit for bit."""
    import importlib

    ts, frame, _ = _dataset(case)
    fragment = tcodecs.encode_frames(frame, ts).fragments[0]
    native_name, module, fn = _DIRECT[case]
    plain = getattr(importlib.import_module(f"dosma_tpu_torch.core.io.dicom.{module}"), fn)
    got = getattr(_native, native_name)(fragment)
    ref = plain(fragment)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
