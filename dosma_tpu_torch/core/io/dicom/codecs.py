"""Compressed DICOM pixel-data codecs (from scratch; pydicom unavailable).

Implements the compressed transfer syntaxes found in archived MR exports
(reference capability via pydicom's pixel handlers,
``dosma/core/io/dicom_io.py:303-314``):

- **RLE Lossless** (``1.2.840.10008.1.2.5``): PS3.5 Annex G — per-frame
  byte-segment decomposition + PackBits run-length coding.
- **JPEG Lossless** (``1.2.840.10008.1.2.4.57`` process 14 and
  ``...4.70`` process 14 selection-value 1): ITU T.81 SOF3 — Huffman-coded
  DPCM with the seven spatial predictors.
- **JPEG Baseline/Extended** (``...4.50``/``...4.51``): ITU T.81
  SOF0/SOF1 lossy DCT (:mod:`dosma_tpu_torch.core.io.dicom.jpeg_baseline`).
- **JPEG-LS** (``...4.80`` lossless / ``...4.81`` near-lossless): ITU
  T.87 LOCO-I (:mod:`dosma_tpu_torch.core.io.dicom.jpeg_ls`).

JPEG 2000 (``...4.90/.91``) raises an actionable transcode error.

Both directions (encode + decode) are provided so synthetic encapsulated
files can be generated for round-trip tests and so :mod:`writer` can emit
compressed series.
"""

from __future__ import annotations

import io
import struct
from typing import List, Optional, Sequence

import numpy as np

__all__ = [
    "RLE_LOSSLESS",
    "JPEG_LOSSLESS",
    "JPEG_LOSSLESS_SV1",
    "JPEG_BASELINE",
    "JPEG_EXTENDED",
    "JPEG_LS_LOSSLESS",
    "JPEG_LS_NEAR_LOSSLESS",
    "COMPRESSED_SYNTAXES",
    "unsupported_syntax_error",
    "EncapsulatedPixelData",
    "packbits_encode",
    "packbits_decode",
    "rle_encode_frame",
    "rle_decode_frame",
    "jpeg_lossless_encode",
    "jpeg_lossless_decode",
    "encode_frames",
    "decode_frames",
]

RLE_LOSSLESS = "1.2.840.10008.1.2.5"
JPEG_LOSSLESS = "1.2.840.10008.1.2.4.57"  # process 14, any predictor
JPEG_LOSSLESS_SV1 = "1.2.840.10008.1.2.4.70"  # process 14, predictor 1
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"  # process 1 (8-bit lossy DCT)
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"  # process 2 & 4 (8/12-bit lossy DCT)
JPEG_LS_LOSSLESS = "1.2.840.10008.1.2.4.80"
JPEG_LS_NEAR_LOSSLESS = "1.2.840.10008.1.2.4.81"
JPEG_2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG_2000 = "1.2.840.10008.1.2.4.91"

#: Transfer syntaxes this module can decode (and encode). JPEG 2000 needs
#: Pillow/OpenJPEG at runtime (baked into this stack; probed on use).
COMPRESSED_SYNTAXES = frozenset({
    RLE_LOSSLESS, JPEG_LOSSLESS, JPEG_LOSSLESS_SV1, JPEG_BASELINE, JPEG_EXTENDED,
    JPEG_LS_LOSSLESS, JPEG_LS_NEAR_LOSSLESS, JPEG_2000_LOSSLESS, JPEG_2000,
})

#: Recognized-but-unavailable syntaxes → actionable error text (J2K lands
#: here only when Pillow lacks OpenJPEG).
_UNSUPPORTED_SYNTAXES = {
    JPEG_2000_LOSSLESS: "JPEG 2000 Lossless",
    JPEG_2000: "JPEG 2000",
}


def unsupported_syntax_error(transfer_syntax: str) -> NotImplementedError:
    """A clean, actionable error for recognized-but-unimplemented syntaxes."""
    name = _UNSUPPORTED_SYNTAXES.get(transfer_syntax)
    if name is not None:
        return NotImplementedError(
            f"Transfer syntax {transfer_syntax} ({name}) is not supported. "
            f"Transcode the series to one of: uncompressed Little Endian, "
            f"RLE Lossless ({RLE_LOSSLESS}), JPEG Lossless ({JPEG_LOSSLESS_SV1}), "
            f"JPEG-LS ({JPEG_LS_LOSSLESS}), or JPEG Baseline ({JPEG_BASELINE}) — "
            f"e.g. with dcmtk's `dcmdjp2k` or `gdcmconv --raw`."
        )
    return NotImplementedError(f"Transfer syntax {transfer_syntax} is not supported")


class EncapsulatedPixelData:
    """Raw encapsulated PixelData: basic offset table + fragment list.

    Held as the value of the (7FE0,0010) element when the file uses a
    compressed transfer syntax; decoding is deferred to ``pixel_array``.
    """

    def __init__(self, fragments: List[bytes], basic_offset_table: Optional[List[int]] = None):
        self.fragments = list(fragments)
        self.basic_offset_table = list(basic_offset_table or [])

    def __len__(self):
        return sum(len(f) for f in self.fragments)

    def __repr__(self):
        return (
            f"EncapsulatedPixelData({len(self.fragments)} fragments, "
            f"{len(self)} bytes, BOT={len(self.basic_offset_table)} entries)"
        )

    def frames(self, number_of_frames: int) -> List[bytes]:
        """Group fragments into per-frame byte streams."""
        frags = self.fragments
        if number_of_frames <= 1:
            return [b"".join(frags)]
        if self.basic_offset_table:
            # Offsets index the first byte of each frame's first fragment,
            # measured from the start of the first fragment's item header.
            starts = []
            pos = 0
            for i, f in enumerate(frags):
                starts.append(pos)
                pos += 8 + len(f)  # item header + payload
            out, current = [], []
            offsets = list(self.basic_offset_table) + [None]
            oi = 1
            for start, frag in zip(starts, frags):
                if offsets[oi] is not None and start >= offsets[oi]:
                    out.append(b"".join(current))
                    current = []
                    oi += 1
                current.append(frag)
            out.append(b"".join(current))
            if len(out) == number_of_frames:
                return out
        if len(frags) == number_of_frames:
            return [bytes(f) for f in frags]
        if len(frags) % number_of_frames == 0:
            k = len(frags) // number_of_frames
            return [b"".join(frags[i * k : (i + 1) * k]) for i in range(number_of_frames)]
        raise ValueError(
            f"Cannot map {len(frags)} fragments onto {number_of_frames} frames "
            "without a usable Basic Offset Table"
        )


# --------------------------------------------------------------------------
# PackBits + DICOM RLE (PS3.5 Annex G)
# --------------------------------------------------------------------------


def packbits_encode(data: bytes) -> bytes:
    """PackBits-compress one RLE segment (PS3.5 G.3.1)."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        # Measure the run starting at i.
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out.append(257 - run)
            out.append(data[i])
            i += run
            continue
        # Literal stretch: until the next >=3 repeat (2-byte runs aren't
        # worth breaking a literal for) or 128 bytes.
        j = i + 1
        while j < n and j - i < 128:
            if j + 2 < n and data[j] == data[j + 1] == data[j + 2]:
                break
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


def packbits_decode(data: bytes, expected: Optional[int] = None) -> bytes:
    """Expand one PackBits segment. ``expected`` truncates trailing pad."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl == 128:  # noop
            continue
        if ctrl < 128:  # literal copy of ctrl+1 bytes
            j = i + ctrl + 1
            out += data[i:j]
            i = j
        else:  # replicate next byte 257-ctrl times
            if i >= n:
                break
            out += bytes([data[i]]) * (257 - ctrl)
            i += 1
        if expected is not None and len(out) >= expected:
            break
    if expected is not None:
        return bytes(out[:expected])
    return bytes(out)


def rle_encode_frame(frame: np.ndarray) -> bytes:
    """RLE-encode one frame (2D grayscale or (rows, cols, samples)).

    Segment order per PS3.5 G.2: for each sample, most-significant byte
    plane first. Output starts with the 64-byte RLE header.
    """
    arr = np.ascontiguousarray(frame)
    if arr.ndim == 2:
        arr = arr[..., None]
    rows, cols, samples = arr.shape
    nbytes = arr.dtype.itemsize
    if samples * nbytes > 15:
        raise ValueError("RLE supports at most 15 segments per frame")

    # Big-endian byte view puts the MSB plane at byte index 0.
    be = arr.astype(arr.dtype.newbyteorder(">"), copy=False)
    planes = be.view(np.uint8).reshape(rows, cols, samples, nbytes)

    segments = []
    for s in range(samples):
        for b in range(nbytes):
            seg = packbits_encode(planes[:, :, s, b].tobytes())
            if len(seg) % 2:
                seg += b"\x00"
            segments.append(seg)

    header = [len(segments)]
    offset = 64
    for seg in segments:
        header.append(offset)
        offset += len(seg)
    header += [0] * (16 - len(header))
    return struct.pack("<16I", *header) + b"".join(segments)


def rle_decode_frame(data: bytes, rows: int, cols: int, samples: int, bits_allocated: int) -> np.ndarray:
    """Decode one RLE frame into (rows, cols) or (rows, cols, samples)."""
    if len(data) < 64:
        raise ValueError("RLE frame shorter than its 64-byte header")
    header = struct.unpack("<16I", data[:64])
    nseg = header[0]
    nbytes = bits_allocated // 8
    if nseg != samples * nbytes:
        raise ValueError(
            f"RLE header declares {nseg} segments; expected {samples * nbytes} "
            f"({samples} sample(s) x {nbytes} byte(s))"
        )
    offsets = list(header[1 : 1 + nseg]) + [len(data)]
    plane_len = rows * cols
    planes = np.empty((samples, nbytes, plane_len), np.uint8)
    for k in range(nseg):
        seg = packbits_decode(data[offsets[k] : offsets[k + 1]], expected=plane_len)
        if len(seg) != plane_len:
            raise ValueError(f"RLE segment {k} decoded to {len(seg)} bytes, wanted {plane_len}")
        planes[k // nbytes, k % nbytes] = np.frombuffer(seg, np.uint8)

    # Reassemble MSB-first planes into big-endian samples.
    arr = (
        planes.transpose(2, 0, 1)  # (pixel, sample, byte)
        .reshape(plane_len, samples * nbytes)
        .tobytes()
    )
    dtype = np.dtype({1: ">u1", 2: ">u2", 4: ">u4"}[nbytes])
    out = np.frombuffer(arr, dtype).reshape(rows, cols, samples)
    return out[..., 0] if samples == 1 else out


# --------------------------------------------------------------------------
# JPEG Lossless, ITU T.81 process 14 (SOF3)
# --------------------------------------------------------------------------

_SOI, _EOI, _SOF3, _DHT, _SOS, _DRI = 0xD8, 0xD9, 0xC3, 0xC4, 0xDA, 0xDD


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int):
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            byte = (self._acc >> (self._nbits - 8)) & 0xFF
            self.buf.append(byte)
            if byte == 0xFF:  # byte stuffing
                self.buf.append(0x00)
            self._nbits -= 8
        self._acc &= (1 << self._nbits) - 1

    def flush(self):
        if self._nbits:
            pad = 8 - self._nbits
            self.write((1 << pad) - 1, pad)  # pad with 1-bits per T.81 F.1.2.3


class _BitReader:
    """Entropy-coded-segment bit reader with 0xFF00 unstuffing."""

    def __init__(self, data: bytes, start: int):
        self.data = data
        self.pos = start
        self._acc = 0
        self._nbits = 0

    def _fill(self):
        data, pos = self.data, self.pos
        if pos >= len(data):
            raise EOFError("JPEG entropy stream exhausted")
        byte = data[pos]
        pos += 1
        if byte == 0xFF:
            nxt = data[pos] if pos < len(data) else 0xD9
            if nxt == 0x00:
                pos += 1
            else:
                # Marker (EOI / restart) — feed 1-padding, don't consume.
                byte = 0xFF
        self.pos = pos
        self._acc = (self._acc << 8) | byte
        self._nbits += 8

    def read(self, nbits: int) -> int:
        while self._nbits < nbits:
            self._fill()
        self._nbits -= nbits
        val = (self._acc >> self._nbits) & ((1 << nbits) - 1)
        self._acc &= (1 << self._nbits) - 1
        return val


def _canonical_codes(bits: Sequence[int], values: Sequence[int]):
    """(code, length) per symbol from a DHT BITS/HUFFVAL spec (T.81 C.2)."""
    table = {}
    code = 0
    vi = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[values[vi]] = (code, length)
            code += 1
            vi += 1
        code <<= 1
    return table


# Fixed table for the encoder: categories 0-2 at 2 bits, 3..16 at 3..16 bits.
_ENC_BITS = [0, 3] + [1] * 14
_ENC_VALUES = [0, 1, 2] + list(range(3, 17))
_ENC_TABLE = _canonical_codes(_ENC_BITS, _ENC_VALUES)


def _predict(row_above, row_cur, col, x0, predictor):
    """Px for sample (row_cur[col]); rows are int32 numpy arrays."""
    ra = int(row_cur[col - 1]) if col > 0 else None
    if row_above is None:  # first line: Ra after the first sample
        return ra if ra is not None else x0
    if col == 0:  # first column: Rb
        return int(row_above[0])
    rb = int(row_above[col])
    rc = int(row_above[col - 1])
    if predictor == 1:
        return ra
    if predictor == 2:
        return rb
    if predictor == 3:
        return rc
    if predictor == 4:
        return ra + rb - rc
    if predictor == 5:
        return ra + ((rb - rc) >> 1)
    if predictor == 6:
        return rb + ((ra - rc) >> 1)
    if predictor == 7:
        return (ra + rb) >> 1
    raise ValueError(f"Invalid predictor {predictor}")


def jpeg_lossless_encode(
    frame: np.ndarray, precision: Optional[int] = None, predictor: int = 1,
    point_transform: int = 0, restart_interval: int = 0,
) -> bytes:
    """Encode a 2D unsigned array as a single-component JPEG-lossless scan.

    ``restart_interval`` > 0 emits DRI + RSTn markers every that many
    samples (T.81 H.2.8 semantics: the sample after a restart predicts
    from the default, and the remainder of its line predicts 1-D — the
    entropy state resets as at the start of a scan)."""
    arr = np.asarray(frame)
    if arr.ndim != 2:
        raise ValueError("JPEG lossless encoder supports single-component 2D frames")
    if precision is None:
        precision = max(2, int(arr.max()).bit_length()) if arr.size else 8
    if precision < 2 or precision > 16:
        raise ValueError(f"Precision {precision} outside JPEG lossless range [2, 16]")
    rows, cols = arr.shape
    a = arr.astype(np.int32)

    out = bytearray()
    out += struct.pack(">BB", 0xFF, _SOI)
    # SOF3: length, precision, lines, samples/line, 1 component (id 1, 1x1, Tq 0)
    out += struct.pack(">BBHBHHB", 0xFF, _SOF3, 11, precision, rows, cols, 1)
    out += struct.pack(">BBB", 1, 0x11, 0)
    # DHT: class 0, id 0
    out += struct.pack(">BBHB", 0xFF, _DHT, 2 + 1 + 16 + len(_ENC_VALUES), 0x00)
    out += bytes(_ENC_BITS) + bytes(_ENC_VALUES)
    if restart_interval:
        out += struct.pack(">BBHH", 0xFF, _DRI, 4, restart_interval)
    # SOS: 1 component, Ss=predictor, Se=0, Ah<<4|Al=point transform
    out += struct.pack(">BBHBBBBBB", 0xFF, _SOS, 8, 1, 1, 0x00, predictor, 0, point_transform)

    bw = _BitWriter()
    x0 = 1 << (precision - point_transform - 1)
    shifted = a >> point_transform
    prev_row = None
    until = restart_interval if restart_interval else None
    rst = 0
    for r in range(rows):
        row = shifted[r]
        fresh_col = -1
        for c in range(cols):
            if until == 0:
                bw.flush()  # byte-align with 1-bits
                bw.buf += bytes([0xFF, 0xD0 + (rst & 7)])
                rst += 1
                until = restart_interval
                prev_row = None
                fresh_col = c
            px = x0 if c == fresh_col else _predict(prev_row, row, c, x0, predictor)
            diff = (int(row[c]) - px) & 0xFFFF
            if diff >= 0x8000:
                diff -= 0x10000
            if diff == -32768:
                ssss = 16
            else:
                ssss = abs(diff).bit_length()
            code, nbits = _ENC_TABLE[ssss]
            bw.write(code, nbits)
            if 0 < ssss < 16:
                v = diff if diff > 0 else diff + (1 << ssss) - 1
                bw.write(v, ssss)
            if until is not None:
                until -= 1
        prev_row = row
    bw.flush()
    out += bw.buf
    out += struct.pack(">BB", 0xFF, _EOI)
    return bytes(out)


def jpeg_lossless_decode(data: bytes) -> np.ndarray:
    """Decode a single-component JPEG-lossless (SOF3) stream to uint16."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("Not a JPEG stream (missing SOI)")
    pos = 2
    precision = rows = cols = None
    huff_tables = {}
    predictor = 1
    point_transform = 0
    restart_interval = 0
    scan_table = None

    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"Expected JPEG marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == _EOI:
            raise ValueError("Hit EOI before SOS")
        if marker in (0x01, *range(0xD0, 0xD8)):  # TEM / RSTn: no payload
            continue
        (seglen,) = struct.unpack(">H", data[pos : pos + 2])
        body = data[pos + 2 : pos + seglen]
        pos += seglen
        if marker == _SOF3:
            precision, rows, cols, ncomp = struct.unpack(">BHHB", body[:6])
            if ncomp != 1:
                raise NotImplementedError(
                    f"JPEG lossless decoder supports 1 component, got {ncomp}"
                )
        elif marker in (0xC0, 0xC1, 0xC2, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise NotImplementedError(f"Unsupported JPEG process (SOF{marker & 0xF})")
        elif marker == _DHT:
            bpos = 0
            while bpos < len(body):
                tc_th = body[bpos]
                bits = list(body[bpos + 1 : bpos + 17])
                nval = sum(bits)
                values = list(body[bpos + 17 : bpos + 17 + nval])
                huff_tables[tc_th & 0x0F] = _canonical_codes(bits, values)
                bpos += 17 + nval
        elif marker == _DRI:
            (restart_interval,) = struct.unpack(">H", body)
        elif marker == _SOS:
            ns = body[0]
            if ns != 1:
                raise NotImplementedError("Interleaved multi-component scans unsupported")
            scan_table = huff_tables.get(body[2] >> 4)
            predictor = body[1 + 2 * ns]
            point_transform = body[3 + 2 * ns] & 0x0F
            break

    if precision is None or scan_table is None:
        raise ValueError("JPEG stream missing SOF3 or usable DHT/SOS")

    # Build a flat decode LUT: walk codes bit by bit via a dict keyed on
    # (length, code) — small tables, so a dict probe per bit is fine.
    by_code = {(length, code): sym for sym, (code, length) in scan_table.items()}

    br = _BitReader(data, pos)
    out = np.empty((rows, cols), np.int32)
    x0 = 1 << (precision - point_transform - 1)
    prev_row = None
    samples_until_restart = restart_interval if restart_interval else None

    def read_symbol():
        code = 0
        for length in range(1, 17):
            code = (code << 1) | br.read(1)
            sym = by_code.get((length, code))
            if sym is not None:
                return sym
        raise ValueError("Invalid JPEG Huffman code")

    for r in range(rows):
        row = out[r]
        fresh_col = -1
        for c in range(cols):
            if samples_until_restart == 0:
                # Align to byte, consume RSTn, reset prediction as at the
                # start of a scan (T.81 H.2.8): the next sample predicts
                # from the default, the rest of its line predicts 1-D. The
                # bit reader may have already stepped past the 0xFF while
                # feeding padding, leaving pos ON the marker code.
                br._nbits = 0
                br._acc = 0
                if (
                    br.pos + 1 < len(br.data)
                    and br.data[br.pos] == 0xFF
                    and 0xD0 <= br.data[br.pos + 1] <= 0xD7
                ):
                    br.pos += 2
                elif (
                    0 < br.pos < len(br.data)
                    and 0xD0 <= br.data[br.pos] <= 0xD7
                    and br.data[br.pos - 1] == 0xFF
                ):
                    br.pos += 1
                prev_row = None
                samples_until_restart = restart_interval
                fresh_col = c
            ssss = read_symbol()
            if ssss == 16:
                diff = 32768
            elif ssss == 0:
                diff = 0
            else:
                v = br.read(ssss)
                diff = v if v >= (1 << (ssss - 1)) else v - (1 << ssss) + 1
            px = x0 if c == fresh_col else _predict(prev_row, row, c, x0, predictor)
            row[c] = (px + diff) & 0xFFFF
            if samples_until_restart is not None:
                samples_until_restart -= 1
        prev_row = row

    return (out.astype(np.uint16)) << point_transform


# --------------------------------------------------------------------------
# Frame-level dispatch
# --------------------------------------------------------------------------


def _native_or_python(native_fn, python_fn, *args, **kwargs):
    """One fallback policy for every codec dispatch: prefer the C++ decoder
    when the library is built and the input qualifies (``native_fn`` may be
    None to force Python); a native ValueError falls back to the Python
    twin so behavior never regresses on odd inputs."""
    from dosma_tpu_torch.core.io import _native

    if native_fn is not None and _native.codecs_available():
        try:
            return native_fn(*args, **kwargs)
        except ValueError:
            pass
    return python_fn(*args, **kwargs)


def encode_frames(
    pixel_array: np.ndarray, transfer_syntax: str, nframes: int = 1
) -> EncapsulatedPixelData:
    """Compress an array into per-frame fragments for encapsulation.

    ``pixel_array`` is (rows, cols[, samples]) or (frames, rows, cols[, samples]).
    """
    from dosma_tpu_torch.core.io import _native

    arr = np.asarray(pixel_array)
    frames = arr if (arr.ndim >= 3 and nframes > 1) else arr[None]
    frags = []
    for frame in frames:
        if transfer_syntax == RLE_LOSSLESS:
            frag = _native_or_python(
                _native.rle_encode, rle_encode_frame, frame
            )
        elif transfer_syntax in (JPEG_LOSSLESS, JPEG_LOSSLESS_SV1):
            bits = frame.dtype.itemsize * 8
            native_ok = frame.ndim == 2 and frame.dtype.itemsize <= 2
            frag = _native_or_python(
                _native.jpeg_lossless_encode if native_ok else None,
                jpeg_lossless_encode, frame, precision=bits,
            )
        elif transfer_syntax in (JPEG_BASELINE, JPEG_EXTENDED):
            from dosma_tpu_torch.core.io.dicom.jpeg_baseline import jpeg_baseline_encode

            precision = 8 if transfer_syntax == JPEG_BASELINE else (
                8 if frame.dtype.itemsize == 1 else 12
            )
            frag = jpeg_baseline_encode(frame, precision=precision)
        elif transfer_syntax in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR_LOSSLESS):
            from dosma_tpu_torch.core.io.dicom.jpeg_ls import jpeg_ls_encode

            near = 0 if transfer_syntax == JPEG_LS_LOSSLESS else 2
            native_ok = frame.ndim == 2 and frame.dtype.kind == "u"
            frag = _native_or_python(
                (lambda a: _native.jpeg_ls_encode(a, near=near)) if native_ok else None,
                lambda a: jpeg_ls_encode(a, near=near),
                np.ascontiguousarray(frame),
            )
        elif transfer_syntax in (JPEG_2000_LOSSLESS, JPEG_2000):
            from dosma_tpu_torch.core.io.dicom.jpeg_2000 import (
                jpeg_2000_encode,
                pil_j2k_available,
            )

            # Lossless (.90) encodes with the from-scratch in-repo codec;
            # only the lossy 9/7 form needs the Pillow/OpenJPEG gate.
            if transfer_syntax == JPEG_2000 and not pil_j2k_available():
                raise unsupported_syntax_error(transfer_syntax)
            frag = jpeg_2000_encode(
                frame, lossless=transfer_syntax == JPEG_2000_LOSSLESS
            )
        else:
            raise unsupported_syntax_error(transfer_syntax)
        if len(frag) % 2:
            frag += b"\x00"
        frags.append(frag)
    return EncapsulatedPixelData(frags)


def decode_frames(
    encapsulated: EncapsulatedPixelData,
    transfer_syntax: str,
    rows: int,
    cols: int,
    samples: int,
    bits_allocated: int,
    nframes: int = 1,
) -> np.ndarray:
    """Decode encapsulated fragments into an ndarray (native byte order)."""
    from dosma_tpu_torch.core.io import _native

    frames = encapsulated.frames(nframes)
    decoded = []
    for frame in frames:
        if transfer_syntax == RLE_LOSSLESS:
            img = _native_or_python(
                _native.rle_decode, rle_decode_frame,
                frame, rows, cols, samples, bits_allocated,
            )
        elif transfer_syntax in (JPEG_LOSSLESS, JPEG_LOSSLESS_SV1):
            if samples != 1:
                raise NotImplementedError("JPEG lossless decode supports 1 sample/pixel")
            img = _native_or_python(_native.jpeg_lossless_decode, jpeg_lossless_decode, frame)
            if bits_allocated == 8:
                img = img.astype(np.uint8)
        elif transfer_syntax in (JPEG_BASELINE, JPEG_EXTENDED):
            from dosma_tpu_torch.core.io.dicom.jpeg_baseline import jpeg_baseline_decode

            # C++ fast path handles grayscale; color falls back to Python.
            img = _native_or_python(
                _native.jpeg_baseline_decode if samples == 1 else None,
                jpeg_baseline_decode, frame,
            )
            if img.ndim == 3 and samples == 1:
                raise ValueError("JPEG stream has 3 components but SamplesPerPixel=1")
            if bits_allocated == 16 and img.dtype == np.uint8:
                img = img.astype(np.uint16)
        elif transfer_syntax in (JPEG_LS_LOSSLESS, JPEG_LS_NEAR_LOSSLESS):
            from dosma_tpu_torch.core.io.dicom.jpeg_ls import jpeg_ls_decode

            if samples != 1:
                raise NotImplementedError("JPEG-LS decode supports 1 sample/pixel")
            img = _native_or_python(_native.jpeg_ls_decode, jpeg_ls_decode, frame)
            # Match the dataset's sample width (a P<=8 stream in a 16-bit
            # series must not change the series dtype / signed view).
            if bits_allocated == 16 and img.dtype == np.uint8:
                img = img.astype(np.uint16)
        elif transfer_syntax in (JPEG_2000_LOSSLESS, JPEG_2000):
            # Lossless (.90) decodes with the from-scratch in-repo codec —
            # no Pillow gate; only out-of-profile codestreams (9/7 lossy)
            # reach the Pillow fallback inside jpeg_2000_decode.
            from dosma_tpu_torch.core.io.dicom.jpeg_2000 import jpeg_2000_decode

            img = jpeg_2000_decode(frame)
            if bits_allocated == 8 and img.dtype != np.uint8:
                img = img.astype(np.uint8)
            elif bits_allocated == 16 and img.dtype == np.uint8:
                img = img.astype(np.uint16)
            if img.ndim == 3 and samples == 1:
                raise ValueError("JPEG stream has 3 components but SamplesPerPixel=1")
        else:
            raise unsupported_syntax_error(transfer_syntax)
        decoded.append(np.ascontiguousarray(img, dtype=img.dtype.newbyteorder("=")))
    out = decoded[0] if nframes <= 1 else np.stack(decoded)
    return out
