"""JPEG-LS (ITU-T T.87 / ISO 14495-1, LOCO-I) codec for DICOM pixel data.

Covers the two JPEG-LS transfer syntaxes:

- **JPEG-LS Lossless** ``1.2.840.10008.1.2.4.80`` (NEAR = 0)
- **JPEG-LS Near-Lossless** ``1.2.840.10008.1.2.4.81`` (NEAR > 0)

The reference reads these through pydicom's pixel handlers (CharLS);
neither pydicom nor CharLS exists in this stack, so this is a from-spec
implementation of the full T.87 baseline for single-component images:

- gradient context modeling (365 regular contexts + 2 run-interruption
  contexts), default T1/T2/T3 thresholds incl. the NEAR/MAXVAL scaling
  rules (C.2.4.1.1.1),
- median edge-detecting predictor with per-context bias correction
  (code segments A.4-A.6),
- Golomb-Rice coding with the A.11 error mapping (incl. the
  ``k==0 && 2B<=-N`` interleave flip) and LIMIT escape,
- run mode with the J[] run-order table and A.21/A.22 run-interruption
  coding,
- 0xFF bit-stuffing (a ZERO bit follows every 0xFF byte of the entropy
  stream — T.87's marker-avoidance, distinct from T.81's 0xFF00 byte
  stuffing),
- LSE preset-parameter segments (ID 1).

Both directions are provided; lossless round trips are exact and
near-lossless reconstruction error is bounded by NEAR (asserted in
tests). Multi-component/interleaved scans raise NotImplementedError
(medical grayscale is single-component).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

__all__ = ["jpeg_ls_decode", "jpeg_ls_encode"]

_SOI, _EOI = 0xD8, 0xD9
_SOF55 = 0xF7  # JPEG-LS frame
_LSE = 0xF8  # JPEG-LS preset parameters
_SOS = 0xDA

# Run-order codes J[0..31] (T.87 A.2.3).
_J = [0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
     5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15]


def _default_thresholds(maxval: int, near: int) -> Tuple[int, int, int, int]:
    """Default T1/T2/T3/RESET (T.87 C.2.4.1.1.1)."""
    def clamp(t, lo):
        return min(max(t, lo), maxval)

    if maxval >= 128:
        factor = (min(maxval, 4095) + 128) // 256
        t1 = clamp(factor * (3 - 2) + 2 + 3 * near, near + 1)
        t2 = clamp(factor * (7 - 3) + 3 + 5 * near, t1)
        t3 = clamp(factor * (21 - 4) + 4 + 7 * near, t2)
    else:
        factor = 256 // (maxval + 1)
        t1 = clamp(max(2, 3 // factor + 3 * near), near + 1)
        t2 = clamp(max(3, 7 // factor + 5 * near), t1)
        t3 = clamp(max(4, 21 // factor + 7 * near), t2)
    return t1, t2, t3, 64


class _State:
    """Modeling state shared by encoder and decoder (A.2.1, A.8)."""

    def __init__(self, maxval: int, near: int, reset: int):
        self.maxval = maxval
        self.near = near
        self.reset = reset
        self.range = (maxval + 2 * near) // (2 * near + 1) + 1
        self.qbpp = (self.range - 1).bit_length()  # ceil(log2(RANGE))
        bpp = max(2, (maxval + 1 - 1).bit_length())
        self.bpp = bpp
        self.limit = 2 * (bpp + max(8, bpp))
        init_a = max(2, (self.range + 32) // 64)
        # Regular contexts 0..364; run-interruption contexts 365 (type 0)
        # and 366 (type 1).
        self.A = [init_a] * 367
        self.B = [0] * 367
        self.C = [0] * 367
        self.N = [1] * 367
        self.Nn = [0, 0]  # negatives count for contexts 365/366
        self.run_index = 0

    # ---- regular mode -------------------------------------------------
    def golomb_k(self, q: int) -> int:
        k = 0
        while (self.N[q] << k) < self.A[q]:
            k += 1
        return k

    def map_error(self, errval: int, k: int, q: int) -> int:
        """A.11 error mapping."""
        if self.near == 0 and k == 0 and 2 * self.B[q] <= -self.N[q]:
            return 2 * errval + 1 if errval >= 0 else -2 * (errval + 1)
        return 2 * errval if errval >= 0 else -2 * errval - 1

    def unmap_error(self, merr: int, k: int, q: int) -> int:
        if self.near == 0 and k == 0 and 2 * self.B[q] <= -self.N[q]:
            return (merr - 1) // 2 if merr % 2 else -(merr // 2) - 1
        return -((merr + 1) // 2) if merr % 2 else merr // 2

    def update(self, q: int, errval: int):
        """A.12/A.13: variable update + bias correction."""
        self.B[q] += errval * (2 * self.near + 1)
        self.A[q] += abs(errval)
        if self.N[q] == self.reset:
            self.A[q] >>= 1
            self.B[q] = self.B[q] >> 1 if self.B[q] >= 0 else -((1 - self.B[q]) >> 1)
            self.N[q] >>= 1
        self.N[q] += 1
        if self.B[q] <= -self.N[q]:
            self.C[q] = max(self.C[q] - 1, -128)
            self.B[q] += self.N[q]
            if self.B[q] <= -self.N[q]:
                self.B[q] = -self.N[q] + 1
        elif self.B[q] > 0:
            self.C[q] = min(self.C[q] + 1, 127)
            self.B[q] -= self.N[q]
            if self.B[q] > 0:
                self.B[q] = 0

    # ---- run-interruption mode ----------------------------------------
    def ri_k(self, ritype: int) -> int:
        q = 365 + ritype
        temp = self.A[q] + ((self.N[q] >> 1) if ritype else 0)
        k = 0
        while (self.N[q] << k) < temp:
            k += 1
        return k

    def ri_map(self, errval: int, k: int, ritype: int) -> int:
        """A.21: map bit for run-interruption errors."""
        if k == 0 and errval > 0 and 2 * self.Nn[ritype] < self.N[365 + ritype]:
            return 1
        if errval < 0 and 2 * self.Nn[ritype] >= self.N[365 + ritype]:
            return 1
        if errval < 0 and k != 0:
            return 1
        return 0

    def ri_unmap(self, em: int, k: int, ritype: int) -> int:
        """Inverse of ``EMErrval = 2*|e| - RItype - map``: the map bit is
        ``(em + RItype) & 1`` (2|e| is even) and the sign falls out of the
        A.21 map conditions — negative exactly when
        ``map == (k != 0 or 2*Nn >= N)`` (the CharLS inversion)."""
        temp = em + ritype
        mapbit = temp & 1
        e_abs = (temp + mapbit) // 2
        cond = (k != 0) or (2 * self.Nn[ritype] >= self.N[365 + ritype])
        return -e_abs if cond == bool(mapbit) else e_abs

    def ri_update(self, ritype: int, errval: int, em: int):
        """A.22 statistics update."""
        q = 365 + ritype
        if errval < 0:
            self.Nn[ritype] += 1
        self.A[q] += (em + 1 - ritype) >> 1
        if self.N[q] == self.reset:
            self.A[q] >>= 1
            self.N[q] >>= 1
            self.Nn[ritype] >>= 1
        self.N[q] += 1

    # ---- shared helpers ------------------------------------------------
    def quantize_error(self, errval: int) -> int:
        if self.near == 0:
            return errval
        if errval > 0:
            return (self.near + errval) // (2 * self.near + 1)
        return -((self.near - errval) // (2 * self.near + 1))

    def mod_reduce(self, errval: int) -> int:
        if errval < 0:
            errval += self.range
        if errval >= (self.range + 1) // 2:
            errval -= self.range
        return errval

    def reconstruct(self, px: int, sign: int, errval_q: int) -> int:
        rx = px + sign * errval_q * (2 * self.near + 1)
        if rx < -self.near:
            rx += self.range * (2 * self.near + 1)
        elif rx > self.maxval + self.near:
            rx -= self.range * (2 * self.near + 1)
        return min(max(rx, 0), self.maxval)


def _quantize_gradient(d: int, t1: int, t2: int, t3: int, near: int) -> int:
    if d <= -t3:
        return -4
    if d <= -t2:
        return -3
    if d <= -t1:
        return -2
    if d < -near:
        return -1
    if d <= near:
        return 0
    if d < t1:
        return 1
    if d < t2:
        return 2
    if d < t3:
        return 3
    return 4


def _predict(a: int, b: int, c: int) -> int:
    if c >= max(a, b):
        return min(a, b)
    if c <= min(a, b):
        return max(a, b)
    return a + b - c


# ----------------------------------------------------------------------
# Bit I/O with T.87 0xFF bit-stuffing
# ----------------------------------------------------------------------
class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self._acc = 0
        self._n = 0
        self._width = 8

    def write_bit(self, bit: int):
        if self._n == 0:
            self._width = 7 if (self.buf and self.buf[-1] == 0xFF) else 8
        self._acc = (self._acc << 1) | (bit & 1)
        self._n += 1
        if self._n == self._width:
            self.buf.append(self._acc)
            self._acc = 0
            self._n = 0

    def write_bits(self, value: int, nbits: int):
        for i in range(nbits - 1, -1, -1):
            self.write_bit((value >> i) & 1)

    def flush(self):
        if self._n:
            self._acc <<= self._width - self._n
            self.buf.append(self._acc)
            self._acc = 0
            self._n = 0


class _BitReader:
    def __init__(self, data: bytes, pos: int):
        self.data = data
        self.pos = pos
        self._acc = 0
        self._n = 0
        self._prev_ff = False

    def _fill(self):
        d = self.data
        if self.pos >= len(d):
            self._acc = (self._acc << 8)
            self._n += 8
            return
        byte = d[self.pos]
        if self._prev_ff:
            if byte & 0x80:
                # Marker: scan is over; pad with zeros.
                self._acc = self._acc << 8
                self._n += 8
                return
            self.pos += 1
            self._acc = (self._acc << 7) | (byte & 0x7F)
            self._n += 7
            self._prev_ff = False
        else:
            self.pos += 1
            self._acc = (self._acc << 8) | byte
            self._n += 8
            self._prev_ff = byte == 0xFF

    def read_bit(self) -> int:
        if self._n == 0:
            self._fill()
        self._n -= 1
        bit = (self._acc >> self._n) & 1
        self._acc &= (1 << self._n) - 1
        return bit

    def read_bits(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.read_bit()
        return v


# ----------------------------------------------------------------------
# Golomb coding with LIMIT escape (A.5.3)
# ----------------------------------------------------------------------
def _golomb_encode(bw: _BitWriter, merr: int, k: int, limit: int, qbpp: int):
    high = merr >> k
    if high < limit - qbpp - 1:
        for _ in range(high):
            bw.write_bit(0)
        bw.write_bit(1)
        bw.write_bits(merr & ((1 << k) - 1), k)
    else:
        for _ in range(limit - qbpp - 1):
            bw.write_bit(0)
        bw.write_bit(1)
        bw.write_bits(merr - 1, qbpp)


def _golomb_decode(br: _BitReader, k: int, limit: int, qbpp: int) -> int:
    high = 0
    while br.read_bit() == 0:
        high += 1
        if high > limit + 64:
            raise ValueError("Corrupt JPEG-LS stream (runaway Golomb prefix)")
    if high < limit - qbpp - 1:
        return (high << k) | br.read_bits(k)
    return br.read_bits(qbpp) + 1


# ----------------------------------------------------------------------
# Neighbor access (CharLS edge conventions: Ra(0) = Rb(0); Rc(row, 0) =
# Ra(row-1, 0) before its line ran, i.e. rec[row-2][0]; Rd(last) = Rb).
# ----------------------------------------------------------------------
def _neighbors(rec, row: int, col: int, cols: int):
    if row == 0:
        a = int(rec[0][col - 1]) if col else 0
        return a, 0, 0, 0
    prev = rec[row - 1]
    b = int(prev[col])
    d = int(prev[col + 1]) if col + 1 < cols else b
    if col == 0:
        a = int(prev[0])
        c = int(rec[row - 2][0]) if row >= 2 else 0
    else:
        a = int(rec[row][col - 1])
        c = int(prev[col - 1])
    return a, b, c, d


# ----------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------
def jpeg_ls_decode(data: bytes) -> np.ndarray:
    """Decode a single-component JPEG-LS stream → (rows, cols) uint8/uint16."""
    if data[:2] != bytes([0xFF, _SOI]):
        raise ValueError("Not a JPEG-LS stream (missing SOI)")
    pos = 2
    precision = rows = cols = None
    maxval = None
    t1 = t2 = t3 = reset = None
    near = 0

    while pos + 1 < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"Expected JPEG-LS marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker in (0x01, *range(0xD0, 0xD8)):
            continue
        if marker == 0xDD:  # DRI: restart markers would corrupt silently
            raise NotImplementedError(
                "JPEG-LS restart intervals (DRI/RSTn) are not supported"
            )
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + seglen]
        pos += seglen
        if marker == _SOF55:
            precision, rows, cols, ncomp = struct.unpack(">BHHB", body[:6])
            if ncomp != 1:
                raise NotImplementedError("JPEG-LS decoder supports 1 component")
        elif marker == _LSE:
            if body[0] == 1:
                maxval, t1, t2, t3, reset = struct.unpack(">HHHHH", body[1:11])
            else:
                raise NotImplementedError("JPEG-LS mapping tables unsupported")
        elif marker == _SOS:
            ns = body[0]
            if ns != 1:
                raise NotImplementedError("JPEG-LS interleaved scans unsupported")
            near = body[1 + 2 * ns]
            if body[2 + 2 * ns] != 0:
                raise NotImplementedError("JPEG-LS ILV != 0 unsupported")
            break
    else:
        raise ValueError("JPEG-LS stream missing SOS")

    if precision is None:
        raise ValueError("JPEG-LS stream missing SOF55")
    if maxval in (None, 0):
        maxval = (1 << precision) - 1
    defaults = _default_thresholds(maxval, near)
    if t1 in (None, 0):
        t1 = defaults[0]
    if t2 in (None, 0):
        t2 = defaults[1]
    if t3 in (None, 0):
        t3 = defaults[2]
    if reset in (None, 0):
        reset = defaults[3]

    st = _State(maxval, near, reset)
    br = _BitReader(data, pos)
    rec = [[0] * cols for _ in range(rows)]

    for row in range(rows):
        cur = rec[row]
        col = 0
        while col < cols:
            a, b, c, d = _neighbors(rec, row, col, cols)
            d1, d2, d3 = d - b, b - c, c - a
            if abs(d1) <= near and abs(d2) <= near and abs(d3) <= near:
                col = _decode_run(st, br, rec, row, col, cols, a)
                continue

            q1 = _quantize_gradient(d1, t1, t2, t3, near)
            q2 = _quantize_gradient(d2, t1, t2, t3, near)
            q3 = _quantize_gradient(d3, t1, t2, t3, near)
            q = 81 * q1 + 9 * q2 + q3
            sign = 1
            if q < 0:
                q, sign = -q, -1

            px = min(max(_predict(a, b, c) + sign * st.C[q], 0), maxval)
            k = st.golomb_k(q)
            merr = _golomb_decode(br, k, st.limit, st.qbpp)
            errval = st.unmap_error(merr, k, q)
            cur[col] = st.reconstruct(px, sign, errval)
            st.update(q, errval)
            col += 1

    dtype = np.uint8 if precision <= 8 else np.uint16
    return np.asarray(rec, dtype)


def _decode_run(st: _State, br: _BitReader, rec, row: int, col: int, cols: int, a: int) -> int:
    cur = rec[row]
    while True:
        if br.read_bit() == 1:
            seg = 1 << _J[st.run_index]
            count = min(seg, cols - col)
            for _ in range(count):
                cur[col] = a
                col += 1
            if count == seg:
                if st.run_index < 31:
                    st.run_index += 1
                if col >= cols:
                    return col
                continue  # full segment, line continues: next run bit
            return col  # partial fill ended the line (encoder's A.18 1-bit)
        # 0-bit: partial run length in J[run_index] bits, then interruption.
        if _J[st.run_index]:
            r = br.read_bits(_J[st.run_index])
            for _ in range(r):
                cur[col] = a
                col += 1
        break

    # Run-interruption sample (A.19-A.22).
    b_here = int(rec[row - 1][col]) if row else 0
    ritype = 1 if abs(a - b_here) <= st.near else 0
    if ritype:
        px, sign = a, 1
    else:
        px = b_here
        sign = -1 if a > b_here else 1

    k = st.ri_k(ritype)
    em = _golomb_decode(br, k, st.limit - _J[st.run_index] - 1, st.qbpp)
    errval = st.ri_unmap(em, k, ritype)
    cur[col] = st.reconstruct(px, sign, errval)
    st.ri_update(ritype, errval, em)
    if st.run_index > 0:
        st.run_index -= 1
    return col + 1


# ----------------------------------------------------------------------
# Encode
# ----------------------------------------------------------------------
def jpeg_ls_encode(frame: np.ndarray, near: int = 0) -> bytes:
    """Encode one grayscale frame as a JPEG-LS stream (lossless when
    ``near=0``)."""
    arr = np.asarray(frame)
    if arr.ndim != 2:
        raise NotImplementedError("JPEG-LS encoder supports 1 component")
    if arr.dtype.kind != "u" or arr.dtype.itemsize > 2:
        raise ValueError("JPEG-LS encoder expects uint8/uint16 input")
    # Precision comes from the SAMPLE WIDTH, not the data max: PS3.5
    # requires P == BitsStored, and a data-derived P would let a dark edge
    # slice change the stream precision (and decoded dtype) mid-series.
    precision = 8 * arr.dtype.itemsize
    maxval = (1 << precision) - 1
    rows, cols = arr.shape
    t1, t2, t3, reset = _default_thresholds(maxval, near)

    out = bytearray([0xFF, _SOI])
    out += struct.pack(">BBHBHHB", 0xFF, _SOF55, 8 + 3, precision, rows, cols, 1)
    out += bytes([1, 0x11, 0])
    out += struct.pack(">BBHBHHHHH", 0xFF, _LSE, 13, 1, maxval, t1, t2, t3, reset)
    out += struct.pack(">BBHB", 0xFF, _SOS, 6 + 2, 1)
    out += bytes([1, 0x00, near, 0, 0])

    st = _State(maxval, near, reset)
    bw = _BitWriter()
    src = arr.astype(np.int64).tolist()
    rec = [[0] * cols for _ in range(rows)]

    for row in range(rows):
        cur = rec[row]
        col = 0
        while col < cols:
            a, b, c, d = _neighbors(rec, row, col, cols)
            d1, d2, d3 = d - b, b - c, c - a
            if abs(d1) <= near and abs(d2) <= near and abs(d3) <= near:
                col = _encode_run(st, bw, src, rec, row, col, cols, a)
                continue

            q1 = _quantize_gradient(d1, t1, t2, t3, near)
            q2 = _quantize_gradient(d2, t1, t2, t3, near)
            q3 = _quantize_gradient(d3, t1, t2, t3, near)
            q = 81 * q1 + 9 * q2 + q3
            sign = 1
            if q < 0:
                q, sign = -q, -1

            px = min(max(_predict(a, b, c) + sign * st.C[q], 0), maxval)
            errval = st.mod_reduce(st.quantize_error(sign * (src[row][col] - px)))
            k = st.golomb_k(q)
            _golomb_encode(bw, st.map_error(errval, k, q), k, st.limit, st.qbpp)
            cur[col] = st.reconstruct(px, sign, errval)
            st.update(q, errval)
            col += 1

    bw.flush()
    out += bw.buf
    out += bytes([0xFF, _EOI])
    return bytes(out)


def _encode_run(st: _State, bw: _BitWriter, src, rec, row: int, col: int,
                cols: int, a: int) -> int:
    near = st.near
    cur = rec[row]
    run_len = 0
    while col < cols and abs(src[row][col] - a) <= near:
        cur[col] = a
        col += 1
        run_len += 1

    while run_len >= (1 << _J[st.run_index]):
        bw.write_bit(1)
        run_len -= 1 << _J[st.run_index]
        if st.run_index < 31:
            st.run_index += 1

    if col >= cols:
        if run_len > 0:
            bw.write_bit(1)  # A.18: partial run ended by line end
        return col

    bw.write_bit(0)
    if _J[st.run_index]:
        bw.write_bits(run_len, _J[st.run_index])

    b_here = int(rec[row - 1][col]) if row else 0
    ritype = 1 if abs(a - b_here) <= near else 0
    if ritype:
        px, sign = a, 1
    else:
        px = b_here
        sign = -1 if a > b_here else 1

    errval = st.mod_reduce(st.quantize_error(sign * (src[row][col] - px)))
    k = st.ri_k(ritype)
    em = 2 * abs(errval) - ritype - st.ri_map(errval, k, ritype)
    _golomb_encode(bw, em, k, st.limit - _J[st.run_index] - 1, st.qbpp)
    cur[col] = st.reconstruct(px, sign, errval)
    st.ri_update(ritype, errval, em)
    if st.run_index > 0:
        st.run_index -= 1
    return col + 1
