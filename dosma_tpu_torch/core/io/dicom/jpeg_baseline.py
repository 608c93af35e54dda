"""JPEG baseline/extended (DCT, lossy) codec for DICOM pixel data.

Covers the two lossy transfer syntaxes real clinical archives (PACS
exports) use routinely — the reference inherits them through pydicom's
pixel handlers behind ``read_file`` → ``pixel_array``
(``dosma/core/io/dicom_io.py:264-270``, ``:311``):

- **JPEG Baseline (Process 1)** ``1.2.840.10008.1.2.4.50`` — ITU T.81
  SOF0, 8-bit samples, Huffman entropy coding.
- **JPEG Extended (Process 2 & 4)** ``1.2.840.10008.1.2.4.51`` — SOF1,
  8/12-bit samples.

Decoder: SOF0/SOF1, 1 or 3 components, integer-ratio (h, v) subsampling
(4:4:4/4:2:2/4:2:0 and friends), interleaved scans, restart intervals,
8/16-bit quantization tables.
Multi-component output keeps the RAW decoded component values (upsampled
to full resolution); photometric interpretation (e.g. YBR_FULL_422 →
RGB) is metadata handled above the codec, matching pydicom's default of
returning the stored color space.

Encoder: single-component SOF0 (8-bit) / SOF1 (12-bit) with quality-scaled
Annex-K quantization and simple flat canonical Huffman tables — used to
synthesize encapsulated fixtures and to let :class:`DicomWriter` emit
lossy series.

The 8x8 DCT here is the orthonormal DCT-II: JPEG's normalization
(1/4·C(u)C(v)) is exactly the orthonormal scaling, so forward/inverse are
plain ``A @ block @ A.T`` matmuls batched over all blocks with numpy.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

__all__ = ["jpeg_baseline_decode", "jpeg_baseline_encode"]

# Zigzag scan order: index i of the zigzag sequence → (row, col).
_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)

# Annex K.1 luminance quantization table (zigzag-natural row-major order).
_QTABLE_LUM = np.array([
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99,
], np.int64).reshape(8, 8)

# Orthonormal DCT-II basis: A[u, x] = alpha(u) cos((2x+1) u pi / 16).
_A = np.zeros((8, 8))
for _u in range(8):
    for _x in range(8):
        _A[_u, _x] = (np.sqrt(1 / 8) if _u == 0 else 0.5) * np.cos(
            (2 * _x + 1) * _u * np.pi / 16
        )

_SOF0, _SOF1 = 0xC0, 0xC1
_DHT, _DQT, _DRI, _SOS, _EOI = 0xC4, 0xDB, 0xDD, 0xDA, 0xD9


# ----------------------------------------------------------------------
# Bit I/O (0xFF byte-stuffing aware)
# ----------------------------------------------------------------------
class _BitReader:
    def __init__(self, data: bytes, start: int):
        self.data = data
        self.pos = start
        self._acc = 0
        self._nbits = 0

    def read(self, nbits: int) -> int:
        while self._nbits < nbits:
            if self.pos >= len(self.data):
                self._acc = (self._acc << 8) | 0xFF  # pad past EOI
                self._nbits += 8
                continue
            byte = self.data[self.pos]
            self.pos += 1
            if byte == 0xFF:
                nxt = self.data[self.pos] if self.pos < len(self.data) else 0
                if nxt == 0x00:
                    self.pos += 1  # stuffed 0xFF
                else:
                    # Marker (RSTn/EOI): back up and feed padding bits.
                    self.pos -= 1
                    byte = 0xFF
                    self._acc = (self._acc << 8) | byte
                    self._nbits += 8
                    continue
            self._acc = (self._acc << 8) | byte
            self._nbits += 8
        self._nbits -= nbits
        out = (self._acc >> self._nbits) & ((1 << nbits) - 1)
        self._acc &= (1 << self._nbits) - 1
        return out

    def align_restart(self):
        """Discard bits to the next byte boundary and consume one RSTn."""
        self._acc = 0
        self._nbits = 0
        d = self.data
        while self.pos + 1 < len(d):
            if d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7:
                self.pos += 2
                return
            self.pos += 1
        raise ValueError("Expected JPEG restart marker")


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int):
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            byte = (self._acc >> self._nbits) & 0xFF
            self.buf.append(byte)
            if byte == 0xFF:
                self.buf.append(0x00)  # byte stuffing
            self._acc &= (1 << self._nbits) - 1

    def flush(self):
        if self._nbits:
            pad = 8 - self._nbits
            self.write((1 << pad) - 1, pad)  # pad with 1-bits (T.81 B.1.1.5)


def _canonical_codes(bits: List[int], values: List[int]) -> Dict[int, Tuple[int, int]]:
    """symbol → (code, length) from a DHT BITS/HUFFVAL spec."""
    codes = {}
    code = 0
    k = 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _decode_table(codes: Dict[int, Tuple[int, int]]) -> Dict[Tuple[int, int], int]:
    return {(length, code): sym for sym, (code, length) in codes.items()}


def _read_symbol(br: _BitReader, table: Dict[Tuple[int, int], int]) -> int:
    code = 0
    for length in range(1, 17):
        code = (code << 1) | br.read(1)
        sym = table.get((length, code))
        if sym is not None:
            return sym
    raise ValueError("Invalid JPEG Huffman code")


def _extend(v: int, size: int) -> int:
    """T.81 EXTEND: map the ``size``-bit magnitude ``v`` to its signed value."""
    if size == 0:
        return 0
    return v if v >= (1 << (size - 1)) else v - (1 << size) + 1


# ----------------------------------------------------------------------
# Decode
# ----------------------------------------------------------------------
def jpeg_baseline_decode(data: bytes) -> np.ndarray:
    """Decode a baseline (SOF0) or extended (SOF1) JPEG stream.

    Returns (rows, cols) for one component or (rows, cols, ncomp) with raw
    (unconverted) component values; dtype uint8 for 8-bit precision,
    uint16 for 12-bit.
    """
    if data[:2] != b"\xff\xd8":
        raise ValueError("Not a JPEG stream (missing SOI)")
    pos = 2
    qtables: Dict[int, np.ndarray] = {}
    huff_dc: Dict[int, dict] = {}
    huff_ac: Dict[int, dict] = {}
    restart_interval = 0
    precision = rows = cols = None
    comps = []  # (id, h, v, tq)

    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"Expected JPEG marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker in (0x01, *range(0xD0, 0xD8)):
            continue
        (seglen,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + seglen]
        pos += seglen
        if marker in (_SOF0, _SOF1):
            precision, rows, cols, ncomp = struct.unpack(">BHHB", body[:6])
            for c in range(ncomp):
                cid, hv, tq = body[6 + 3 * c:9 + 3 * c]
                comps.append((cid, hv >> 4, hv & 0xF, tq))
        elif marker in (0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF):
            raise NotImplementedError(
                f"Unsupported JPEG process (SOF{marker & 0xF}); baseline decoder "
                "handles SOF0/SOF1 only"
            )
        elif marker == _DQT:
            bpos = 0
            while bpos < len(body):
                pq_tq = body[bpos]
                pq, tq = pq_tq >> 4, pq_tq & 0xF
                n = 64 * (2 if pq else 1)
                raw = body[bpos + 1:bpos + 1 + n]
                vals = (
                    np.frombuffer(raw, ">u2").astype(np.int64)
                    if pq else np.frombuffer(raw, np.uint8).astype(np.int64)
                )
                q = np.zeros(64, np.int64)
                q[_ZIGZAG] = vals  # zigzag → natural order
                qtables[tq] = q.reshape(8, 8)
                bpos += 1 + n
        elif marker == _DHT:
            bpos = 0
            while bpos < len(body):
                tc_th = body[bpos]
                bits = list(body[bpos + 1:bpos + 17])
                nval = sum(bits)
                values = list(body[bpos + 17:bpos + 17 + nval])
                table = _decode_table(_canonical_codes(bits, values))
                (huff_ac if tc_th >> 4 else huff_dc)[tc_th & 0xF] = table
                bpos += 17 + nval
        elif marker == _DRI:
            (restart_interval,) = struct.unpack(">H", body[:2])
        elif marker == _SOS:
            ns = body[0]
            if ns != len(comps):
                raise NotImplementedError(
                    "Non-interleaved multi-scan JPEG is not supported"
                )
            scan_comps = []
            for c in range(ns):
                cs, td_ta = body[1 + 2 * c:3 + 2 * c]
                scan_comps.append((cs, td_ta >> 4, td_ta & 0xF))
            break
    else:
        raise ValueError("JPEG stream missing SOS")

    if precision is None:
        raise ValueError("JPEG stream missing SOF0/SOF1")
    if precision not in (8, 12):
        raise NotImplementedError(f"JPEG baseline precision {precision} unsupported")

    hmax = max(h for _, h, _, _ in comps)
    vmax = max(v for _, _, v, _ in comps)
    mcus_x = -(-cols // (8 * hmax))
    mcus_y = -(-rows // (8 * vmax))

    # Per-component coefficient stores (natural-order blocks).
    comp_info = []
    for (cid, h, v, tq) in comps:
        td = ta = 0
        for cs, d, a in scan_comps:
            if cs == cid:
                td, ta = d, a
        bw, bh = mcus_x * h, mcus_y * v
        comp_info.append({
            "h": h, "v": v, "q": qtables[tq],
            "dc": huff_dc[td], "ac": huff_ac[ta],
            "coef": np.zeros((bh * bw, 8, 8), np.int64),
            "bw": bw, "pred": 0,
        })

    br = _BitReader(data, pos)
    until_restart = restart_interval if restart_interval else None

    for my in range(mcus_y):
        for mx in range(mcus_x):
            if until_restart == 0:
                br.align_restart()
                for ci in comp_info:
                    ci["pred"] = 0
                until_restart = restart_interval
            for ci in comp_info:
                for by in range(ci["v"]):
                    for bx in range(ci["h"]):
                        blk = np.zeros(64, np.int64)
                        s = _read_symbol(br, ci["dc"])
                        diff = _extend(br.read(s), s) if s else 0
                        ci["pred"] += diff
                        blk[0] = ci["pred"]
                        k = 1
                        while k < 64:
                            rs = _read_symbol(br, ci["ac"])
                            r, s = rs >> 4, rs & 0xF
                            if s == 0:
                                if r == 15:
                                    k += 16  # ZRL
                                    continue
                                break  # EOB
                            k += r
                            if k > 63:
                                raise ValueError("JPEG AC run past end of block")
                            blk[_ZIGZAG[k]] = _extend(br.read(s), s)
                            k += 1
                        row = my * ci["v"] + by
                        col = mx * ci["h"] + bx
                        ci["coef"][row * ci["bw"] + col] = blk.reshape(8, 8)
            if until_restart is not None:
                until_restart -= 1

    # Dequantize + batched IDCT + reassemble per component.
    shift = 1 << (precision - 1)
    maxval = (1 << precision) - 1
    planes = []
    for ci in comp_info:
        F = ci["coef"].astype(np.float64) * ci["q"][None]
        pix = np.einsum("ux,nuv,vy->nxy", _A, F, _A, optimize=True) + shift
        bh = len(ci["coef"]) // ci["bw"]
        img = pix.reshape(bh, ci["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, ci["bw"] * 8)
        # Upsample subsampled components to full MCU resolution. Integer
        # ratios only (4:4:4 / 4:2:2 / 4:2:0 and friends — every ratio
        # JFIF encoders emit); a T.81-legal non-integer ratio like
        # {h=3, h=2} would silently misalign planes, so reject it.
        if vmax % ci["v"] or hmax % ci["h"]:
            raise NotImplementedError(
                f"Non-integer chroma subsampling ratio (h={ci['h']}, v={ci['v']} "
                f"vs hmax={hmax}, vmax={vmax}) is not supported"
            )
        ry, rx = vmax // ci["v"], hmax // ci["h"]
        if ry > 1 or rx > 1:
            img = np.repeat(np.repeat(img, ry, axis=0), rx, axis=1)
        planes.append(np.clip(np.round(img[:rows, :cols]), 0, maxval))

    dtype = np.uint8 if precision == 8 else np.uint16
    if len(planes) == 1:
        return planes[0].astype(dtype)
    return np.stack(planes, axis=-1).astype(dtype)


# ----------------------------------------------------------------------
# Encode (single component; SOF0 for 8-bit, SOF1 for 12-bit)
# ----------------------------------------------------------------------
def _flat_tables(precision: int):
    """Legal (if suboptimal) canonical Huffman tables covering every
    category a ``precision``-bit encode can emit: all DC categories at
    length 5, all AC (run, size) symbols at length 8 (Kraft sums < 1)."""
    max_cat = precision + 4  # DCT gain: |coef| <= 8 * 2^(P-1) → size ≤ P+3; +1 margin
    dc_vals = list(range(min(16, max_cat + 1)))
    dc_bits = [0] * 16
    dc_bits[4] = len(dc_vals)  # all at length 5
    ac_vals = [0x00, 0xF0]
    for run in range(16):
        for size in range(1, min(15, max_cat + 1)):
            ac_vals.append((run << 4) | size)
    ac_bits = [0] * 16
    ac_bits[7] = len(ac_vals)  # all at length 8
    assert len(ac_vals) * 2 ** -8 + 0 < 1.0
    return (dc_bits, dc_vals), (ac_bits, ac_vals)


def _quant_table(quality: int) -> np.ndarray:
    quality = min(max(int(quality), 1), 100)
    scale = 5000 / quality if quality < 50 else 200 - 2 * quality
    q = np.clip((_QTABLE_LUM * scale + 50) // 100, 1, 255).astype(np.int64)
    return q


def jpeg_baseline_encode(frame: np.ndarray, precision: int = 8, quality: int = 95) -> bytes:
    """Encode one grayscale frame as JPEG baseline (8-bit, SOF0) or
    extended (12-bit, SOF1)."""
    if frame.ndim != 2:
        raise NotImplementedError("JPEG baseline encoder supports 1 component")
    if precision not in (8, 12):
        raise ValueError("precision must be 8 or 12")
    maxval = (1 << precision) - 1
    if frame.min() < 0 or frame.max() > maxval:
        raise ValueError(f"frame values exceed {precision}-bit range")

    rows, cols = frame.shape
    q = _quant_table(quality)
    if precision == 12:
        # Keep quantized DC diffs within Huffman category 15 and AC
        # coefficients within category 14 (|F| ≤ 8·2^11 = 16384 pre-quant).
        q = np.maximum(q, 2)
    (dc_bits, dc_vals), (ac_bits, ac_vals) = _flat_tables(precision)
    dc_codes = _canonical_codes(dc_bits, dc_vals)
    ac_codes = _canonical_codes(ac_bits, ac_vals)

    out = bytearray(b"\xff\xd8")  # SOI
    # DQT (8-bit unless any value > 255 — quality ≥ 1 keeps ≤ 255 here)
    zz = q.reshape(-1)[_ZIGZAG]
    out += struct.pack(">BBHB", 0xFF, _DQT, 2 + 1 + 64, 0x00) + bytes(
        int(v) for v in zz
    )
    # SOFn
    sof = _SOF0 if precision == 8 else _SOF1
    out += struct.pack(">BBHBHHB", 0xFF, sof, 8 + 3, precision, rows, cols, 1)
    out += bytes([1, 0x11, 0])  # component 1, h=v=1, qtable 0
    # DHT (DC class 0 id 0, AC class 1 id 0)
    for cls, (bits, vals) in ((0, (dc_bits, dc_vals)), (1, (ac_bits, ac_vals))):
        out += struct.pack(">BBHB", 0xFF, _DHT, 2 + 1 + 16 + len(vals), (cls << 4) | 0)
        out += bytes(bits) + bytes(vals)
    # SOS
    out += struct.pack(">BBHB", 0xFF, _SOS, 2 + 1 + 2 * 1 + 3, 1)
    out += bytes([1, 0x00, 0, 63, 0])

    # Blocks: pad to 8x8 multiple with edge replication.
    py, px = (-rows) % 8, (-cols) % 8
    arr = np.pad(frame.astype(np.float64), ((0, py), (0, px)), mode="edge")
    by, bx = arr.shape[0] // 8, arr.shape[1] // 8
    blocks = arr.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    blocks = blocks - (1 << (precision - 1))
    F = np.einsum("ux,nxy,vy->nuv", _A, blocks, _A, optimize=True)
    Fq = np.round(F / q[None]).astype(np.int64)
    zzblocks = Fq.reshape(-1, 64)[:, _ZIGZAG]

    bw = _BitWriter()
    pred = 0
    for blk in zzblocks:
        diff = int(blk[0]) - pred
        pred = int(blk[0])
        size = int(abs(diff)).bit_length()
        code, length = dc_codes[size]
        bw.write(code, length)
        if size:
            v = diff if diff > 0 else diff + (1 << size) - 1
            bw.write(v, size)
        run = 0
        nz = np.nonzero(blk[1:])[0]
        last = nz[-1] + 1 if len(nz) else 0
        for k in range(1, last + 1):
            val = int(blk[k])
            if val == 0:
                run += 1
                continue
            while run > 15:
                code, length = ac_codes[0xF0]
                bw.write(code, length)
                run -= 16
            size = abs(val).bit_length()
            code, length = ac_codes[(run << 4) | size]
            bw.write(code, length)
            v = val if val > 0 else val + (1 << size) - 1
            bw.write(v, size)
            run = 0
        if last < 63:
            code, length = ac_codes[0x00]  # EOB
            bw.write(code, length)
    bw.flush()
    out += bw.buf
    out += struct.pack(">BB", 0xFF, _EOI)
    return bytes(out)
