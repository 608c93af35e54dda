"""From-scratch JPEG 2000 Part-1 LOSSLESS codec (ITU-T T.800).

Decodes the raw codestreams DICOM encapsulates for transfer syntax
1.2.840.10008.1.2.4.90 (JPEG 2000 Image Compression — Lossless Only):
reversible 5/3 DWT, EBCOT tier-1 (MQ arithmetic coding of bitplane
passes), tier-2 packet headers with tag trees, multi-level resolutions,
multi-tile codestreams, and 1..N components (with the reversible
component transform). This removes the last delegated codec in the I/O
stack — the reference delegates J2K to whatever pydicom handler is
installed (``dosma/core/io/dicom_io.py:264-270``); here
the decoder is in-repo like the JPEG/JPEG-LS/RLE ones
(:mod:`dosma_tpu_torch.core.io.dicom.codecs`).

Scope: the lossless profile DICOM actually uses — reversible 5/3
transform, no quantization, default code-block styles. The irreversible
9/7 path (syntax .91, lossy) still rides Pillow/OpenJPEG via
:mod:`dosma_tpu_torch.core.io.dicom.jpeg_2000`; this module raises
``Unsupported`` for it so the wrapper can fall through.

Hot loops (MQ decode + tier-1 context modeling) have a C++ twin in
``native/dosma_codecs.cpp``; this Python implementation is the behavioral
reference the native one is tested against, and the fallback when the
native library is not built.
"""

from __future__ import annotations

import math
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["j2k_decode", "j2k_encode", "Unsupported"]


class Unsupported(NotImplementedError):
    """Raised for codestream features outside the lossless Part-1 scope."""


# ----------------------------------------------------------------------
# MQ arithmetic decoder (ITU-T T.88 software conventions)
# ----------------------------------------------------------------------
# (Qe, NMPS, NLPS, SWITCH)
_MQ_TABLE = (
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0), (0x0AC1, 4, 12, 0),
    (0x0521, 5, 29, 0), (0x0221, 38, 33, 0), (0x5601, 7, 6, 1), (0x5401, 8, 14, 0),
    (0x4801, 9, 14, 0), (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1), (0x5401, 16, 14, 0),
    (0x5101, 17, 15, 0), (0x4801, 18, 16, 0), (0x3801, 19, 17, 0), (0x3401, 20, 18, 0),
    (0x3001, 21, 19, 0), (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0), (0x1401, 28, 25, 0),
    (0x1201, 29, 26, 0), (0x1101, 30, 27, 0), (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0),
    (0x08A1, 33, 30, 0), (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0), (0x0085, 40, 37, 0),
    (0x0049, 41, 38, 0), (0x0025, 42, 39, 0), (0x0015, 43, 40, 0), (0x0009, 44, 41, 0),
    (0x0005, 45, 42, 0), (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
)

N_CTX = 19
CTX_UNI = 18
CTX_RL = 17


def _init_contexts():
    idx = [0] * N_CTX
    mps = [0] * N_CTX
    idx[0] = 4       # zero-neighborhood significance context
    idx[CTX_RL] = 3
    idx[CTX_UNI] = 46
    return idx, mps


class _MQDecoder:
    __slots__ = ("data", "bp", "c", "a", "ct", "idx", "mps")

    def __init__(self, data: bytes):
        self.data = data
        self.idx, self.mps = _init_contexts()
        self.bp = 0
        b0 = data[0] if data else 0xFF
        self.c = b0 << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def _bytein(self):
        data, bp = self.data, self.bp
        b = data[bp] if bp < len(data) else 0xFF
        if b == 0xFF:
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            if b1 > 0x8F:
                self.c += 0xFF00
                self.ct = 8
            else:
                self.bp = bp + 1
                self.c += b1 << 9
                self.ct = 7
        else:
            self.bp = bp + 1
            b1 = data[bp + 1] if bp + 1 < len(data) else 0xFF
            self.c += b1 << 8
            self.ct = 8

    def decode(self, cx: int) -> int:
        idx = self.idx
        i = idx[cx]
        qe, nmps, nlps, switch = _MQ_TABLE[i]
        self.a -= qe
        if ((self.c >> 16) & 0xFFFF) < qe:
            # LPS exchange path
            if self.a < qe:
                d = self.mps[cx]
                idx[cx] = nmps
            else:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] = 1 - self.mps[cx]
                idx[cx] = nlps
            self.a = qe
        else:
            self.c = (self.c - (qe << 16)) & 0xFFFFFFFF
            if self.a & 0x8000:
                return self.mps[cx]
            if self.a < qe:
                d = 1 - self.mps[cx]
                if switch:
                    self.mps[cx] = 1 - self.mps[cx]
                idx[cx] = nlps
            else:
                d = self.mps[cx]
                idx[cx] = nmps
        # renormalize
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a & 0x8000:
                break
        return d


# ----------------------------------------------------------------------
# Packet-header bit reader (with 0xFF bit-stuffing) and tag trees
# ----------------------------------------------------------------------
class _BitReader:
    __slots__ = ("data", "pos", "bitbuf", "nbits", "last")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.bitbuf = 0
        self.nbits = 0
        self.last = 0

    def bit(self) -> int:
        if self.nbits == 0:
            b = self.data[self.pos]
            self.pos += 1
            if self.last == 0xFF:
                # stuffed: only 7 payload bits, MSB is the stuffing 0
                self.bitbuf = b & 0x7F
                self.nbits = 7
            else:
                self.bitbuf = b
                self.nbits = 8
            self.last = b
        self.nbits -= 1
        return (self.bitbuf >> self.nbits) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self):
        """End of packet header: discard partial bits; a trailing 0xFF
        consumes its stuffed bit byte."""
        self.nbits = 0
        if self.last == 0xFF:
            # T.800 B.10.1: when the final header byte is 0xFF, the next
            # byte (whose MSB is the stuffing 0) is also part of the
            # header — consume it.
            self.pos += 1
        self.last = 0


class _TagTree:
    def __init__(self, w: int, h: int):
        self.levels = []
        while True:
            self.levels.append((w, h))
            if w <= 1 and h <= 1:
                break
            w = (w + 1) // 2
            h = (h + 1) // 2
        n = len(self.levels)
        self.value = [np.zeros((lh, lw), np.int32) for lw, lh in self.levels]
        self.known = [np.zeros((lh, lw), bool) for lw, lh in self.levels]
        self.low = [np.zeros((lh, lw), np.int32) for lw, lh in self.levels]
        self.n = n

    def decode(self, reader: _BitReader, x: int, y: int, threshold: int) -> bool:
        """True iff value(x, y) < threshold (decoding just enough bits)."""
        low = 0
        for lev in range(self.n - 1, -1, -1):
            xx, yy = x >> lev, y >> lev
            if self.low[lev][yy, xx] < low:
                self.low[lev][yy, xx] = low
            while (not self.known[lev][yy, xx]) and self.low[lev][yy, xx] < threshold:
                if reader.bit():
                    self.value[lev][yy, xx] = self.low[lev][yy, xx]
                    self.known[lev][yy, xx] = True
                else:
                    self.low[lev][yy, xx] += 1
            if self.known[lev][yy, xx]:
                low = int(self.value[lev][yy, xx])
            else:
                return False  # value >= threshold (so far)
        return int(self.value[0][y, x]) < threshold

    def get(self, reader: _BitReader, x: int, y: int) -> int:
        """Decode until the leaf value is fully known; return it."""
        t = 1
        while not self.decode(reader, x, y, t):
            t += 1
        return int(self.value[0][y, x])


# ----------------------------------------------------------------------
# Tier-1: EBCOT code-block decoding
# ----------------------------------------------------------------------
# Zero-coding context lookup, built once per band orientation.
def _zc_context(h, v, d, band: str) -> int:
    if band == "HL":       # transpose: swap h and v
        h, v = v, h
    if band != "HH":
        if h == 2:
            return 8
        if h == 1:
            return 7 if v >= 1 else (6 if d >= 1 else 5)
        if v == 2:
            return 4
        if v == 1:
            return 3
        return 2 if d >= 2 else (1 if d == 1 else 0)
    # HH
    if d >= 3:
        return 8
    if d == 2:
        return 7 if h + v >= 1 else 6
    if d == 1:
        if h + v >= 2:
            return 5
        return 4 if h + v == 1 else 3
    if h + v >= 2:
        return 2
    return 1 if h + v == 1 else 0


_SC_LUT = {
    (1, 1): (13, 0), (1, 0): (12, 0), (1, -1): (11, 0),
    (0, 1): (10, 0), (0, 0): (9, 0), (0, -1): (10, 1),
    (-1, 1): (11, 1), (-1, 0): (12, 1), (-1, -1): (13, 1),
}


class _BlockDecoder:
    """Decode one code-block's coding passes into sign/magnitude arrays."""

    def __init__(self, w: int, h: int, band: str, data: bytes):
        self.w, self.h = w, h
        self.band = band
        self.mq = _MQDecoder(data)
        self.sig = np.zeros((h + 2, w + 2), np.uint8)   # 1-pad halo
        self.sgn = np.zeros((h + 2, w + 2), np.int8)    # -1 / +1 when sig
        self.visited = np.zeros((h + 2, w + 2), np.uint8)
        self.refined = np.zeros((h, w), bool)
        self.mag = np.zeros((h, w), np.int64)
        self.weight = 1  # value of the bitplane currently being decoded

    # neighbor counts at padded coords (iy, ix) = (y+1, x+1)
    def _hvd(self, py, px):
        s = self.sig
        h = int(s[py, px - 1]) + int(s[py, px + 1])
        v = int(s[py - 1, px]) + int(s[py + 1, px])
        d = (int(s[py - 1, px - 1]) + int(s[py - 1, px + 1])
             + int(s[py + 1, px - 1]) + int(s[py + 1, px + 1]))
        return h, v, d

    def _decode_sign(self, py, px) -> int:
        s, g = self.sig, self.sgn
        hc = min(1, max(-1, int(s[py, px - 1]) * int(g[py, px - 1])
                        + int(s[py, px + 1]) * int(g[py, px + 1])))
        vc = min(1, max(-1, int(s[py - 1, px]) * int(g[py - 1, px])
                        + int(s[py + 1, px]) * int(g[py + 1, px])))
        ctx, xorbit = _SC_LUT[(hc, vc)]
        return 1 if (self.mq.decode(ctx) ^ xorbit) else 0  # 1 = negative

    def _become_significant(self, y, x, negative: int):
        py, px = y + 1, x + 1
        self.sig[py, px] = 1
        self.sgn[py, px] = -1 if negative else 1
        self.mag[y, x] = self.weight  # MSB of this sample is this plane

    def sig_prop_pass(self):
        w, h, mq = self.w, self.h, self.mq
        for y0 in range(0, h, 4):
            for x in range(w):
                px = x + 1
                for y in range(y0, min(y0 + 4, h)):
                    py = y + 1
                    if self.sig[py, px]:
                        continue
                    hh, vv, dd = self._hvd(py, px)
                    if hh + vv + dd == 0:
                        continue
                    self.visited[py, px] = 1
                    if mq.decode(_zc_context(hh, vv, dd, self.band)):
                        neg = self._decode_sign(py, px)
                        self._become_significant(y, x, neg)

    def mag_ref_pass(self):
        w, h, mq = self.w, self.h, self.mq
        for y0 in range(0, h, 4):
            for x in range(w):
                px = x + 1
                for y in range(y0, min(y0 + 4, h)):
                    py = y + 1
                    if not self.sig[py, px] or self.visited[py, px]:
                        continue
                    if self.refined[y, x]:
                        ctx = 16
                    else:
                        hh, vv, dd = self._hvd(py, px)
                        ctx = 15 if hh + vv + dd else 14
                    if mq.decode(ctx):
                        self.mag[y, x] += self.weight
                    self.refined[y, x] = True

    def cleanup_pass(self):
        w, h, mq = self.w, self.h, self.mq
        for y0 in range(0, h, 4):
            full = y0 + 4 <= h
            for x in range(w):
                px = x + 1
                y = y0
                if full:
                    # run-length mode: all 4 rows insignificant, unvisited,
                    # and no significant neighbors anywhere in the column
                    rl = True
                    for yy in range(y0, y0 + 4):
                        pyy = yy + 1
                        if self.sig[pyy, px] or self.visited[pyy, px]:
                            rl = False
                            break
                        hh, vv, dd = self._hvd(pyy, px)
                        if hh + vv + dd:
                            rl = False
                            break
                    if rl:
                        if not mq.decode(CTX_RL):
                            # clear visited flags handled at pass end
                            continue
                        r = (mq.decode(CTX_UNI) << 1) | mq.decode(CTX_UNI)
                        y = y0 + r
                        py = y + 1
                        neg = self._decode_sign(py, px)
                        self._become_significant(y, x, neg)
                        y += 1
                for yy in range(y, min(y0 + 4, h)):
                    pyy = yy + 1
                    if self.sig[pyy, px] or self.visited[pyy, px]:
                        continue
                    hh, vv, dd = self._hvd(pyy, px)
                    if mq.decode(_zc_context(hh, vv, dd, self.band)):
                        neg = self._decode_sign(pyy, px)
                        self._become_significant(yy, x, neg)
        self.visited[:] = 0

    def run(self, total_passes: int):
        """Run ``total_passes`` passes: CUP(plane 0), then
        (SPP, MRP, CUP) per subsequent bitplane.

        Magnitudes accumulate as ``weight`` = 2^(remaining planes): plane
        k of n carries 2^(n-1-k), so a fully decoded (lossless) block ends
        with weight 1 and exact integer magnitudes.
        """
        nplanes = 1 if total_passes <= 1 else 2 + (total_passes - 2) // 3
        for p in range(total_passes):
            if p == 0:
                plane, kind = 0, 2
            else:
                plane, kind = 1 + (p - 1) // 3, (p - 1) % 3
            self.weight = 1 << (nplanes - 1 - plane)
            if kind == 0:
                self.sig_prop_pass()
            elif kind == 1:
                self.mag_ref_pass()
            else:
                self.cleanup_pass()
        signs = self.sgn[1:-1, 1:-1].astype(np.int64)
        return signs * self.mag


# ----------------------------------------------------------------------
# Codestream structures
# ----------------------------------------------------------------------
class _Cod:
    __slots__ = ("prog", "layers", "mct", "levels", "cbw", "cbh", "cbstyle",
                 "transform", "precincts", "sop", "eph")


class _CbState:
    __slots__ = ("included", "zbp", "lblock", "passes", "segments")

    def __init__(self):
        self.included = False
        self.zbp = 0
        self.lblock = 3
        self.passes = 0
        self.segments: List[bytes] = []


def _parse_cod(body: bytes) -> _Cod:
    cod = _Cod()
    scod = body[0]
    cod.sop = bool(scod & 2)
    cod.eph = bool(scod & 4)
    cod.prog = body[1]
    cod.layers = struct.unpack(">H", body[2:4])[0]
    cod.mct = body[4]
    cod.levels = body[5]
    cod.cbw = 1 << ((body[6] & 0xF) + 2)
    cod.cbh = 1 << ((body[7] & 0xF) + 2)
    cod.cbstyle = body[8]
    cod.transform = body[9]
    cod.precincts = None
    if scod & 1:
        cod.precincts = [(b & 0xF, b >> 4) for b in body[10:10 + cod.levels + 1]]
    return cod


def j2k_decode(data: bytes) -> np.ndarray:
    """Decode a raw JPEG 2000 codestream (lossless 5/3 profile).

    Returns (H, W) for one component or (H, W, C). Raises
    :class:`Unsupported` for out-of-scope features (9/7 transform,
    quantized subbands, selective MQ bypass, ...).
    """
    if data[:2] != b"\xff\x4f":
        # Accept a JP2 container by locating the contiguous codestream box.
        i = data.find(b"\xff\x4f\xff\x51")
        if i < 0:
            raise ValueError("not a JPEG 2000 codestream")
        data = data[i:]

    pos = 2
    siz = None
    cod: Optional[_Cod] = None
    qcd_exp: Optional[List[int]] = None
    tiles: Dict[int, List[bytes]] = {}
    tile_cod: Dict[int, _Cod] = {}

    while pos < len(data):
        marker = struct.unpack(">H", data[pos:pos + 2])[0]
        pos += 2
        if marker == 0xFFD9:  # EOC
            break
        if marker == 0xFF93:  # SOD — only reachable via SOT handling below
            raise ValueError("unexpected SOD")
        ln = struct.unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + ln]
        if marker == 0xFF51:  # SIZ
            (rsiz, xs, ys, xo, yo, xts, yts, xto, yto, ncomp) = struct.unpack(
                ">HIIIIIIIIH", body[:36]
            )
            comps = []
            for c in range(ncomp):
                ssiz, xr, yr = body[36 + 3 * c:39 + 3 * c]
                comps.append((1 + (ssiz & 0x7F), bool(ssiz & 0x80), xr, yr))
            if any(xr != 1 or yr != 1 for _, _, xr, yr in comps):
                raise Unsupported("subsampled components")
            siz = dict(xs=xs, ys=ys, xo=xo, yo=yo, xts=xts, yts=yts,
                       xto=xto, yto=yto, comps=comps)
        elif marker == 0xFF52:  # COD
            cod = _parse_cod(body)
        elif marker == 0xFF5C:  # QCD
            style = body[0] & 0x1F
            if style != 0:
                raise Unsupported("quantized subbands (lossy codestream)")
            qcd_exp = [b >> 3 for b in body[1:]]
        elif marker == 0xFF90:  # SOT
            isot, psot, tpsot, tnsot = struct.unpack(">HIBB", body[:8])
            # tile-part data runs from after SOD to start+psot
            tp_start = pos - 2  # at SOT marker
            tp_end = tp_start + psot if psot else len(data)
            # scan tile-part headers for overrides until SOD
            q = pos + ln
            while True:
                m2 = struct.unpack(">H", data[q:q + 2])[0]
                if m2 == 0xFF93:
                    q += 2
                    break
                l2 = struct.unpack(">H", data[q + 2:q + 4])[0]
                if m2 == 0xFF52:
                    tile_cod[isot] = _parse_cod(data[q + 4:q + 2 + l2])
                q += 2 + l2
            tiles.setdefault(isot, []).append(data[q:tp_end])
            pos = tp_end
            continue
        pos += ln

    if siz is None or cod is None or qcd_exp is None:
        raise ValueError("missing SIZ/COD/QCD")
    if cod.transform != 1:
        raise Unsupported("9/7 irreversible transform (lossy)")
    if cod.cbstyle & 0x3F & ~0x08:
        # bits: 1=bypass 2=reset 4=termall 8=vcausal 16=predictable 32=segsym
        raise Unsupported(f"code-block style 0x{cod.cbstyle:02x}")
    if cod.cbstyle & 0x08:
        raise Unsupported("vertically causal contexts")

    ncomp = len(siz["comps"])
    H = siz["ys"] - siz["yo"]
    W = siz["xs"] - siz["xo"]
    out = np.zeros((H, W, ncomp), np.int64)

    ntx = -(-(siz["xs"] - siz["xto"]) // siz["xts"])
    nty = -(-(siz["ys"] - siz["yto"]) // siz["yts"])
    for t in range(ntx * nty):
        if t not in tiles:
            continue
        tcod = tile_cod.get(t, cod)
        tdata = b"".join(tiles[t])
        tx, ty = t % ntx, t // ntx
        tx0 = max(siz["xto"] + tx * siz["xts"], siz["xo"])
        ty0 = max(siz["yto"] + ty * siz["yts"], siz["yo"])
        tx1 = min(siz["xto"] + (tx + 1) * siz["xts"], siz["xs"])
        ty1 = min(siz["yto"] + (ty + 1) * siz["yts"], siz["ys"])
        comps_out = _decode_tile(tdata, tcod, ncomp, (tx0, ty0, tx1, ty1))
        if tcod.mct == 1:
            if ncomp < 3:
                raise ValueError("MCT with < 3 components")
            # Inverse RCT (reversible)
            y0_, cb, cr = (comps_out[i].astype(np.int64) for i in range(3))
            g = y0_ - ((cb + cr) >> 2)
            r = cr + g
            b = cb + g
            comps_out[0], comps_out[1], comps_out[2] = r, g, b
        for c in range(ncomp):
            out[ty0 - siz["yo"]:ty1 - siz["yo"],
                tx0 - siz["xo"]:tx1 - siz["xo"], c] = comps_out[c]

    # DC level shift for unsigned components
    arrs = []
    for c, (depth, signed, _, _) in enumerate(siz["comps"]):
        a = out[..., c]
        if not signed:
            a = a + (1 << (depth - 1))
        if depth <= 8:
            a = a.astype(np.int16 if signed else np.uint8)
        else:
            a = a.astype(np.int32 if signed else np.uint16)
        arrs.append(a)
    res = np.stack(arrs, axis=-1)
    return res[..., 0] if ncomp == 1 else res


def _band_rect(tcx0, tcy0, tcx1, tcy1, lev, band):
    """Subband coordinates (T.800 B.5): band b at decomposition level lev."""
    xob = 1 if band in ("HL", "HH") else 0
    yob = 1 if band in ("LH", "HH") else 0
    d = 1 << lev
    bx0 = -(-(tcx0 - (1 << (lev - 1)) * xob) // d) if lev else tcx0
    by0 = -(-(tcy0 - (1 << (lev - 1)) * yob) // d) if lev else tcy0
    bx1 = -(-(tcx1 - (1 << (lev - 1)) * xob) // d) if lev else tcx1
    by1 = -(-(tcy1 - (1 << (lev - 1)) * yob) // d) if lev else tcy1
    return bx0, by0, bx1, by1


def _decode_tile(tdata: bytes, cod: _Cod, ncomp, rect):
    tx0, ty0, tx1, ty1 = rect
    levels = cod.levels

    # Subband layout per component. Bands in decode order per resolution:
    # res 0 -> [NL-LL]; res r>0 -> [HL, LH, HH] at decomposition level NL-r+1.
    band_list: List[List[Tuple[str, int, Tuple[int, int, int, int]]]] = []
    for r in range(levels + 1):
        bands = []
        if r == 0:
            lev = levels
            bands.append(("LL", lev, _band_rect(tx0, ty0, tx1, ty1, lev, "LL")))
        else:
            lev = levels - r + 1
            for b in ("HL", "LH", "HH"):
                bands.append((b, lev, _band_rect(tx0, ty0, tx1, ty1, lev, b)))
        band_list.append(bands)

    # (Reversible lossless decode never consults the QCD exponents: the
    # zero-bitplane tag trees position magnitudes and all passes decode,
    # so reconstruction is exact integers regardless of Mb.)

    # Code-block grids + tier-2 state, per component/resolution/band.
    cb_grid = {}
    incl_trees = {}
    zbp_trees = {}
    cb_state = {}
    coeffs = {}
    for c in range(ncomp):
        for r, bands in enumerate(band_list):
            for bi, (band, lev, (bx0, by0, bx1, by1)) in enumerate(bands):
                bw, bh = bx1 - bx0, by1 - by0
                cbw, cbh = cod.cbw, cod.cbh
                if r > 0:
                    # precinct partition halves the max code-block size at
                    # the default PPx=PPy=15 this stays cbw/cbh
                    pass
                if bw <= 0 or bh <= 0:
                    ncbx = ncby = 0
                else:
                    ncbx = (bx1 + cbw - 1) // cbw - bx0 // cbw
                    ncby = (by1 + cbh - 1) // cbh - by0 // cbh
                key = (c, r, bi)
                cb_grid[key] = (bx0, by0, bx1, by1, ncbx, ncby)
                if ncbx and ncby:
                    incl_trees[key] = _TagTree(ncbx, ncby)
                    zbp_trees[key] = _TagTree(ncbx, ncby)
                cb_state[key] = [[_CbState() for _ in range(ncbx)] for _ in range(ncby)]
                coeffs[key] = np.zeros((max(bh, 0), max(bw, 0)), np.int64)

    if cod.precincts is not None:
        for ppx, ppy in cod.precincts:
            if ppx < 15 or ppy < 15:
                raise Unsupported("custom precinct partitions")

    # --- Tier-2: walk packets. With one precinct per resolution, every
    # progression order visits each (layer, res, comp) exactly once; order
    # across layers/res/comp follows the COD progression.
    pos = 0

    def read_packet(c, r, layer):
        nonlocal pos
        if cod.sop:
            if tdata[pos:pos + 2] == b"\xff\x91":
                pos += 6
        br = _BitReader(tdata, pos)
        if not br.bit():  # empty packet
            br.align()
            pos = br.pos
            if cod.eph and tdata[pos:pos + 2] == b"\xff\x92":
                pos += 2
            return
        sched = []  # (key, cy, cx, newpasses, nbytes)
        for bi in range(len(band_list[r])):
            key = (c, r, bi)
            bx0, by0, bx1, by1, ncbx, ncby = cb_grid[key]
            if not (ncbx and ncby):
                continue
            for cy in range(ncby):
                for cx in range(ncbx):
                    st = cb_state[key][cy][cx]
                    if not st.included:
                        inc = incl_trees[key].decode(br, cx, cy, layer + 1)
                    else:
                        inc = bool(br.bit())
                    if not inc:
                        continue
                    if not st.included:
                        st.zbp = zbp_trees[key].get(br, cx, cy)
                        st.included = True
                    # number of new passes
                    if not br.bit():
                        np_ = 1
                    elif not br.bit():
                        np_ = 2
                    else:
                        v = br.bits(2)
                        if v < 3:
                            np_ = 3 + v
                        else:
                            v = br.bits(5)
                            if v < 31:
                                np_ = 6 + v
                            else:
                                np_ = 37 + br.bits(7)
                    while br.bit():
                        st.lblock += 1
                    nbits = st.lblock + int(math.floor(math.log2(np_)))
                    nbytes = br.bits(nbits)
                    sched.append((key, cy, cx, np_, nbytes))
        br.align()
        pos = br.pos
        if cod.eph:
            if tdata[pos:pos + 2] == b"\xff\x92":
                pos += 2
        for key, cy, cx, np_, nbytes in sched:
            st = cb_state[key][cy][cx]
            st.segments.append(tdata[pos:pos + nbytes])
            st.passes += np_
            pos += nbytes

    # packet iteration; orders collapse with single precinct per res
    if cod.prog in (0, 1):  # LRCP / RLCP
        outer = range(cod.layers)
        for layer in outer:
            for r in range(levels + 1):
                for c in range(ncomp):
                    read_packet(c, r, layer)
    elif cod.prog in (2,):  # RPCL
        for r in range(levels + 1):
            for c in range(ncomp):
                for layer in range(cod.layers):
                    read_packet(c, r, layer)
    elif cod.prog == 4:  # CPRL
        for c in range(ncomp):
            for r in range(levels + 1):
                for layer in range(cod.layers):
                    read_packet(c, r, layer)
    else:
        raise Unsupported(f"progression order {cod.prog}")

    # --- Tier-1: decode every included code-block.
    for key, grid in cb_grid.items():
        c, r, bi = key
        band, lev, _ = band_list[r][bi]
        bx0, by0, bx1, by1, ncbx, ncby = grid
        cbw, cbh = cod.cbw, cod.cbh
        for cy in range(ncby):
            for cx in range(ncbx):
                st = cb_state[key][cy][cx]
                if not st.included or st.passes == 0:
                    continue
                gx0 = (bx0 // cbw + cx) * cbw
                gy0 = (by0 // cbh + cy) * cbh
                x0, x1 = max(gx0, bx0), min(gx0 + cbw, bx1)
                y0, y1 = max(gy0, by0), min(gy0 + cbh, by1)
                dec = _BlockDecoder(x1 - x0, y1 - y0, band, b"".join(st.segments))
                vals = dec.run(st.passes)
                coeffs[key][y0 - by0:y1 - by0, x0 - bx0:x1 - bx0] = vals

    # --- Inverse 5/3 DWT per component.
    comps = []
    for c in range(ncomp):
        ll = coeffs[(c, 0, 0)]
        for r in range(1, levels + 1):
            lev = levels - r + 1
            hl = coeffs[(c, r, 0)]
            lh = coeffs[(c, r, 1)]
            hh = coeffs[(c, r, 2)]
            # resolution rect at this level
            d = 1 << (lev - 1)
            rx0, ry0 = -(-tx0 // d), -(-ty0 // d)
            rx1, ry1 = -(-tx1 // d), -(-ty1 // d)
            ll = _inverse_53_2d(ll, hl, lh, hh, rx0, ry0, rx1, ry1)
        comps.append(ll)
    return comps


def _sr_1d_53(y: np.ndarray, i0: int, i1: int, axis: int) -> np.ndarray:
    """1-D reversible 5/3 synthesis on the interleaved signal ``y`` laid
    out over absolute indices [i0, i1) along ``axis`` (T.800 F.3.8.2,
    1D_SR with the (F-5)/(F-6) lifting steps and (F-4) symmetric
    extension)."""
    n = i1 - i0
    if n == 1:
        # F.3.8.2: single-sample signal — odd-indexed samples halve
        if i0 % 2 == 1:
            return y // 2
        return y
    y = np.moveaxis(y, axis, 0)
    # Extend by 2 on each side with whole-sample symmetric reflection
    # (T.800 F-4): rel index r maps to min(m, 2n-2-m) with m = r mod 2n-2.
    period = 2 * n - 2
    ext = np.empty((n + 4,) + y.shape[1:], np.int64)
    ext[2:n + 2] = y
    for j, rel in ((0, -2), (1, -1), (n + 2, n), (n + 3, n + 1)):
        m = rel % period
        ext[j] = y[min(m, period - m)]

    out = np.empty_like(ext)
    # even absolute indices: x[2k] = y[2k] - floor((y[2k-1]+y[2k+1]+2)/4)
    # odd: x[2k+1] = y[2k+1] + floor((x[2k]+x[2k+2])/2)
    # Work over ext with absolute parity: index of ext[j] is a = i0-2+j.
    a0 = i0 - 2
    parity = (np.arange(a0, a0 + n + 4) % 2)
    even_j = np.nonzero(parity == 0)[0]
    odd_j = np.nonzero(parity == 1)[0]
    # step 1 (even samples) needs odd neighbors from ext
    ej = even_j[(even_j >= 1) & (even_j <= n + 2)]
    out[ej] = ext[ej] - ((ext[ej - 1] + ext[ej + 1] + 2) >> 2)
    # copy edges we won't use
    # step 2 (odd samples) needs even OUT neighbors
    oj = odd_j[(odd_j >= 2) & (odd_j <= n + 1)]
    out[oj] = ext[oj] + ((out[oj - 1] + out[oj + 1]) >> 1)
    res = out[2:n + 2]
    return np.moveaxis(res, 0, axis)


def _inverse_53_2d(ll, hl, lh, hh, rx0, ry0, rx1, ry1) -> np.ndarray:
    """One 2D_SR step (T.800 F.3.2): interleave the four subbands on the
    resolution grid [rx0, rx1) x [ry0, ry1), then 1D synthesis
    horizontally (rows) and vertically (columns)."""
    H, W = ry1 - ry0, rx1 - rx0
    a = np.zeros((H, W), np.int64)
    # sample (y, x) absolute; LL at even/even relative to 0
    ys = np.arange(ry0, ry1)
    xs = np.arange(rx0, rx1)
    ye, yo = (ys % 2 == 0), (ys % 2 == 1)
    xe, xo = (xs % 2 == 0), (xs % 2 == 1)
    a[np.ix_(ye, xe)] = ll
    a[np.ix_(ye, xo)] = hl
    a[np.ix_(yo, xe)] = lh
    a[np.ix_(yo, xo)] = hh
    a = _sr_1d_53(a, rx0, rx1, axis=1)   # horizontal first (F.3.4 HOR_SR)
    a = _sr_1d_53(a, ry0, ry1, axis=0)   # then vertical
    return a


# ======================================================================
# From-scratch LOSSLESS ENCODER (single component, reversible 5/3,
# single tile, one quality layer — the form DICOM syntax .90 uses).
# Validated two ways in tests: our decoder round-trips it bit-exactly,
# and OpenJPEG (when present) decodes it to the identical image.
# ======================================================================

class _MQEncoder:
    """MQ arithmetic encoder (T.88 software conventions, Annex C.2)."""

    __slots__ = ("out", "c", "a", "ct", "b", "idx", "mps", "_started")

    def __init__(self):
        self.idx, self.mps = _init_contexts()
        self.out = bytearray()
        self.c = 0
        self.a = 0x8000
        self.ct = 12
        self.b = -1  # index of the current byte in out (B register)
        self._started = False

    def _byteout(self):
        out = self.out
        if self.b >= 0 and out[self.b] == 0xFF:
            out.append((self.c >> 20) & 0xFF)
            self.b = len(out) - 1
            self.c &= 0xFFFFF
            self.ct = 7
        else:
            if self.c < 0x8000000:
                out.append((self.c >> 19) & 0xFF)
                self.b = len(out) - 1
                self.c &= 0x7FFFF
                self.ct = 8
            else:
                if self.b >= 0:
                    out[self.b] += 1
                    if out[self.b] == 0xFF:
                        self.c &= 0x7FFFFFF
                        out.append((self.c >> 20) & 0xFF)
                        self.b = len(out) - 1
                        self.c &= 0xFFFFF
                        self.ct = 7
                        return
                else:
                    # carry with no byte yet: emit it as 0x01? cannot occur —
                    # the first byteout always goes through the c<0x8000000
                    # branch because c starts at 0.
                    pass
                out.append((self.c >> 19) & 0xFF)
                self.b = len(out) - 1
                self.c &= 0x7FFFF
                self.ct = 8

    def _renorm(self):
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byteout()
            if self.a & 0x8000:
                break

    def encode(self, cx: int, bit: int):
        i = self.idx[cx]
        qe, nmps, nlps, switch = _MQ_TABLE[i]
        if bit == self.mps[cx]:
            self.a -= qe
            if (self.a & 0x8000) == 0:
                if self.a < qe:
                    self.a = qe
                else:
                    self.c += qe
                self.idx[cx] = nmps
                self._renorm()
            else:
                self.c += qe
        else:
            self.a -= qe
            if self.a < qe:
                self.c += qe
            else:
                self.a = qe
            if switch:
                self.mps[cx] = 1 - self.mps[cx]
            self.idx[cx] = nlps
            self._renorm()

    def flush(self) -> bytes:
        # SETBITS
        tempc = self.c + self.a - 1
        self.c |= 0xFFFF
        if self.c >= tempc:
            self.c -= 0x8000
        # two final byteouts
        self.c <<= self.ct
        self._byteout()
        self.c <<= self.ct
        self._byteout()
        out = self.out
        # drop a trailing 0xFF (decoder treats EOD as an endless 0xFF run)
        while out and out[-1] == 0xFF:
            out.pop()
        return bytes(out)


class _BlockEncoder:
    """Tier-1 encoder: exact mirror of :class:`_BlockDecoder`."""

    def __init__(self, vals: np.ndarray, band: str):
        self.h, self.w = vals.shape
        self.band = band
        self.mq = _MQEncoder()
        h, w = self.h, self.w
        self.sig = np.zeros((h + 2, w + 2), np.uint8)
        self.sgn = np.zeros((h + 2, w + 2), np.int8)
        self.visited = np.zeros((h + 2, w + 2), np.uint8)
        self.refined = np.zeros((h, w), bool)
        self.mag = np.abs(vals).astype(np.int64)
        self.neg = vals < 0
        self.nplanes = int(self.mag.max()).bit_length() if self.mag.any() else 0

    _hvd = _BlockDecoder._hvd

    def _encode_sign(self, y, x):
        py, px = y + 1, x + 1
        s, g = self.sig, self.sgn
        hc = min(1, max(-1, int(s[py, px - 1]) * int(g[py, px - 1])
                        + int(s[py, px + 1]) * int(g[py, px + 1])))
        vc = min(1, max(-1, int(s[py - 1, px]) * int(g[py - 1, px])
                        + int(s[py + 1, px]) * int(g[py + 1, px])))
        ctx, xorbit = _SC_LUT[(hc, vc)]
        negative = bool(self.neg[y, x])
        self.mq.encode(ctx, int(negative) ^ xorbit)
        self.sig[py, px] = 1
        self.sgn[py, px] = -1 if negative else 1

    def _bit(self, y, x) -> int:
        return (int(self.mag[y, x]) >> self.plane) & 1

    def _first_sig_here(self, y, x) -> bool:
        """This sample's MSB is at the current plane."""
        return int(self.mag[y, x]).bit_length() - 1 == self.plane and self.mag[y, x] != 0

    def spp(self):
        for y0 in range(0, self.h, 4):
            for x in range(self.w):
                px = x + 1
                for y in range(y0, min(y0 + 4, self.h)):
                    py = y + 1
                    if self.sig[py, px]:
                        continue
                    hh, vv, dd = self._hvd(py, px)
                    if hh + vv + dd == 0:
                        continue
                    self.visited[py, px] = 1
                    bit = self._bit(y, x)
                    self.mq.encode(_zc_context(hh, vv, dd, self.band), bit)
                    if bit:
                        self._encode_sign(y, x)

    def mrp(self):
        for y0 in range(0, self.h, 4):
            for x in range(self.w):
                px = x + 1
                for y in range(y0, min(y0 + 4, self.h)):
                    py = y + 1
                    if not self.sig[py, px] or self.visited[py, px]:
                        continue
                    if self.refined[y, x]:
                        ctx = 16
                    else:
                        hh, vv, dd = self._hvd(py, px)
                        ctx = 15 if hh + vv + dd else 14
                    self.mq.encode(ctx, self._bit(y, x))
                    self.refined[y, x] = True

    def cup(self):
        for y0 in range(0, self.h, 4):
            full = y0 + 4 <= self.h
            for x in range(self.w):
                px = x + 1
                y = y0
                if full:
                    rl = True
                    for yy in range(y0, y0 + 4):
                        pyy = yy + 1
                        if self.sig[pyy, px] or self.visited[pyy, px]:
                            rl = False
                            break
                        hh, vv, dd = self._hvd(pyy, px)
                        if hh + vv + dd:
                            rl = False
                            break
                    if rl:
                        first = -1
                        for r in range(4):
                            if self._bit(y0 + r, x):
                                first = r
                                break
                        if first < 0:
                            self.mq.encode(CTX_RL, 0)
                            continue
                        self.mq.encode(CTX_RL, 1)
                        self.mq.encode(CTX_UNI, (first >> 1) & 1)
                        self.mq.encode(CTX_UNI, first & 1)
                        y = y0 + first
                        self._encode_sign(y, x)
                        y += 1
                for yy in range(y, min(y0 + 4, self.h)):
                    pyy = yy + 1
                    if self.sig[pyy, px] or self.visited[pyy, px]:
                        continue
                    hh, vv, dd = self._hvd(pyy, px)
                    bit = self._bit(yy, x)
                    self.mq.encode(_zc_context(hh, vv, dd, self.band), bit)
                    if bit:
                        self._encode_sign(yy, x)
        self.visited[:] = 0

    def run(self):
        """Encode ALL passes (lossless). Returns (data, total_passes)."""
        n = self.nplanes
        if n == 0:
            return b"", 0
        total = 1 + 3 * (n - 1)
        for p in range(total):
            if p == 0:
                self.plane, kind = n - 1, 2
            else:
                self.plane = n - 1 - (1 + (p - 1) // 3)
                kind = (p - 1) % 3
            if kind == 0:
                self.spp()
            elif kind == 1:
                self.mrp()
            else:
                self.cup()
        return self.mq.flush(), total


class _BitWriter:
    """Packet-header bit writer with 0xFF stuffing (mirror of _BitReader)."""

    def __init__(self):
        self.out = bytearray()
        self.buf = 0
        self.nbits = 0

    def bit(self, b: int):
        # capacity of the CURRENT byte being assembled
        if self.nbits == 0:
            self._width = 7 if (self.out and self.out[-1] == 0xFF) else 8
        self.buf = (self.buf << 1) | (b & 1)
        self.nbits += 1
        if self.nbits == self._width:
            self.out.append(self.buf & 0xFF)
            self.buf = 0
            self.nbits = 0

    def bits(self, v: int, n: int):
        for k in range(n - 1, -1, -1):
            self.bit((v >> k) & 1)

    def flush(self) -> bytes:
        if self.nbits:
            width = self._width
            self.out.append((self.buf << (width - self.nbits)) & 0xFF)
            self.buf = 0
            self.nbits = 0
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)  # stuffed byte is part of the header
        return bytes(self.out)


class _TagTreeEnc:
    def __init__(self, w, h, values):
        """values: (h, w) int leaf values."""
        self.levels = []
        vals = np.asarray(values, np.int64)
        while True:
            self.levels.append(vals)
            if vals.shape[0] <= 1 and vals.shape[1] <= 1:
                break
            hh = (vals.shape[0] + 1) // 2
            ww = (vals.shape[1] + 1) // 2
            nxt = np.full((hh, ww), np.iinfo(np.int64).max)
            for yy in range(vals.shape[0]):
                for xx in range(vals.shape[1]):
                    nxt[yy // 2, xx // 2] = min(nxt[yy // 2, xx // 2], vals[yy, xx])
            vals = nxt
        self.n = len(self.levels)
        self.low = [np.zeros(v.shape, np.int64) for v in self.levels]
        self.emitted = [np.zeros(v.shape, bool) for v in self.levels]

    def encode(self, bw: _BitWriter, x: int, y: int, threshold: int):
        """Emit just enough bits that the decoder's ``decode(x, y,
        threshold)`` resolves (the dual of :meth:`_TagTree.decode`)."""
        low = 0
        for lev in range(self.n - 1, -1, -1):
            xx, yy = x >> lev, y >> lev
            if self.low[lev][yy, xx] < low:
                self.low[lev][yy, xx] = low
            v = int(self.levels[lev][yy, xx])
            while (not self.emitted[lev][yy, xx]) and self.low[lev][yy, xx] < threshold:
                if self.low[lev][yy, xx] < v:
                    bw.bit(0)
                    self.low[lev][yy, xx] += 1
                else:
                    bw.bit(1)
                    self.emitted[lev][yy, xx] = True
            if self.emitted[lev][yy, xx]:
                low = v
            else:
                return  # decoder stops here too (value >= threshold so far)


def _fwd_1d_53(x: np.ndarray, i0: int, i1: int, axis: int) -> np.ndarray:
    """Forward reversible 5/3 over absolute span [i0, i1) along axis
    (dual of :func:`_sr_1d_53`; output stays interleaved in place)."""
    n = i1 - i0
    if n == 1:
        return x * 2 if (i0 % 2 == 1) else x
    x = np.moveaxis(x, axis, 0)
    period = 2 * n - 2
    ext = np.empty((n + 4,) + x.shape[1:], np.int64)
    ext[2:n + 2] = x
    for j, rel in ((0, -2), (1, -1), (n + 2, n), (n + 3, n + 1)):
        m = rel % period
        ext[j] = x[min(m, period - m)]
    a0 = i0 - 2
    y = ext.copy()
    # odd (high-pass) first: y[2k+1] = x[2k+1] - floor((x[2k]+x[2k+2])/2)
    for j in range(1, n + 3):
        if (a0 + j) % 2 == 1:
            y[j] = ext[j] - ((ext[j - 1] + ext[j + 1]) >> 1)
    # even: y[2k] = x[2k] + floor((y[2k-1]+y[2k+1]+2)/4)
    for j in range(2, n + 2):
        if (a0 + j) % 2 == 0:
            y[j] = ext[j] + ((y[j - 1] + y[j + 1] + 2) >> 2)
    res = y[2:n + 2]
    return np.moveaxis(res, 0, axis)


def j2k_encode(img: np.ndarray, levels: Optional[int] = None) -> bytes:
    """Encode one grayscale frame as a LOSSLESS raw JPEG 2000 codestream.

    Single component, single tile, reversible 5/3, one quality layer,
    LRCP, 64x64 code-blocks — the profile DICOM syntax .90 carries.
    ``img``: (H, W) integer array (uint8/uint16/int8/int16; signed sets
    the Ssiz sign bit and skips the DC level shift, ITU-T T.800 B.2).
    """
    img = np.asarray(img)
    if img.ndim != 2:
        raise ValueError("j2k_encode expects one (H, W) grayscale frame")
    if img.dtype in (np.uint8, np.int8):
        depth = 8
    elif img.dtype in (np.uint16, np.int16):
        depth = 16
    else:
        raise ValueError("j2k_encode expects uint8/uint16/int8/int16 input")
    signed = img.dtype.kind == "i"
    H, W = img.shape
    if levels is None:
        levels = 5
        while levels > 0 and (min(H, W) + (1 << levels) - 1) >> levels < 1:
            levels -= 1
        levels = min(levels, max(min(H, W).bit_length() - 1, 0), 5)

    # DC level shift (unsigned only) + forward DWT (vertical then
    # horizontal per level — the dual of the decoder's synthesis order).
    a = img.astype(np.int64) - (0 if signed else 1 << (depth - 1))
    # band coefficient storage keyed like the decoder: (r, bi). The image
    # origin is 0, so every band/resolution origin is 0 and the DWT is a
    # plain shape-driven recursion (dual of the decoder's 2D_SR order:
    # analyze vertically, then horizontally, then deinterleave).
    coeffs: Dict[Tuple[int, int], np.ndarray] = {}
    cur = a
    for r in range(levels, 0, -1):  # r = RESOLUTION index of the detail bands
        h, w = cur.shape
        t = _fwd_1d_53(cur, 0, h, axis=0)
        t = _fwd_1d_53(t, 0, w, axis=1)
        coeffs[(r, 0)] = t[0::2, 1::2]  # HL
        coeffs[(r, 1)] = t[1::2, 0::2]  # LH
        coeffs[(r, 2)] = t[1::2, 1::2]  # HH
        cur = t[0::2, 0::2]             # LL
    coeffs[(0, 0)] = cur

    guard = 2
    gain = {"LL": 0, "HL": 1, "LH": 1, "HH": 2}
    band_names = lambda r: ["LL"] if r == 0 else ["HL", "LH", "HH"]  # noqa: E731

    # QCD exponents (reversible, Table A.30 order)
    exps = []
    exps.append(depth + gain["LL"])
    for r in range(1, levels + 1):
        for b in ("HL", "LH", "HH"):
            exps.append(depth + gain[b])

    cbw = cbh = 64
    # Tier-1 encode every code-block; build per-resolution packets.
    packets = []
    for r in range(levels + 1):
        bw_hdr = _BitWriter()
        body = bytearray()
        names = band_names(r)
        # non-empty packet bit
        bw_hdr.bit(1)
        for bi, bname in enumerate(names):
            vals = coeffs[(r, bi)]
            bh, bwd = vals.shape
            if bh <= 0 or bwd <= 0:
                continue
            ncbx = (bwd + cbw - 1) // cbw
            ncby = (bh + cbh - 1) // cbh
            Mb = exps[0 if r == 0 else 1 + 3 * (r - 1) + bi] + guard - 1
            # encode blocks; collect inclusion/zbp values
            blocks = []
            incl_vals = np.zeros((ncby, ncbx), np.int64)
            zbp_vals = np.zeros((ncby, ncbx), np.int64)
            for cy in range(ncby):
                for cx in range(ncbx):
                    sub = vals[cy * cbh:(cy + 1) * cbh, cx * cbw:(cx + 1) * cbw]
                    enc = _BlockEncoder(sub, bname)
                    data, npasses = enc.run()
                    if npasses == 0:
                        incl_vals[cy, cx] = 1  # "first included in layer 1" = never
                        blocks.append(None)
                        zbp_vals[cy, cx] = 0
                    else:
                        incl_vals[cy, cx] = 0
                        zbp = Mb - enc.nplanes
                        if zbp < 0:
                            raise ValueError(
                                f"coefficient overflow: {enc.nplanes} planes > Mb={Mb}"
                            )
                        zbp_vals[cy, cx] = zbp
                        blocks.append((data, npasses))
            itree = _TagTreeEnc(ncbx, ncby, incl_vals)
            ztree = _TagTreeEnc(ncbx, ncby, zbp_vals)
            for cy in range(ncby):
                for cx in range(ncbx):
                    blk = blocks[cy * ncbx + cx]
                    itree.encode(bw_hdr, cx, cy, 1)
                    if blk is None:
                        continue
                    # zero bitplanes: encode until the leaf value resolves
                    t = 1
                    while True:
                        ztree.encode(bw_hdr, cx, cy, t)
                        if zbp_vals[cy, cx] < t:
                            break
                        t += 1
                    data, npasses = blk
                    # numpasses code
                    if npasses == 1:
                        bw_hdr.bit(0)
                    elif npasses == 2:
                        bw_hdr.bits(0b10, 2)
                    elif npasses <= 5:
                        bw_hdr.bits(0b11, 2)
                        bw_hdr.bits(npasses - 3, 2)
                    elif npasses <= 36:
                        bw_hdr.bits(0b11, 2)
                        bw_hdr.bits(0b11, 2)
                        bw_hdr.bits(npasses - 6, 5)
                    else:
                        bw_hdr.bits(0b11, 2)
                        bw_hdr.bits(0b11, 2)
                        bw_hdr.bits(31, 5)
                        bw_hdr.bits(npasses - 37, 7)
                    # Lblock: need nbits >= bitlen(len(data))
                    lblock = 3
                    floor_log = int(math.floor(math.log2(npasses)))
                    need = max(len(data).bit_length(), 1)
                    add = max(0, need - (lblock + floor_log))
                    for _ in range(add):
                        bw_hdr.bit(1)
                    bw_hdr.bit(0)
                    lblock += add
                    bw_hdr.bits(len(data), lblock + floor_log)
                    body.extend(data)
        packets.append(bytes(bw_hdr.flush()) + bytes(body))

    # ---- assemble codestream
    def m16(v):
        return struct.pack(">H", v)

    def m32(v):
        return struct.pack(">I", v)

    out = bytearray()
    out += b"\xff\x4f"  # SOC
    siz = (m16(0) + m32(W) + m32(H) + m32(0) + m32(0) + m32(W) + m32(H)
           + m32(0) + m32(0) + m16(1)
           + bytes([(depth - 1) | (0x80 if signed else 0), 1, 1]))
    out += b"\xff\x51" + m16(len(siz) + 2) + siz
    # Scod=0; SGcod: prog=LRCP(0), layers=1 (2 bytes), mct=0; SPcod:
    # levels, cb exponents, style=0, transform=1 (reversible 5/3).
    cod = bytes([0, 0]) + m16(1) + bytes([0, levels,
                                          cbw.bit_length() - 3,
                                          cbh.bit_length() - 3, 0, 1])
    out += b"\xff\x52" + m16(len(cod) + 2) + cod
    qcd = bytes([0 | (guard << 5)]) + bytes((e << 3) & 0xFF for e in exps)
    out += b"\xff\x5c" + m16(len(qcd) + 2) + qcd
    tile_body = b"".join(packets)
    sot = m16(0) + m32(12 + 2 + len(tile_body)) + bytes([0, 1])
    out += b"\xff\x90" + m16(len(sot) + 2) + sot
    out += b"\xff\x93" + tile_body
    out += b"\xff\xd9"  # EOC
    return bytes(out)
