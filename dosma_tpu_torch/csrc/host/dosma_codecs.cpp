// Host (CPU) compressed-pixel codecs of dosma_tpu_torch: the port's copy of
// native/dosma_codecs.cpp, built at first use by core/io/_native.py.
//
// The reference reads compressed DICOM transfer syntaxes through pydicom's
// C pixel handlers (dosma/core/io/dicom_io.py:303-314).
// The package's from-scratch Python codecs (core/io/dicom/codecs.py) are
// correct but slow for the bit-serial JPEG-lossless Huffman scan
// (~1.2 s/slice in CPython); these C++ twins decode the same formats at
// native speed and are dispatched via ctypes with a pure-Python fallback.
//
// Semantics mirror core/io/dicom/codecs.py exactly:
//   - RLE Lossless (PS3.5 Annex G): 64-byte header, PackBits segments,
//     MSB-plane-first; output bytes are big-endian samples.
//   - JPEG Lossless (ITU T.81 process 14, SOF3): single component,
//     predictors 1-7, point transform, restart intervals (incl. mid-row),
//     0xFF00 byte unstuffing, 16-bit wraparound arithmetic.
//
// Build: g++ -O3 -fPIC -std=c++17 -pthread -shared, into
// dosma_tpu_torch/_build/ (core/io/_native.py does it at first use).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

extern "C" {

// ---------------------------------------------------------------------------
// PackBits (one RLE segment).
// ---------------------------------------------------------------------------
static long long packbits_decode(const uint8_t *src, long long n, uint8_t *dst,
                                 long long expected) {
  long long si = 0, di = 0;
  while (si < n && di < expected) {
    int8_t h = (int8_t)src[si++];
    if (h >= 0) {
      long long cnt = (long long)h + 1;
      if (si + cnt > n || di + cnt > expected) return -1;
      std::memcpy(dst + di, src + si, (size_t)cnt);
      si += cnt;
      di += cnt;
    } else if (h != -128) {
      long long cnt = 1 - (long long)h;
      if (si >= n || di + cnt > expected) return -1;
      std::memset(dst + di, src[si++], (size_t)cnt);
      di += cnt;
    }
    // h == -128: no-op per spec.
  }
  return di;
}

// Decode one RLE frame. dst receives rows*cols*samples*nbytes bytes laid out
// as big-endian samples (matching numpy dtype ">u<nbytes>"). Returns 0 on
// success; negative error codes otherwise.
int dosma_rle_decode(const uint8_t *src, long long n, uint8_t *dst, int rows,
                     int cols, int samples, int nbytes) {
  if (n < 64) return -1;
  uint32_t header[16];
  std::memcpy(header, src, 64);
  int nseg = (int)header[0];
  if (nseg != samples * nbytes || nseg < 1 || nseg > 15) return -2;

  long long plane_len = (long long)rows * cols;
  long long offsets[16];
  for (int k = 0; k < nseg; ++k) offsets[k] = (long long)header[1 + k];
  offsets[nseg] = n;

  // Temporary plane buffer; interleave into dst as we go.
  std::vector<uint8_t> plane((size_t)plane_len);
  for (int k = 0; k < nseg; ++k) {
    if (offsets[k] < 64 || offsets[k] > n || offsets[k + 1] < offsets[k]) return -3;
    long long got = packbits_decode(src + offsets[k], offsets[k + 1] - offsets[k],
                                    plane.data(), plane_len);
    if (got != plane_len) return -4;
    int s = k / nbytes;  // sample index
    int b = k % nbytes;  // byte plane (0 = MSB)
    long long stride = (long long)samples * nbytes;
    uint8_t *base = dst + (long long)s * nbytes + b;
    for (long long p = 0; p < plane_len; ++p) base[p * stride] = plane[(size_t)p];
  }
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG Lossless (SOF3) decoder.
// ---------------------------------------------------------------------------
namespace {

struct BitReader {
  const uint8_t *data;
  long long n;
  long long pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool error = false;

  BitReader(const uint8_t *d, long long n_, long long p) : data(d), n(n_), pos(p) {}

  inline void fill() {
    if (pos >= n) {
      error = true;
      acc = (acc << 8) | 0xFF;  // 1-padding keeps the decoder terminating
      nbits += 8;
      return;
    }
    uint8_t byte = data[pos++];
    if (byte == 0xFF) {
      uint8_t nxt = pos < n ? data[pos] : 0xD9;
      if (nxt == 0x00) {
        ++pos;  // stuffed byte
      }
      // else: marker — feed 0xFF padding, don't consume the marker.
    }
    acc = (acc << 8) | byte;
    nbits += 8;
  }

  inline uint32_t read(int want) {
    while (nbits < want) fill();
    nbits -= want;
    uint32_t v = (uint32_t)((acc >> nbits) & ((1u << want) - 1));
    acc &= (nbits >= 64) ? ~0ULL : ((1ULL << nbits) - 1);
    return v;
  }
};

// Canonical Huffman decode tables (T.81 F.16): MINCODE/MAXCODE/VALPTR.
struct HuffTable {
  int32_t mincode[17];
  int32_t maxcode[17];  // -1 when no codes of that length
  int valptr[17];
  uint8_t huffval[256];
  bool valid = false;
};

static void build_table(const uint8_t *bits, const uint8_t *values, int nval,
                        HuffTable &t) {
  int code = 0, vi = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      t.valptr[l] = vi;
      t.mincode[l] = code;
      code += bits[l - 1];
      vi += bits[l - 1];
      t.maxcode[l] = code - 1;
    } else {
      t.mincode[l] = 0;
      t.maxcode[l] = -1;
      t.valptr[l] = 0;
    }
    code <<= 1;
  }
  std::memcpy(t.huffval, values, (size_t)(nval < 256 ? nval : 256));
  t.valid = true;
}

static inline int read_symbol(BitReader &br, const HuffTable &t) {
  int code = (int)br.read(1);
  for (int l = 1; l <= 16; ++l) {
    if (t.maxcode[l] >= 0 && code <= t.maxcode[l]) {
      return t.huffval[t.valptr[l] + (code - t.mincode[l])];
    }
    code = (code << 1) | (int)br.read(1);
  }
  return -1;
}

}  // namespace

// Decode a single-component SOF3 stream. out_meta receives
// {rows, cols, precision, point_transform}. dst must hold rows*cols uint16
// (call with dst=null and the function fills out_meta only after parsing
// headers — pass probe=1). Returns 0 ok; negative codes:
//  -1 bad stream  -2 unsupported feature  -3 corrupt entropy data
int dosma_jpeg_lossless_decode(const uint8_t *data, long long n, uint16_t *dst,
                               long long dst_len, int *out_meta, int probe) {
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  long long pos = 2;
  int precision = -1, rows = -1, cols = -1;
  int predictor = 1, point_transform = 0, restart_interval = 0;
  HuffTable tables[4];
  int scan_table_id = -1;

  while (pos + 1 < n) {
    if (data[pos] != 0xFF) return -1;
    uint8_t marker = data[pos + 1];
    pos += 2;
    if (marker == 0xD9) return -1;  // EOI before SOS
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (pos + 2 > n) return -1;
    int seglen = (data[pos] << 8) | data[pos + 1];
    if (pos + seglen > n) return -1;
    const uint8_t *body = data + pos + 2;
    int blen = seglen - 2;
    pos += seglen;

    if (marker == 0xC3) {  // SOF3
      if (blen < 6) return -1;
      precision = body[0];
      rows = (body[1] << 8) | body[2];
      cols = (body[3] << 8) | body[4];
      if (body[5] != 1) return -2;  // components
    } else if (marker == 0xC0 || marker == 0xC1 || marker == 0xC2 ||
               (marker >= 0xC5 && marker <= 0xC7) ||
               (marker >= 0xC9 && marker <= 0xCB) ||
               (marker >= 0xCD && marker <= 0xCF)) {
      return -2;  // non-lossless process
    } else if (marker == 0xC4) {  // DHT
      int bpos = 0;
      while (bpos + 17 <= blen) {
        int tc_th = body[bpos];
        const uint8_t *bits = body + bpos + 1;
        int nval = 0;
        for (int i = 0; i < 16; ++i) nval += bits[i];
        if (nval > 256) return -1;  // huffval overflow (corrupt DHT)
        if (bpos + 17 + nval > blen) return -1;
        build_table(bits, body + bpos + 17, nval, tables[tc_th & 0x03]);
        bpos += 17 + nval;
      }
    } else if (marker == 0xDD) {  // DRI
      if (blen < 2) return -1;
      restart_interval = (body[0] << 8) | body[1];
    } else if (marker == 0xDA) {  // SOS
      if (blen < 4) return -1;
      int ns = body[0];
      if (ns != 1) return -2;
      scan_table_id = body[2] >> 4;
      predictor = body[1 + 2 * ns];
      point_transform = body[3 + 2 * ns] & 0x0F;
      break;
    }
  }

  if (precision < 2 || rows < 0 || scan_table_id < 0 ||
      !tables[scan_table_id & 0x03].valid)
    return -1;
  if (out_meta) {
    out_meta[0] = rows;
    out_meta[1] = cols;
    out_meta[2] = precision;
    out_meta[3] = point_transform;
  }
  if (probe) return 0;
  if (!dst || dst_len < (long long)rows * cols) return -1;
  if (predictor < 1 || predictor > 7) return -2;

  const HuffTable &tab = tables[scan_table_id & 0x03];
  BitReader br(data, n, pos);
  int x0 = 1 << (precision - point_transform - 1);
  long long until_restart = restart_interval ? restart_interval : -1;
  bool first_line = true;

  for (int r = 0; r < rows; ++r) {
    uint16_t *row = dst + (long long)r * cols;
    const uint16_t *above = first_line ? nullptr : row - cols;
    int fresh_col = -1;
    for (int c = 0; c < cols; ++c) {
      if (until_restart == 0) {
        // Reset as at scan start (T.81 H.2.8): next sample predicts from
        // the default, rest of its line predicts 1-D.
        fresh_col = c;
        br.nbits = 0;
        br.acc = 0;
        if (br.pos + 1 < n && br.data[br.pos] == 0xFF &&
            br.data[br.pos + 1] >= 0xD0 && br.data[br.pos + 1] <= 0xD7) {
          br.pos += 2;
        } else if (br.pos > 0 && br.pos < n && br.data[br.pos] >= 0xD0 &&
                   br.data[br.pos] <= 0xD7 && br.data[br.pos - 1] == 0xFF) {
          // fill() already consumed the 0xFF while feeding padding.
          br.pos += 1;
        }
        above = nullptr;
        first_line = true;
        until_restart = restart_interval;
      }
      int ssss = read_symbol(br, tab);
      if (ssss < 0) return -3;
      int32_t diff;
      if (ssss == 16) {
        diff = 32768;
      } else if (ssss == 0) {
        diff = 0;
      } else {
        uint32_t v = br.read(ssss);
        diff = (v >= (1u << (ssss - 1))) ? (int32_t)v
                                         : (int32_t)v - (1 << ssss) + 1;
      }
      int32_t px;
      if (c == fresh_col) {
        px = x0;
      } else if (above == nullptr) {
        px = c > 0 ? (int32_t)row[c - 1] : x0;
      } else if (c == 0) {
        px = (int32_t)above[0];
      } else {
        int32_t ra = row[c - 1], rb = above[c], rc = above[c - 1];
        switch (predictor) {
          case 1: px = ra; break;
          case 2: px = rb; break;
          case 3: px = rc; break;
          case 4: px = ra + rb - rc; break;
          case 5: px = ra + ((rb - rc) >> 1); break;
          case 6: px = rb + ((ra - rc) >> 1); break;
          default: px = (ra + rb) >> 1; break;  // 7
        }
      }
      row[c] = (uint16_t)((px + diff) & 0xFFFF);
      if (until_restart > 0) --until_restart;
    }
    // Rows after the first of a (restart) interval predict from above.
    if (first_line) first_line = false;
    if (br.error) return -3;
  }

  if (point_transform) {
    long long total = (long long)rows * cols;
    for (long long i = 0; i < total; ++i)
      dst[i] = (uint16_t)(dst[i] << point_transform);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG Baseline/Extended (SOF0/SOF1) decoder — single component.
// Mirrors core/io/dicom/jpeg_baseline.py: grayscale 8/12-bit, restart
// intervals; multi-component (color) streams return -2 so the ctypes
// bridge falls back to the Python decoder.
// ---------------------------------------------------------------------------
namespace {

// Orthonormal DCT-II basis A[u][x] = alpha(u) cos((2x+1) u pi / 16) —
// JPEG's 1/4 C(u)C(v) normalization IS the orthonormal scaling.
struct DctBasis {
  double A[8][8];
  DctBasis() {
    const double pi = 3.14159265358979323846;
    for (int u = 0; u < 8; ++u)
      for (int x = 0; x < 8; ++x)
        A[u][x] = (u == 0 ? 0.35355339059327373 : 0.5) *
                  __builtin_cos((2 * x + 1) * u * pi / 16.0);
  }
};
static const DctBasis kDct;

static const uint8_t kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

static void idct8x8(const int32_t *coef, const int32_t *quant, int shift,
                    int maxval, int32_t *out) {
  double F[8][8], T[8][8];
  for (int i = 0; i < 64; ++i)
    F[i >> 3][i & 7] = (double)coef[i] * quant[i];
  // T = A^T * F  (T[x][v] = sum_u A[u][x] F[u][v])
  for (int x = 0; x < 8; ++x)
    for (int v = 0; v < 8; ++v) {
      double s = 0;
      for (int u = 0; u < 8; ++u) s += kDct.A[u][x] * F[u][v];
      T[x][v] = s;
    }
  // out = T * A  (out[x][y] = sum_v T[x][v] A[v][y])
  for (int x = 0; x < 8; ++x)
    for (int y = 0; y < 8; ++y) {
      double s = 0;
      for (int v = 0; v < 8; ++v) s += T[x][v] * kDct.A[v][y];
      // nearbyint (default FE_TONEAREST = half-to-even) matches numpy's
      // np.round rounding MODE. NOTE: exact-.5 IDCT outputs (flat blocks
      // at some qualities) can still differ by 1 gray level from the
      // Python twin — numpy's einsum accumulates in a different order, so
      // the tie value itself may differ in the last ULP. The documented
      // codec contract is therefore ±1 on rounding ties (standard across
      // independent JPEG IDCT implementations).
      long long px = (long long)__builtin_nearbyint(s + shift);
      if (px < 0) px = 0;
      if (px > maxval) px = maxval;
      out[x * 8 + y] = (int32_t)px;
    }
}

}  // namespace

// Decode a single-component SOF0/SOF1 stream. out_meta receives
// {rows, cols, precision, 0}. Returns 0 ok; negative codes as lossless:
//  -1 bad stream  -2 unsupported feature (e.g. color)  -3 corrupt entropy
int dosma_jpeg_baseline_decode(const uint8_t *data, long long n, uint16_t *dst,
                               long long dst_len, int *out_meta, int probe) {
  if (n < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  long long pos = 2;
  int precision = -1, rows = -1, cols = -1, restart_interval = 0;
  int dc_id = -1, ac_id = -1;
  HuffTable dc_tables[4], ac_tables[4];
  int32_t quant[4][64];
  bool quant_valid[4] = {false, false, false, false};
  int comp_tq = 0;

  while (pos + 1 < n) {
    if (data[pos] != 0xFF) return -1;
    uint8_t marker = data[pos + 1];
    pos += 2;
    if (marker == 0xD9) return -1;
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (pos + 2 > n) return -1;
    int seglen = (data[pos] << 8) | data[pos + 1];
    if (pos + seglen > n) return -1;
    const uint8_t *body = data + pos + 2;
    int blen = seglen - 2;
    pos += seglen;

    if (marker == 0xC0 || marker == 0xC1) {  // SOF0/SOF1
      if (blen < 9) return -1;
      precision = body[0];
      rows = (body[1] << 8) | body[2];
      cols = (body[3] << 8) | body[4];
      if (body[5] != 1) return -2;  // color → Python path
      if ((body[7] >> 4) != 1 || (body[7] & 0x0F) != 1) return -2;
      comp_tq = body[8] & 0x03;
    } else if (marker == 0xC2 || marker == 0xC3 ||
               (marker >= 0xC5 && marker <= 0xC7) ||
               (marker >= 0xC9 && marker <= 0xCB) ||
               (marker >= 0xCD && marker <= 0xCF)) {
      return -2;  // progressive / lossless / arithmetic
    } else if (marker == 0xDB) {  // DQT
      int bpos = 0;
      while (bpos < blen) {
        int pq = body[bpos] >> 4, tq = body[bpos] & 0x03;
        int nbytes = 64 * (pq ? 2 : 1);
        if (bpos + 1 + nbytes > blen) return -1;
        for (int i = 0; i < 64; ++i) {
          int v = pq ? ((body[bpos + 1 + 2 * i] << 8) | body[bpos + 2 + 2 * i])
                     : body[bpos + 1 + i];
          quant[tq][kZigzag[i]] = v;
        }
        quant_valid[tq] = true;
        bpos += 1 + nbytes;
      }
    } else if (marker == 0xC4) {  // DHT
      int bpos = 0;
      while (bpos + 17 <= blen) {
        int tc_th = body[bpos];
        const uint8_t *bits = body + bpos + 1;
        int nval = 0;
        for (int i = 0; i < 16; ++i) nval += bits[i];
        if (nval > 256 || bpos + 17 + nval > blen) return -1;
        build_table(bits, body + bpos + 17, nval,
                    ((tc_th >> 4) ? ac_tables : dc_tables)[tc_th & 0x03]);
        bpos += 17 + nval;
      }
    } else if (marker == 0xDD) {  // DRI
      if (blen < 2) return -1;
      restart_interval = (body[0] << 8) | body[1];
    } else if (marker == 0xDA) {  // SOS
      if (blen < 4) return -1;
      if (body[0] != 1) return -2;
      dc_id = body[2] >> 4;
      ac_id = body[2] & 0x0F;
      break;
    }
  }

  if (precision != 8 && precision != 12) return -2;
  if (rows < 0 || dc_id < 0 || !quant_valid[comp_tq]) return -1;
  if (!dc_tables[dc_id & 3].valid || !ac_tables[ac_id & 3].valid) return -1;
  if (out_meta) {
    out_meta[0] = rows;
    out_meta[1] = cols;
    out_meta[2] = precision;
    out_meta[3] = 0;
  }
  if (probe) return 0;
  if (!dst || dst_len < (long long)rows * cols) return -1;

  const HuffTable &dct_ = dc_tables[dc_id & 3];
  const HuffTable &act = ac_tables[ac_id & 3];
  const int32_t *q = quant[comp_tq];
  BitReader br(data, n, pos);
  int shift = 1 << (precision - 1);
  int maxval = (1 << precision) - 1;
  int bx = (cols + 7) / 8, by = (rows + 7) / 8;
  long long until_restart = restart_interval ? restart_interval : -1;
  int32_t pred = 0;

  for (int mb = 0; mb < by; ++mb) {
    for (int nb = 0; nb < bx; ++nb) {
      if (until_restart == 0) {
        br.nbits = 0;
        br.acc = 0;
        if (br.pos + 1 < n && br.data[br.pos] == 0xFF &&
            br.data[br.pos + 1] >= 0xD0 && br.data[br.pos + 1] <= 0xD7) {
          br.pos += 2;
        } else if (br.pos > 0 && br.pos < n && br.data[br.pos] >= 0xD0 &&
                   br.data[br.pos] <= 0xD7 && br.data[br.pos - 1] == 0xFF) {
          br.pos += 1;
        }
        pred = 0;
        until_restart = restart_interval;
      }
      int32_t coef[64];
      std::memset(coef, 0, sizeof(coef));
      int ssss = read_symbol(br, dct_);
      if (ssss < 0 || ssss > 15) return -3;
      int32_t diff = 0;
      if (ssss) {
        uint32_t v = br.read(ssss);
        diff = (v >= (1u << (ssss - 1))) ? (int32_t)v
                                         : (int32_t)v - (1 << ssss) + 1;
      }
      pred += diff;
      coef[0] = pred;
      int k = 1;
      while (k < 64) {
        int rs = read_symbol(br, act);
        if (rs < 0) return -3;
        int r = rs >> 4, s2 = rs & 0x0F;
        if (s2 == 0) {
          if (r == 15) {
            k += 16;
            continue;
          }
          break;  // EOB
        }
        k += r;
        if (k > 63) return -3;
        uint32_t v = br.read(s2);
        coef[kZigzag[k]] = (v >= (1u << (s2 - 1))) ? (int32_t)v
                                                   : (int32_t)v - (1 << s2) + 1;
        ++k;
      }
      if (br.error) return -3;

      int32_t pix[64];
      idct8x8(coef, q, shift, maxval, pix);
      int r0 = mb * 8, c0 = nb * 8;
      int rmax = rows - r0 < 8 ? rows - r0 : 8;
      int cmax = cols - c0 < 8 ? cols - c0 : 8;
      for (int r = 0; r < rmax; ++r)
        for (int c = 0; c < cmax; ++c)
          dst[(long long)(r0 + r) * cols + (c0 + c)] = (uint16_t)pix[r * 8 + c];
      if (until_restart > 0) --until_restart;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// JPEG-LS (ITU-T T.87, LOCO-I) — single component, byte-identical twin of
// core/io/dicom/jpeg_ls.py (which documents the spec mapping).
// ---------------------------------------------------------------------------
namespace jls {

static const int J[32] = {0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                          4, 4, 5, 5, 6, 6, 7, 7, 8, 9, 10, 11, 12, 13, 14, 15};

struct State {
  int maxval, near, reset, range, qbpp, limit;
  int64_t A[367], B[367], C[367], N[367], Nn[2];
  int run_index;

  void init(int maxval_, int near_, int reset_) {
    maxval = maxval_;
    near = near_;
    reset = reset_;
    range = (maxval + 2 * near) / (2 * near + 1) + 1;
    qbpp = 0;
    while ((1 << qbpp) < range) ++qbpp;
    int bpp = 2;
    while ((1 << bpp) < maxval + 1) ++bpp;
    if (bpp < 2) bpp = 2;
    limit = 2 * (bpp + (bpp > 8 ? bpp : 8));
    int64_t init_a = (range + 32) / 64;
    if (init_a < 2) init_a = 2;
    for (int i = 0; i < 367; ++i) {
      A[i] = init_a;
      B[i] = 0;
      C[i] = 0;
      N[i] = 1;
    }
    Nn[0] = Nn[1] = 0;
    run_index = 0;
  }

  int golomb_k(int q) const {
    int k = 0;
    while ((N[q] << k) < A[q]) ++k;
    return k;
  }

  int64_t map_error(int64_t e, int k, int q) const {
    if (near == 0 && k == 0 && 2 * B[q] <= -N[q])
      return e >= 0 ? 2 * e + 1 : -2 * (e + 1);
    return e >= 0 ? 2 * e : -2 * e - 1;
  }

  int64_t unmap_error(int64_t m, int k, int q) const {
    if (near == 0 && k == 0 && 2 * B[q] <= -N[q])
      return (m % 2) ? (m - 1) / 2 : -(m / 2) - 1;
    return (m % 2) ? -((m + 1) / 2) : m / 2;
  }

  void update(int q, int64_t e) {
    B[q] += e * (2 * near + 1);
    A[q] += e < 0 ? -e : e;
    if (N[q] == reset) {
      A[q] >>= 1;
      B[q] = B[q] >= 0 ? (B[q] >> 1) : -((1 - B[q]) >> 1);
      N[q] >>= 1;
    }
    N[q] += 1;
    if (B[q] <= -N[q]) {
      if (C[q] > -128) C[q] -= 1;
      B[q] += N[q];
      if (B[q] <= -N[q]) B[q] = -N[q] + 1;
    } else if (B[q] > 0) {
      if (C[q] < 127) C[q] += 1;
      B[q] -= N[q];
      if (B[q] > 0) B[q] = 0;
    }
  }

  int ri_k(int ritype) const {
    int q = 365 + ritype;
    int64_t temp = A[q] + (ritype ? (N[q] >> 1) : 0);
    int k = 0;
    while ((N[q] << k) < temp) ++k;
    return k;
  }

  int ri_map(int64_t e, int k, int ritype) const {
    if (k == 0 && e > 0 && 2 * Nn[ritype] < N[365 + ritype]) return 1;
    if (e < 0 && 2 * Nn[ritype] >= N[365 + ritype]) return 1;
    if (e < 0 && k != 0) return 1;
    return 0;
  }

  int64_t ri_unmap(int64_t em, int k, int ritype) const {
    int64_t temp = em + ritype;
    int mapbit = (int)(temp & 1);
    int64_t e_abs = (temp + mapbit) / 2;
    bool cond = (k != 0) || (2 * Nn[ritype] >= N[365 + ritype]);
    return (cond == (mapbit != 0)) ? -e_abs : e_abs;
  }

  void ri_update(int ritype, int64_t e, int64_t em) {
    int q = 365 + ritype;
    if (e < 0) Nn[ritype] += 1;
    A[q] += (em + 1 - ritype) >> 1;
    if (N[q] == reset) {
      A[q] >>= 1;
      N[q] >>= 1;
      Nn[ritype] >>= 1;
    }
    N[q] += 1;
  }

  int64_t quantize_error(int64_t e) const {
    if (near == 0) return e;
    return e > 0 ? (near + e) / (2 * near + 1) : -((near - e) / (2 * near + 1));
  }

  int64_t mod_reduce(int64_t e) const {
    if (e < 0) e += range;
    if (e >= (range + 1) / 2) e -= range;
    return e;
  }

  int64_t reconstruct(int64_t px, int sign, int64_t e) const {
    int64_t rx = px + (int64_t)sign * e * (2 * near + 1);
    if (rx < -near)
      rx += (int64_t)range * (2 * near + 1);
    else if (rx > maxval + near)
      rx -= (int64_t)range * (2 * near + 1);
    if (rx < 0) rx = 0;
    if (rx > maxval) rx = maxval;
    return rx;
  }
};

static inline int quantize_gradient(int d, int t1, int t2, int t3, int near) {
  if (d <= -t3) return -4;
  if (d <= -t2) return -3;
  if (d <= -t1) return -2;
  if (d < -near) return -1;
  if (d <= near) return 0;
  if (d < t1) return 1;
  if (d < t2) return 2;
  if (d < t3) return 3;
  return 4;
}

static inline int64_t predict(int64_t a, int64_t b, int64_t c) {
  int64_t mx = a > b ? a : b, mn = a > b ? b : a;
  if (c >= mx) return mn;
  if (c <= mn) return mx;
  return a + b - c;
}

struct BitWriter {
  std::vector<uint8_t> buf;
  uint32_t acc = 0;
  int n = 0, width = 8;

  void write_bit(int bit) {
    if (n == 0) width = (!buf.empty() && buf.back() == 0xFF) ? 7 : 8;
    acc = (acc << 1) | (bit & 1);
    if (++n == width) {
      buf.push_back((uint8_t)acc);
      acc = 0;
      n = 0;
    }
  }
  void write_bits(int64_t v, int nbits) {
    for (int i = nbits - 1; i >= 0; --i) write_bit((int)((v >> i) & 1));
  }
  void flush() {
    if (n) {
      acc <<= (width - n);
      buf.push_back((uint8_t)acc);
      acc = 0;
      n = 0;
    }
  }
};

struct LsBitReader {
  const uint8_t *data;
  long long len, pos;
  uint64_t acc = 0;
  int n = 0;
  bool prev_ff = false;
  bool error = false;

  void fill() {
    if (pos >= len) {
      acc <<= 8;
      n += 8;
      return;
    }
    uint8_t byte = data[pos];
    if (prev_ff) {
      if (byte & 0x80) {  // marker: pad zeros
        acc <<= 8;
        n += 8;
        return;
      }
      ++pos;
      acc = (acc << 7) | (byte & 0x7F);
      n += 7;
      prev_ff = false;
    } else {
      ++pos;
      acc = (acc << 8) | byte;
      n += 8;
      prev_ff = byte == 0xFF;
    }
  }
  int read_bit() {
    if (n == 0) fill();
    --n;
    int bit = (int)((acc >> n) & 1);
    acc &= (1ULL << n) - 1;
    return bit;
  }
  int64_t read_bits(int nbits) {
    int64_t v = 0;
    for (int i = 0; i < nbits; ++i) v = (v << 1) | read_bit();
    return v;
  }
};

static void golomb_encode(BitWriter &bw, int64_t merr, int k, int limit, int qbpp) {
  int64_t high = merr >> k;
  if (high < limit - qbpp - 1) {
    for (int64_t i = 0; i < high; ++i) bw.write_bit(0);
    bw.write_bit(1);
    bw.write_bits(merr & ((1LL << k) - 1), k);
  } else {
    for (int i = 0; i < limit - qbpp - 1; ++i) bw.write_bit(0);
    bw.write_bit(1);
    bw.write_bits(merr - 1, qbpp);
  }
}

static int64_t golomb_decode(LsBitReader &br, int k, int limit, int qbpp) {
  int high = 0;
  while (br.read_bit() == 0) {
    if (++high > limit + 64) {
      br.error = true;
      return 0;
    }
  }
  if (high < limit - qbpp - 1) return ((int64_t)high << k) | br.read_bits(k);
  return br.read_bits(qbpp) + 1;
}

// Neighbor fetch matching jpeg_ls.py::_neighbors.
static inline void neighbors(const int64_t *rec, int row, int col, int rows,
                             int cols, int64_t &a, int64_t &b, int64_t &c,
                             int64_t &d) {
  (void)rows;
  if (row == 0) {
    a = col ? rec[col - 1] : 0;
    b = c = d = 0;
    return;
  }
  const int64_t *prev = rec + (long long)(row - 1) * cols;
  b = prev[col];
  d = (col + 1 < cols) ? prev[col + 1] : b;
  if (col == 0) {
    a = prev[0];
    c = (row >= 2) ? rec[(long long)(row - 2) * cols] : 0;
  } else {
    a = rec[(long long)row * cols + col - 1];
    c = prev[col - 1];
  }
}

static void default_thresholds(int maxval, int near, int *t1, int *t2, int *t3,
                               int *reset) {
  auto clampv = [&](int t, int lo) {
    if (t < lo) t = lo;
    if (t > maxval) t = maxval;
    return t;
  };
  if (maxval >= 128) {
    int factor = ((maxval < 4095 ? maxval : 4095) + 128) / 256;
    *t1 = clampv(factor * (3 - 2) + 2 + 3 * near, near + 1);
    *t2 = clampv(factor * (7 - 3) + 3 + 5 * near, *t1);
    *t3 = clampv(factor * (21 - 4) + 4 + 7 * near, *t2);
  } else {
    int factor = 256 / (maxval + 1);
    int v1 = 3 / factor + 3 * near;
    if (v1 < 2) v1 = 2;
    *t1 = clampv(v1, near + 1);
    int v2 = 7 / factor + 5 * near;
    if (v2 < 3) v2 = 3;
    *t2 = clampv(v2, *t1);
    int v3 = 21 / factor + 7 * near;
    if (v3 < 4) v3 = 4;
    *t3 = clampv(v3, *t2);
  }
  *reset = 64;
}

}  // namespace jls

// Decode a single-component JPEG-LS stream. out_meta = {rows, cols,
// precision, near}. probe=1 parses headers only. Returns 0 ok, -1 bad
// stream, -2 unsupported, -3 corrupt entropy data.
int dosma_jpeg_ls_decode(const uint8_t *data, long long nlen, uint16_t *dst,
                         long long dst_len, int *out_meta, int probe) {
  using namespace jls;
  if (nlen < 4 || data[0] != 0xFF || data[1] != 0xD8) return -1;
  long long pos = 2;
  int precision = -1, rows = -1, cols = -1;
  int maxval = 0, t1 = 0, t2 = 0, t3 = 0, reset = 0, near = 0;
  bool have_lse = false;

  while (pos + 1 < nlen) {
    if (data[pos] != 0xFF) return -1;
    uint8_t marker = data[pos + 1];
    pos += 2;
    if (marker == 0x01 || (marker >= 0xD0 && marker <= 0xD7)) continue;
    if (pos + 2 > nlen) return -1;
    int seglen = (data[pos] << 8) | data[pos + 1];
    if (pos + seglen > nlen) return -1;
    const uint8_t *body = data + pos + 2;
    int blen = seglen - 2;
    pos += seglen;
    if (marker == 0xDD) {
      return -2;  // DRI/RSTn unsupported (matches the Python decoder)
    }
    if (marker == 0xF7) {  // SOF55
      if (blen < 6) return -1;
      precision = body[0];
      rows = (body[1] << 8) | body[2];
      cols = (body[3] << 8) | body[4];
      if (body[5] != 1) return -2;
    } else if (marker == 0xF8) {  // LSE
      if (blen < 1) return -1;
      if (body[0] != 1) return -2;  // mapping tables unsupported
      if (blen < 11) return -1;
      maxval = (body[1] << 8) | body[2];
      t1 = (body[3] << 8) | body[4];
      t2 = (body[5] << 8) | body[6];
      t3 = (body[7] << 8) | body[8];
      reset = (body[9] << 8) | body[10];
      have_lse = true;
    } else if (marker == 0xDA) {  // SOS
      if (blen < 4) return -1;
      int ns = body[0];
      if (ns != 1) return -2;
      near = body[1 + 2 * ns];
      if (body[2 + 2 * ns] != 0) return -2;  // ILV
      break;
    }
  }
  if (precision < 2 || rows < 0) return -1;
  if (!have_lse || maxval == 0) maxval = (1 << precision) - 1;
  int dt1, dt2, dt3, dreset;
  default_thresholds(maxval, near, &dt1, &dt2, &dt3, &dreset);
  if (t1 == 0) t1 = dt1;
  if (t2 == 0) t2 = dt2;
  if (t3 == 0) t3 = dt3;
  if (reset == 0) reset = dreset;

  if (out_meta) {
    out_meta[0] = rows;
    out_meta[1] = cols;
    out_meta[2] = precision;
    out_meta[3] = near;
  }
  if (probe) return 0;
  if (!dst || dst_len < (long long)rows * cols) return -1;

  State st;
  st.init(maxval, near, reset);
  LsBitReader br{data, nlen, pos};
  std::vector<int64_t> rec((long long)rows * cols, 0);

  for (int row = 0; row < rows; ++row) {
    int64_t *cur = rec.data() + (long long)row * cols;
    int col = 0;
    while (col < cols) {
      int64_t a, b, c, d;
      neighbors(rec.data(), row, col, rows, cols, a, b, c, d);
      int64_t d1 = d - b, d2 = b - c, d3 = c - a;
      if (llabs(d1) <= near && llabs(d2) <= near && llabs(d3) <= near) {
        // Run mode.
        bool interrupted = false;
        while (true) {
          if (br.read_bit() == 1) {
            int seg = 1 << J[st.run_index];
            int count = seg < cols - col ? seg : cols - col;
            for (int i = 0; i < count; ++i) cur[col++] = a;
            if (count == seg) {
              if (st.run_index < 31) ++st.run_index;
              if (col >= cols) break;
              continue;
            }
            break;  // partial fill ended the line
          }
          if (J[st.run_index]) {
            int64_t r = br.read_bits(J[st.run_index]);
            for (int64_t i = 0; i < r; ++i) cur[col++] = a;
          }
          interrupted = true;
          break;
        }
        if (!interrupted) continue;

        int64_t b_here = row ? rec[(long long)(row - 1) * cols + col] : 0;
        int ritype = (llabs(a - b_here) <= near) ? 1 : 0;
        int64_t px;
        int sign;
        if (ritype) {
          px = a;
          sign = 1;
        } else {
          px = b_here;
          sign = a > b_here ? -1 : 1;
        }
        int k = st.ri_k(ritype);
        int64_t em =
            golomb_decode(br, k, st.limit - J[st.run_index] - 1, st.qbpp);
        if (br.error) return -3;
        int64_t errval = st.ri_unmap(em, k, ritype);
        cur[col] = st.reconstruct(px, sign, errval);
        st.ri_update(ritype, errval, em);
        if (st.run_index > 0) --st.run_index;
        ++col;
        continue;
      }

      int q1 = quantize_gradient((int)d1, t1, t2, t3, near);
      int q2 = quantize_gradient((int)d2, t1, t2, t3, near);
      int q3 = quantize_gradient((int)d3, t1, t2, t3, near);
      int q = 81 * q1 + 9 * q2 + q3;
      int sign = 1;
      if (q < 0) {
        q = -q;
        sign = -1;
      }
      int64_t px = predict(a, b, c) + sign * st.C[q];
      if (px < 0) px = 0;
      if (px > maxval) px = maxval;
      int k = st.golomb_k(q);
      int64_t merr = golomb_decode(br, k, st.limit, st.qbpp);
      if (br.error) return -3;
      int64_t errval = st.unmap_error(merr, k, q);
      cur[col] = st.reconstruct(px, sign, errval);
      st.update(q, errval);
      ++col;
    }
  }

  for (long long i = 0; i < (long long)rows * cols; ++i)
    dst[i] = (uint16_t)rec[i];
  return 0;
}

// Encode a single-component frame. Returns bytes written, negative error.
long long dosma_jpeg_ls_encode(const uint16_t *src, int rows, int cols,
                               int precision, int near, uint8_t *dst,
                               long long cap) {
  using namespace jls;
  if (precision < 2 || precision > 16) return -2;
  int maxval = (1 << precision) - 1;
  int t1, t2, t3, reset;
  default_thresholds(maxval, near, &t1, &t2, &t3, &reset);

  std::vector<uint8_t> out;
  out.reserve((long long)rows * cols / 2 + 64);
  auto push16 = [&](int v) {
    out.push_back((uint8_t)(v >> 8));
    out.push_back((uint8_t)(v & 0xFF));
  };
  out.push_back(0xFF);
  out.push_back(0xD8);
  out.push_back(0xFF);
  out.push_back(0xF7);  // SOF55
  push16(8 + 3);
  out.push_back((uint8_t)precision);
  push16(rows);
  push16(cols);
  out.push_back(1);
  out.push_back(1);
  out.push_back(0x11);
  out.push_back(0);
  out.push_back(0xFF);
  out.push_back(0xF8);  // LSE id 1
  push16(13);
  out.push_back(1);
  push16(maxval);
  push16(t1);
  push16(t2);
  push16(t3);
  push16(reset);
  out.push_back(0xFF);
  out.push_back(0xDA);  // SOS
  push16(6 + 2);
  out.push_back(1);
  out.push_back(1);
  out.push_back(0x00);
  out.push_back((uint8_t)near);
  out.push_back(0);
  out.push_back(0);

  State st;
  st.init(maxval, near, reset);
  BitWriter bw;
  std::vector<int64_t> rec((long long)rows * cols, 0);

  for (int row = 0; row < rows; ++row) {
    int64_t *cur = rec.data() + (long long)row * cols;
    const uint16_t *srow = src + (long long)row * cols;
    int col = 0;
    while (col < cols) {
      int64_t a, b, c, d;
      neighbors(rec.data(), row, col, rows, cols, a, b, c, d);
      int64_t d1 = d - b, d2 = b - c, d3 = c - a;
      if (llabs(d1) <= near && llabs(d2) <= near && llabs(d3) <= near) {
        // Run mode.
        int run_len = 0;
        while (col < cols && llabs((int64_t)srow[col] - a) <= near) {
          cur[col++] = a;
          ++run_len;
        }
        while (run_len >= (1 << J[st.run_index])) {
          bw.write_bit(1);
          run_len -= 1 << J[st.run_index];
          if (st.run_index < 31) ++st.run_index;
        }
        if (col >= cols) {
          if (run_len > 0) bw.write_bit(1);
          continue;  // while(col<cols) exits
        }
        bw.write_bit(0);
        if (J[st.run_index]) bw.write_bits(run_len, J[st.run_index]);

        int64_t b_here = row ? rec[(long long)(row - 1) * cols + col] : 0;
        int ritype = (llabs(a - b_here) <= near) ? 1 : 0;
        int64_t px;
        int sign;
        if (ritype) {
          px = a;
          sign = 1;
        } else {
          px = b_here;
          sign = a > b_here ? -1 : 1;
        }
        int64_t errval =
            st.mod_reduce(st.quantize_error((int64_t)sign * (srow[col] - px)));
        int k = st.ri_k(ritype);
        int64_t em = 2 * llabs(errval) - ritype - st.ri_map(errval, k, ritype);
        golomb_encode(bw, em, k, st.limit - J[st.run_index] - 1, st.qbpp);
        cur[col] = st.reconstruct(px, sign, errval);
        st.ri_update(ritype, errval, em);
        if (st.run_index > 0) --st.run_index;
        ++col;
        continue;
      }

      int q1 = quantize_gradient((int)d1, t1, t2, t3, near);
      int q2 = quantize_gradient((int)d2, t1, t2, t3, near);
      int q3 = quantize_gradient((int)d3, t1, t2, t3, near);
      int q = 81 * q1 + 9 * q2 + q3;
      int sign = 1;
      if (q < 0) {
        q = -q;
        sign = -1;
      }
      int64_t px = predict(a, b, c) + sign * st.C[q];
      if (px < 0) px = 0;
      if (px > maxval) px = maxval;
      int64_t errval =
          st.mod_reduce(st.quantize_error((int64_t)sign * (srow[col] - px)));
      int k = st.golomb_k(q);
      golomb_encode(bw, st.map_error(errval, k, q), k, st.limit, st.qbpp);
      cur[col] = st.reconstruct(px, sign, errval);
      st.update(q, errval);
      ++col;
    }
  }

  bw.flush();
  out.insert(out.end(), bw.buf.begin(), bw.buf.end());
  out.push_back(0xFF);
  out.push_back(0xD9);

  if ((long long)out.size() > cap) return -1;
  std::memcpy(dst, out.data(), out.size());
  return (long long)out.size();
}

// ---------------------------------------------------------------------------
// Encoders (byte-identical twins of the Python codecs).
// ---------------------------------------------------------------------------
static long long packbits_encode(const uint8_t *src, long long n, uint8_t *dst,
                                 long long cap) {
  long long i = 0, o = 0;
  while (i < n) {
    long long run = 1;
    while (i + run < n && run < 128 && src[i + run] == src[i]) ++run;
    if (run >= 2) {
      if (o + 2 > cap) return -1;
      dst[o++] = (uint8_t)(257 - run);
      dst[o++] = src[i];
      i += run;
      continue;
    }
    long long j = i + 1;
    while (j < n && j - i < 128) {
      if (j + 2 < n && src[j] == src[j + 1] && src[j] == src[j + 2]) break;
      ++j;
    }
    if (o + 1 + (j - i) > cap) return -1;
    dst[o++] = (uint8_t)(j - i - 1);
    std::memcpy(dst + o, src + i, (size_t)(j - i));
    o += j - i;
    i = j;
  }
  return o;
}

// Encode one frame as RLE Lossless. src_be: big-endian sample bytes in
// pixel-major order (rows*cols*samples*nbytes). Returns total bytes written
// to dst (header + segments), or negative on overflow/invalid input.
long long dosma_rle_encode(const uint8_t *src_be, int rows, int cols,
                           int samples, int nbytes, uint8_t *dst,
                           long long cap) {
  int nseg = samples * nbytes;
  if (nseg < 1 || nseg > 15) return -2;
  long long plane_len = (long long)rows * cols;
  if (cap < 64) return -1;

  uint32_t header[16] = {0};
  header[0] = (uint32_t)nseg;
  long long o = 64;
  std::vector<uint8_t> plane((size_t)plane_len);
  long long stride = (long long)samples * nbytes;
  int k = 0;
  for (int s = 0; s < samples; ++s) {
    for (int b = 0; b < nbytes; ++b, ++k) {
      const uint8_t *base = src_be + (long long)s * nbytes + b;
      for (long long p = 0; p < plane_len; ++p) plane[(size_t)p] = base[p * stride];
      long long got = packbits_encode(plane.data(), plane_len, dst + o, cap - o);
      if (got < 0) return -1;
      if (got % 2) {
        if (o + got + 1 > cap) return -1;
        dst[o + got] = 0x00;
        ++got;
      }
      header[1 + k] = (uint32_t)o;
      o += got;
    }
  }
  std::memcpy(dst, header, 64);
  return o;
}

namespace {

struct BitWriter {
  uint8_t *dst;
  long long cap;
  long long o = 0;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  BitWriter(uint8_t *d, long long c) : dst(d), cap(c) {}

  inline void write(uint32_t value, int want) {
    if (want == 0) return;
    acc = (acc << want) | (value & ((want >= 32) ? 0xFFFFFFFFu : ((1u << want) - 1)));
    nbits += want;
    while (nbits >= 8) {
      uint8_t byte = (uint8_t)((acc >> (nbits - 8)) & 0xFF);
      if (o >= cap) { overflow = true; return; }
      dst[o++] = byte;
      if (byte == 0xFF) {
        if (o >= cap) { overflow = true; return; }
        dst[o++] = 0x00;  // stuffing
      }
      nbits -= 8;
    }
    acc &= (nbits >= 64) ? ~0ULL : ((1ULL << nbits) - 1);
  }

  inline void flush() {
    if (nbits) {
      int pad = 8 - nbits;
      write((1u << pad) - 1, pad);  // 1-padding per T.81 F.1.2.3
    }
  }
};

}  // namespace

// Encode a 2D unsigned frame (uint16 samples) as a single-component JPEG
// lossless (SOF3) stream with the fixed Huffman table the Python encoder
// uses. Returns bytes written, negative on error.
long long dosma_jpeg_lossless_encode(const uint16_t *src, int rows, int cols,
                                     int precision, int predictor,
                                     int point_transform, uint8_t *dst,
                                     long long cap) {
  if (precision < 2 || precision > 16) return -2;
  if (predictor < 1 || predictor > 7) return -2;
  // Fixed encoder table: categories 0-2 at 2 bits, 3..16 at 3..16 bits.
  static const uint8_t enc_bits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1};
  static const uint8_t enc_values[17] = {0, 1, 2, 3, 4, 5, 6, 7, 8,
                                         9, 10, 11, 12, 13, 14, 15, 16};
  uint16_t codes[17];
  uint8_t lens[17];
  {
    int code = 0, vi = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int c = 0; c < enc_bits[l - 1]; ++c) {
        codes[enc_values[vi]] = (uint16_t)code;
        lens[enc_values[vi]] = (uint8_t)l;
        ++code;
        ++vi;
      }
      code <<= 1;
    }
  }

  long long o = 0;
  auto put = [&](std::initializer_list<uint8_t> bytes) -> bool {
    for (uint8_t b : bytes) {
      if (o >= cap) return false;
      dst[o++] = b;
    }
    return true;
  };
  if (!put({0xFF, 0xD8})) return -1;  // SOI
  // SOF3: length 11, precision, lines, samples/line, 1 component (1, 1x1, 0)
  if (!put({0xFF, 0xC3, 0x00, 11, (uint8_t)precision, (uint8_t)(rows >> 8),
            (uint8_t)rows, (uint8_t)(cols >> 8), (uint8_t)cols, 1, 1, 0x11, 0}))
    return -1;
  // DHT (class 0, id 0)
  int dht_len = 2 + 1 + 16 + 17;
  if (!put({0xFF, 0xC4, (uint8_t)(dht_len >> 8), (uint8_t)dht_len, 0x00})) return -1;
  for (int i = 0; i < 16; ++i)
    if (!put({enc_bits[i]})) return -1;
  for (int i = 0; i < 17; ++i)
    if (!put({enc_values[i]})) return -1;
  // SOS: 1 component, Ss=predictor, Se=0, Ah<<4|Al=point transform
  if (!put({0xFF, 0xDA, 0x00, 8, 1, 1, 0x00, (uint8_t)predictor, 0,
            (uint8_t)point_transform}))
    return -1;

  BitWriter bw(dst + o, cap - o);
  int x0 = 1 << (precision - point_transform - 1);
  std::vector<int32_t> prev((size_t)cols), cur((size_t)cols);
  bool first_line = true;
  for (int r = 0; r < rows; ++r) {
    const uint16_t *row = src + (long long)r * cols;
    for (int c = 0; c < cols; ++c) cur[(size_t)c] = (int32_t)(row[c] >> point_transform);
    for (int c = 0; c < cols; ++c) {
      int32_t px;
      if (first_line) {
        px = c > 0 ? cur[(size_t)(c - 1)] : x0;
      } else if (c == 0) {
        px = prev[0];
      } else {
        int32_t ra = cur[(size_t)(c - 1)], rb = prev[(size_t)c], rc = prev[(size_t)(c - 1)];
        switch (predictor) {
          case 1: px = ra; break;
          case 2: px = rb; break;
          case 3: px = rc; break;
          case 4: px = ra + rb - rc; break;
          case 5: px = ra + ((rb - rc) >> 1); break;
          case 6: px = rb + ((ra - rc) >> 1); break;
          default: px = (ra + rb) >> 1; break;
        }
      }
      int32_t diff = (cur[(size_t)c] - px) & 0xFFFF;
      if (diff >= 0x8000) diff -= 0x10000;
      int ssss;
      if (diff == -32768) {
        ssss = 16;
      } else {
        uint32_t a = (uint32_t)(diff < 0 ? -diff : diff);
        ssss = 0;
        while (a) { ++ssss; a >>= 1; }
      }
      bw.write(codes[ssss], lens[ssss]);
      if (ssss > 0 && ssss < 16) {
        int32_t v = diff > 0 ? diff : diff + (1 << ssss) - 1;
        bw.write((uint32_t)v, ssss);
      }
      if (bw.overflow) return -1;
    }
    std::swap(prev, cur);
    first_line = false;
  }
  bw.flush();
  if (bw.overflow) return -1;
  o += bw.o;
  if (o + 2 > cap) return -1;
  dst[o++] = 0xFF;
  dst[o++] = 0xD9;  // EOI
  return o;
}


// ---------------------------------------------------------------------------
// JPEG 2000 Part-1 LOSSLESS decoder (ITU-T T.800) — native twin of
// dosma_tpu_torch/core/io/dicom/j2k.py (the behavioral reference; tests assert
// bit-parity between the two). Scope: reversible 5/3, no quantization,
// default code-block styles; returns -2 for out-of-profile codestreams so
// the Python dispatch can fall through.
// ---------------------------------------------------------------------------

}  // extern "C" — the j2k helpers are C++ (classes, vectors, namespaces)

namespace j2k {

struct MQ {
  const uint8_t *data; long long n, bp;
  uint32_t c, a; int ct;
  uint8_t idx[19], mps[19];
  static const uint16_t QE[47]; static const uint8_t NMPS[47], NLPS[47], SW[47];
  void init(const uint8_t *d, long long len) {
    data = d; n = len;
    for (int i = 0; i < 19; i++) { idx[i] = 0; mps[i] = 0; }
    idx[0] = 4; idx[17] = 3; idx[18] = 46;
    bp = 0;
    uint8_t b0 = n > 0 ? data[0] : 0xFF;
    c = (uint32_t)b0 << 16;
    bytein();
    c <<= 7; ct -= 7; a = 0x8000;
  }
  void bytein() {
    uint8_t b = bp < n ? data[bp] : 0xFF;
    if (b == 0xFF) {
      uint8_t b1 = bp + 1 < n ? data[bp + 1] : 0xFF;
      if (b1 > 0x8F) { c += 0xFF00; ct = 8; }
      else { bp++; c += (uint32_t)b1 << 9; ct = 7; }
    } else {
      bp++;
      uint8_t b1 = bp < n ? data[bp] : 0xFF;
      c += (uint32_t)b1 << 8; ct = 8;
    }
  }
  int decode(int cx) {
    int i = idx[cx];
    uint32_t qe = QE[i];
    int d;
    a -= qe;
    if (((c >> 16) & 0xFFFF) < qe) {
      if (a < qe) { d = mps[cx]; idx[cx] = NMPS[i]; }
      else { d = 1 - mps[cx]; if (SW[i]) mps[cx] = 1 - mps[cx]; idx[cx] = NLPS[i]; }
      a = qe;
    } else {
      c -= qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < qe) { d = 1 - mps[cx]; if (SW[i]) mps[cx] = 1 - mps[cx]; idx[cx] = NLPS[i]; }
      else { d = mps[cx]; idx[cx] = NMPS[i]; }
    }
    do {
      if (ct == 0) bytein();
      a <<= 1; c <<= 1; ct--;
    } while (!(a & 0x8000));
    return d;
  }
};
const uint16_t MQ::QE[47] = {
  0x5601,0x3401,0x1801,0x0AC1,0x0521,0x0221,0x5601,0x5401,0x4801,0x3801,
  0x3001,0x2401,0x1C01,0x1601,0x5601,0x5401,0x5101,0x4801,0x3801,0x3401,
  0x3001,0x2801,0x2401,0x2201,0x1C01,0x1801,0x1601,0x1401,0x1201,0x1101,
  0x0AC1,0x09C1,0x08A1,0x0521,0x0441,0x02A1,0x0221,0x0141,0x0111,0x0085,
  0x0049,0x0025,0x0015,0x0009,0x0005,0x0001,0x5601};
const uint8_t MQ::NMPS[47] = {1,2,3,4,5,38,7,8,9,10,11,12,13,29,15,16,17,18,19,20,
  21,22,23,24,25,26,27,28,29,30,31,32,33,34,35,36,37,38,39,40,41,42,43,44,45,45,46};
const uint8_t MQ::NLPS[47] = {1,6,9,12,29,33,6,14,14,14,17,18,20,21,14,14,15,16,17,18,
  19,19,20,21,22,23,24,25,26,27,28,29,30,31,32,33,34,35,36,37,38,39,40,41,42,43,46};
const uint8_t MQ::SW[47] = {1,0,0,0,0,0,1,0,0,0,0,0,0,0,1,0,0,0,0,0,
  0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0};

struct BitReader {
  const uint8_t *data; long long pos, n; int bitbuf, nbits; uint8_t last;
  void init(const uint8_t *d, long long p, long long len) {
    data = d; pos = p; n = len; bitbuf = 0; nbits = 0; last = 0;
  }
  int bit() {
    if (nbits == 0) {
      // Past-end reads (truncated stream) feed 1-bits: tag trees resolve
      // immediately and the decoded lengths overrun the buffer, which the
      // caller's bounds check turns into a clean -1.
      uint8_t b = pos < n ? data[pos] : 0xFF;
      pos++;
      if (last == 0xFF) { bitbuf = b & 0x7F; nbits = 7; }
      else { bitbuf = b; nbits = 8; }
      last = b;
    }
    nbits--;
    return (bitbuf >> nbits) & 1;
  }
  uint32_t bits(int k) { uint32_t v = 0; while (k--) v = (v << 1) | bit(); return v; }
  void align() { nbits = 0; if (last == 0xFF) pos++; last = 0; }
};

struct TagTree {
  int nlev;
  std::vector<std::vector<int32_t>> value, low;
  std::vector<std::vector<uint8_t>> known;
  std::vector<std::pair<int,int>> dims;
  void init(int w, int h) {
    dims.clear(); value.clear(); low.clear(); known.clear();
    for (;;) {
      dims.push_back({w, h});
      if (w <= 1 && h <= 1) break;
      w = (w + 1) / 2; h = (h + 1) / 2;
    }
    nlev = (int)dims.size();
    for (auto &d : dims) {
      value.emplace_back((size_t)d.first * d.second, 0);
      low.emplace_back((size_t)d.first * d.second, 0);
      known.emplace_back((size_t)d.first * d.second, 0);
    }
  }
  bool decode(BitReader &br, int x, int y, int threshold) {
    int lowv = 0;
    for (int lev = nlev - 1; lev >= 0; lev--) {
      int xx = x >> lev, yy = y >> lev;
      size_t k = (size_t)yy * dims[lev].first + xx;
      if (low[lev][k] < lowv) low[lev][k] = lowv;
      while (!known[lev][k] && low[lev][k] < threshold) {
        if (br.bit()) { value[lev][k] = low[lev][k]; known[lev][k] = 1; }
        else low[lev][k]++;
      }
      if (known[lev][k]) lowv = value[lev][k];
      else return false;
    }
    return value[0][(size_t)y * dims[0].first + x] < threshold;
  }
  int get(BitReader &br, int x, int y) {
    int t = 1;
    while (!decode(br, x, y, t)) t++;
    return value[0][(size_t)y * dims[0].first + x];
  }
};

// Zero-coding context (band: 0=LL/LH, 1=HL, 2=HH)
static inline int zc_ctx(int h, int v, int d, int band) {
  if (band == 1) { int t = h; h = v; v = t; }
  if (band != 2) {
    if (h == 2) return 8;
    if (h == 1) return v >= 1 ? 7 : (d >= 1 ? 6 : 5);
    if (v == 2) return 4;
    if (v == 1) return 3;
    return d >= 2 ? 2 : (d == 1 ? 1 : 0);
  }
  if (d >= 3) return 8;
  if (d == 2) return h + v >= 1 ? 7 : 6;
  if (d == 1) { int s = h + v; return s >= 2 ? 5 : (s == 1 ? 4 : 3); }
  int s = h + v;
  return s >= 2 ? 2 : (s == 1 ? 1 : 0);
}

struct Block {
  int w, h, band;
  MQ mq;
  std::vector<uint8_t> sig, vis;   // (h+2)x(w+2) halo
  std::vector<int8_t> sgn;
  std::vector<uint8_t> refined;    // h x w
  std::vector<int64_t> mag;        // h x w
  int64_t weight;
  int W2;
  void init(int w_, int h_, int band_, const uint8_t *d, long long n) {
    w = w_; h = h_; band = band_; W2 = w + 2;
    mq.init(d, n);
    sig.assign((size_t)(h + 2) * W2, 0);
    vis.assign((size_t)(h + 2) * W2, 0);
    sgn.assign((size_t)(h + 2) * W2, 0);
    refined.assign((size_t)h * w, 0);
    mag.assign((size_t)h * w, 0);
    weight = 1;
  }
  inline void hvd(int py, int px, int &hh, int &vv, int &dd) const {
    const uint8_t *s = sig.data();
    size_t r = (size_t)py * W2 + px;
    hh = s[r - 1] + s[r + 1];
    vv = s[r - W2] + s[r + W2];
    dd = s[r - W2 - 1] + s[r - W2 + 1] + s[r + W2 - 1] + s[r + W2 + 1];
  }
  inline int decode_sign(int py, int px) {
    size_t r = (size_t)py * W2 + px;
    int hc = sig[r - 1] * sgn[r - 1] + sig[r + 1] * sgn[r + 1];
    int vc = sig[r - W2] * sgn[r - W2] + sig[r + W2] * sgn[r + W2];
    hc = hc > 1 ? 1 : (hc < -1 ? -1 : hc);
    vc = vc > 1 ? 1 : (vc < -1 ? -1 : vc);
    static const int CTX[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    static const int XOR[3][3] = {{1, 1, 1}, {1, 0, 0}, {1, 0, 0}};
    // index by (hc+1 reversed): build with hc=-1..1 rows
    int ctx, xo;
    if (hc == 1) { ctx = vc == 1 ? 13 : (vc == 0 ? 12 : 11); xo = 0; }
    else if (hc == 0) { ctx = vc == 0 ? 9 : 10; xo = vc == -1 ? 1 : 0; }
    else { ctx = vc == 1 ? 11 : (vc == 0 ? 12 : 13); xo = 1; }
    (void)CTX; (void)XOR;
    return mq.decode(ctx) ^ xo;  // 1 = negative
  }
  inline void set_sig(int y, int x, int neg) {
    size_t r = (size_t)(y + 1) * W2 + (x + 1);
    sig[r] = 1; sgn[r] = neg ? -1 : 1;
    mag[(size_t)y * w + x] = weight;
  }
  void spp() {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; x++) {
        int px = x + 1;
        int ymax = y0 + 4 < h ? y0 + 4 : h;
        for (int y = y0; y < ymax; y++) {
          int py = y + 1;
          size_t r = (size_t)py * W2 + px;
          if (sig[r]) continue;
          int hh, vv, dd; hvd(py, px, hh, vv, dd);
          if (hh + vv + dd == 0) continue;
          vis[r] = 1;
          if (mq.decode(zc_ctx(hh, vv, dd, band))) set_sig(y, x, decode_sign(py, px));
        }
      }
  }
  void mrp() {
    for (int y0 = 0; y0 < h; y0 += 4)
      for (int x = 0; x < w; x++) {
        int px = x + 1;
        int ymax = y0 + 4 < h ? y0 + 4 : h;
        for (int y = y0; y < ymax; y++) {
          int py = y + 1;
          size_t r = (size_t)py * W2 + px;
          if (!sig[r] || vis[r]) continue;
          size_t k = (size_t)y * w + x;
          int ctx;
          if (refined[k]) ctx = 16;
          else { int hh, vv, dd; hvd(py, px, hh, vv, dd); ctx = hh + vv + dd ? 15 : 14; }
          if (mq.decode(ctx)) mag[k] += weight;
          refined[k] = 1;
        }
      }
  }
  void cup() {
    for (int y0 = 0; y0 < h; y0 += 4) {
      bool full = y0 + 4 <= h;
      for (int x = 0; x < w; x++) {
        int px = x + 1;
        int y = y0;
        if (full) {
          bool rl = true;
          for (int yy = y0; yy < y0 + 4; yy++) {
            size_t r = (size_t)(yy + 1) * W2 + px;
            if (sig[r] || vis[r]) { rl = false; break; }
            int hh, vv, dd; hvd(yy + 1, px, hh, vv, dd);
            if (hh + vv + dd) { rl = false; break; }
          }
          if (rl) {
            if (!mq.decode(17)) continue;
            int rpos = (mq.decode(18) << 1) | mq.decode(18);
            y = y0 + rpos;
            set_sig(y, x, decode_sign(y + 1, px));
            y++;
          }
        }
        int ymax = y0 + 4 < h ? y0 + 4 : h;
        for (int yy = y; yy < ymax; yy++) {
          size_t r = (size_t)(yy + 1) * W2 + px;
          if (sig[r] || vis[r]) continue;
          int hh, vv, dd; hvd(yy + 1, px, hh, vv, dd);
          if (mq.decode(zc_ctx(hh, vv, dd, band))) set_sig(yy, x, decode_sign(yy + 1, px));
        }
      }
    }
    std::fill(vis.begin(), vis.end(), 0);
  }
  void run(int total_passes) {
    int nplanes = total_passes <= 1 ? 1 : 2 + (total_passes - 2) / 3;
    for (int p = 0; p < total_passes; p++) {
      int plane, kind;
      if (p == 0) { plane = 0; kind = 2; }
      else { plane = 1 + (p - 1) / 3; kind = (p - 1) % 3; }
      weight = 1LL << (nplanes - 1 - plane);
      if (kind == 0) spp();
      else if (kind == 1) mrp();
      else cup();
    }
  }
};

struct CbState {
  bool included = false;
  int lblock = 3, passes = 0;
  std::vector<uint8_t> seg;  // concatenated codeword segments
};

struct Cod {
  int prog = 0, layers = 1, mct = 0, levels = 5, cbw = 64, cbh = 64;
  int cbstyle = 0, transform = 1;
  bool sop = false, eph = false, has_precincts = false;
  uint8_t prec[40];
  int prec_n = 0;
};

static int parse_cod(const uint8_t *b, int len, Cod &cod) {
  if (len < 10) return -1;
  int scod = b[0];
  cod.sop = scod & 2; cod.eph = scod & 4;
  cod.prog = b[1];
  cod.layers = (b[2] << 8) | b[3];
  cod.mct = b[4];
  cod.levels = b[5];
  cod.cbw = 1 << ((b[6] & 0xF) + 2);
  cod.cbh = 1 << ((b[7] & 0xF) + 2);
  cod.cbstyle = b[8];
  cod.transform = b[9];
  cod.has_precincts = scod & 1;
  cod.prec_n = 0;
  if (cod.has_precincts) {
    for (int i = 10; i < len && cod.prec_n < 40; i++) cod.prec[cod.prec_n++] = b[i];
  }
  return 0;
}

static inline long long ceil_div(long long a, long long b) {
  return a >= 0 ? (a + b - 1) / b : -((-a) / b);
}

// band rect (T.800 B.5)
static void band_rect(long long tcx0, long long tcy0, long long tcx1, long long tcy1,
                      int lev, int xob, int yob,
                      long long &bx0, long long &by0, long long &bx1, long long &by1) {
  if (lev == 0) { bx0 = tcx0; by0 = tcy0; bx1 = tcx1; by1 = tcy1; return; }
  long long d = 1LL << lev, hf = 1LL << (lev - 1);
  bx0 = ceil_div(tcx0 - hf * xob, d);
  by0 = ceil_div(tcy0 - hf * yob, d);
  bx1 = ceil_div(tcx1 - hf * xob, d);
  by1 = ceil_div(tcy1 - hf * yob, d);
}

// 1-D reversible 5/3 synthesis over absolute span [i0, i1), stride access.
static void sr_1d_53(int64_t *buf, long long i0, long long i1, long long stride) {
  long long n = i1 - i0;
  if (n <= 0) return;
  if (n == 1) {
    if (i0 & 1) buf[0] /= 2;
    return;
  }
  std::vector<int64_t> ext(n + 4);
  for (long long j = 0; j < n; j++) ext[j + 2] = buf[j * stride];
  long long period = 2 * n - 2;
  const long long rels[4] = {-2, -1, n, n + 1};
  const long long slot[4] = {0, 1, n + 2, n + 3};
  for (int k = 0; k < 4; k++) {
    long long m = ((rels[k] % period) + period) % period;
    if (m > period - m) m = period - m;
    ext[slot[k]] = buf[m * stride];
  }
  std::vector<int64_t> out(n + 4);
  long long a0 = i0 - 2;
  // even absolute indices first
  for (long long j = 1; j <= n + 2; j++)
    if (((a0 + j) & 1) == 0) out[j] = ext[j] - ((ext[j - 1] + ext[j + 1] + 2) >> 2);
  for (long long j = 2; j <= n + 1; j++)
    if (((a0 + j) & 1) == 1) out[j] = ext[j] + ((out[j - 1] + out[j + 1]) >> 1);
  for (long long j = 0; j < n; j++) buf[j * stride] = out[j + 2];
}

}  // namespace j2k

// Decode a raw J2K codestream. dst receives h*w*ncomp int32 samples
// (component-interleaved, DC shift applied). out_meta = {h, w, ncomp,
// maxdepth, any_signed}. probe=1: parse main header only, fill out_meta.
// Returns 0 ok, -1 bad stream, -2 unsupported feature, -3 buffer too small.
extern "C" int dosma_j2k_decode(const uint8_t *data, long long n, int32_t *dst,
                     long long cap, int *out_meta, int probe) {
  using namespace j2k;
  if (n < 4 || data[0] != 0xFF || data[1] != 0x4F) return -1;
  long long pos = 2;
  bool have_siz = false, have_cod = false, have_qcd = false;
  long long xs = 0, ys = 0, xo = 0, yo = 0, xts = 0, yts = 0, xto = 0, yto = 0;
  int ncomp = 0;
  int depth[16]; bool is_signed[16];
  Cod cod;
  std::vector<std::vector<std::pair<long long, long long>>> tile_parts;  // per tile: (start, end)
  std::vector<int> tile_has_cod; std::vector<Cod> tile_cods;

  while (pos + 2 <= n) {
    int marker = (data[pos] << 8) | data[pos + 1];
    pos += 2;
    if (marker == 0xFFD9) break;
    if (pos + 2 > n) return -1;
    int ln = (data[pos] << 8) | data[pos + 1];
    const uint8_t *body = data + pos + 2;
    int blen = ln - 2;
    if (pos + ln > n) return -1;
    if (marker == 0xFF51) {  // SIZ
      if (blen < 36) return -1;
      const uint8_t *b = body;
      auto rd32 = [&](int off) {
        return ((long long)b[off] << 24) | (b[off+1] << 16) | (b[off+2] << 8) | b[off+3];
      };
      xs = rd32(2); ys = rd32(6); xo = rd32(10); yo = rd32(14);
      xts = rd32(18); yts = rd32(22); xto = rd32(26); yto = rd32(30);
      ncomp = (b[34] << 8) | b[35];
      if (ncomp < 1 || ncomp > 16) return -2;
      for (int c = 0; c < ncomp; c++) {
        uint8_t ssiz = b[36 + 3 * c];
        depth[c] = 1 + (ssiz & 0x7F);
        is_signed[c] = ssiz & 0x80;
        if (b[37 + 3 * c] != 1 || b[38 + 3 * c] != 1) return -2;  // subsampled
      }
      have_siz = true;
      long long ntx = ceil_div(xs - xto, xts), nty = ceil_div(ys - yto, yts);
      tile_parts.resize((size_t)(ntx * nty));
      tile_cods.resize((size_t)(ntx * nty));
      tile_has_cod.assign((size_t)(ntx * nty), 0);
    } else if (marker == 0xFF52) {  // COD
      if (parse_cod(body, blen, cod)) return -1;
      have_cod = true;
    } else if (marker == 0xFF5C) {  // QCD
      if (blen < 1) return -1;
      int style = body[0] & 0x1F;
      if (style != 0) return -2;  // quantized -> lossy
      // Reversible 5/3 needs no quantization step sizes; Kmax comes from
      // the per-codeblock zero-bitplane counts in packet headers.
      have_qcd = true;
    } else if (marker == 0xFF90) {  // SOT
      if (!have_siz || blen < 8) return -1;
      int isot = (body[0] << 8) | body[1];
      long long psot = ((long long)body[2] << 24) | (body[3] << 16) | (body[4] << 8) | body[5];
      long long tp_start = pos - 2;
      long long tp_end = psot ? tp_start + psot : n;
      if (tp_end > n || (size_t)isot >= tile_parts.size()) return -1;
      long long q = pos + ln;
      for (;;) {
        if (q + 2 > n) return -1;
        int m2 = (data[q] << 8) | data[q + 1];
        if (m2 == 0xFF93) { q += 2; break; }
        if (q + 4 > n) return -1;
        int l2 = (data[q + 2] << 8) | data[q + 3];
        if (m2 == 0xFF52) {
          if (parse_cod(data + q + 4, l2 - 2, tile_cods[isot])) return -1;
          tile_has_cod[isot] = 1;
        }
        q += 2 + l2;
      }
      tile_parts[isot].push_back({q, tp_end});
      pos = tp_end;
      continue;
    }
    pos += ln;
  }
  if (!have_siz || !have_cod || !have_qcd) return -1;
  if (cod.transform != 1) return -2;           // 9/7 lossy
  if (cod.cbstyle & 0x3F) return -2;            // any special mode incl. vcausal
  if (cod.has_precincts) {
    for (int i = 0; i < cod.prec_n; i++)
      if ((cod.prec[i] & 0xF) < 15 || (cod.prec[i] >> 4) < 15) return -2;
  }
  if (!(cod.prog == 0 || cod.prog == 1 || cod.prog == 2 || cod.prog == 4)) return -2;

  long long H = ys - yo, W = xs - xo;
  int maxdepth = 0;
  for (int c = 0; c < ncomp; c++) maxdepth = depth[c] > maxdepth ? depth[c] : maxdepth;
  if (out_meta) {
    out_meta[0] = (int)H; out_meta[1] = (int)W;
    out_meta[2] = ncomp; out_meta[3] = maxdepth;
    int any_signed = 0;
    for (int c = 0; c < ncomp; c++) any_signed |= is_signed[c] ? 1 : 0;
    out_meta[4] = any_signed;
  }
  if (probe) return 0;
  if (cap < H * W * ncomp) return -3;

  long long ntx = ceil_div(xs - xto, xts);
  long long nty = ceil_div(ys - yto, yts);

  for (long long t = 0; t < ntx * nty; t++) {
    if (tile_parts[(size_t)t].empty()) continue;
    const Cod &tc = tile_has_cod[(size_t)t] ? tile_cods[(size_t)t] : cod;
    if (tc.transform != 1 || (tc.cbstyle & 0x3F)) return -2;
    // concatenate tile-part payloads
    std::vector<uint8_t> tdata;
    for (auto &pr : tile_parts[(size_t)t])
      tdata.insert(tdata.end(), data + pr.first, data + pr.second);

    long long txi = t % ntx, tyi = t / ntx;
    long long tx0 = std::max(xto + txi * xts, xo), ty0 = std::max(yto + tyi * yts, yo);
    long long tx1 = std::min(xto + (txi + 1) * xts, xs), ty1 = std::min(yto + (tyi + 1) * yts, ys);
    int levels = tc.levels;
    int nres = levels + 1;

    // per (comp, res, band): grids, trees, states, coeff buffers
    struct BandInfo {
      long long bx0, by0, bx1, by1; int ncbx, ncby; int bandtype; int lev;
      TagTree incl, zbp;
      std::vector<CbState> cbs;
      std::vector<int64_t> coeff;
    };
    // bands per res: res0 -> 1 (LL), else 3
    std::vector<std::vector<BandInfo>> bands((size_t)ncomp * nres);
    auto bidx = [&](int c, int r) { return (size_t)c * nres + r; };
    for (int c = 0; c < ncomp; c++)
      for (int r = 0; r < nres; r++) {
        int nb = r == 0 ? 1 : 3;
        auto &vec = bands[bidx(c, r)];
        vec.resize(nb);
        for (int bi = 0; bi < nb; bi++) {
          BandInfo &B = vec[bi];
          int lev = r == 0 ? levels : levels - r + 1;
          int xob = 0, yob = 0, bt = 0;
          if (r > 0) {
            if (bi == 0) { xob = 1; yob = 0; bt = 1; }        // HL
            else if (bi == 1) { xob = 0; yob = 1; bt = 0; }   // LH
            else { xob = 1; yob = 1; bt = 2; }                // HH
          }
          B.lev = lev; B.bandtype = bt;
          band_rect(tx0, ty0, tx1, ty1, lev, xob, yob, B.bx0, B.by0, B.bx1, B.by1);
          long long bw = B.bx1 - B.bx0, bh = B.by1 - B.by0;
          if (bw > 0 && bh > 0) {
            B.ncbx = (int)((B.bx1 + tc.cbw - 1) / tc.cbw - B.bx0 / tc.cbw);
            B.ncby = (int)((B.by1 + tc.cbh - 1) / tc.cbh - B.by0 / tc.cbh);
          } else { B.ncbx = B.ncby = 0; }
          if (B.ncbx && B.ncby) {
            B.incl.init(B.ncbx, B.ncby);
            B.zbp.init(B.ncbx, B.ncby);
            B.cbs.resize((size_t)B.ncbx * B.ncby);
          }
          B.coeff.assign((size_t)std::max(bw, 0LL) * std::max(bh, 0LL), 0);
        }
      }

    // tier-2 packet walk
    long long p = 0;
    auto read_packet = [&](int c, int r, int layer) -> int {
      if (tc.sop && p + 2 <= (long long)tdata.size() &&
          tdata[p] == 0xFF && tdata[p + 1] == 0x91) p += 6;
      if (p >= (long long)tdata.size()) return -1;
      j2k::BitReader br; br.init(tdata.data(), p, (long long)tdata.size());
      if (!br.bit()) {
        br.align(); p = br.pos;
        if (tc.eph && p + 2 <= (long long)tdata.size() &&
            tdata[p] == 0xFF && tdata[p + 1] == 0x92) p += 2;
        return 0;
      }
      struct Sched { BandInfo *B; int cy, cx, np; long long nbytes; };
      std::vector<Sched> sched;
      for (auto &B : bands[bidx(c, r)]) {
        if (!B.ncbx || !B.ncby) continue;
        for (int cy = 0; cy < B.ncby; cy++)
          for (int cx = 0; cx < B.ncbx; cx++) {
            CbState &st = B.cbs[(size_t)cy * B.ncbx + cx];
            bool inc;
            if (!st.included) inc = B.incl.decode(br, cx, cy, layer + 1);
            else inc = br.bit();
            if (!inc) continue;
            if (!st.included) {
              B.zbp.get(br, cx, cy);
              st.included = true;
            }
            int np_;
            if (!br.bit()) np_ = 1;
            else if (!br.bit()) np_ = 2;
            else {
              uint32_t v = br.bits(2);
              if (v < 3) np_ = 3 + v;
              else {
                v = br.bits(5);
                if (v < 31) np_ = 6 + v;
                else np_ = 37 + br.bits(7);
              }
            }
            while (br.bit()) st.lblock++;
            int nbits = st.lblock;
            for (int q = np_; q > 1; q >>= 1) nbits++;
            long long nbytes = br.bits(nbits);
            sched.push_back({&B, cy, cx, np_, nbytes});
          }
      }
      br.align(); p = br.pos;
      if (tc.eph && p + 2 <= (long long)tdata.size() &&
          tdata[p] == 0xFF && tdata[p + 1] == 0x92) p += 2;
      for (auto &s : sched) {
        if (p + s.nbytes > (long long)tdata.size()) return -1;
        CbState &st = s.B->cbs[(size_t)s.cy * s.B->ncbx + s.cx];
        st.seg.insert(st.seg.end(), tdata.data() + p, tdata.data() + p + s.nbytes);
        st.passes += s.np;
        p += s.nbytes;
      }
      return 0;
    };
    // with one precinct per res, all supported orders iterate (layer, r, c)
    if (tc.prog == 0 || tc.prog == 1) {
      for (int l = 0; l < tc.layers; l++)
        for (int r = 0; r < nres; r++)
          for (int c = 0; c < ncomp; c++)
            if (read_packet(c, r, l)) return -1;
    } else if (tc.prog == 2) {
      for (int r = 0; r < nres; r++)
        for (int c = 0; c < ncomp; c++)
          for (int l = 0; l < tc.layers; l++)
            if (read_packet(c, r, l)) return -1;
    } else {
      for (int c = 0; c < ncomp; c++)
        for (int r = 0; r < nres; r++)
          for (int l = 0; l < tc.layers; l++)
            if (read_packet(c, r, l)) return -1;
    }

    // tier-1
    for (int c = 0; c < ncomp; c++)
      for (int r = 0; r < nres; r++)
        for (auto &B : bands[bidx(c, r)]) {
          long long bw = B.bx1 - B.bx0;
          for (int cy = 0; cy < B.ncby; cy++)
            for (int cx = 0; cx < B.ncbx; cx++) {
              CbState &st = B.cbs[(size_t)cy * B.ncbx + cx];
              if (!st.included || !st.passes) continue;
              long long gx0 = (B.bx0 / tc.cbw + cx) * (long long)tc.cbw;
              long long gy0 = (B.by0 / tc.cbh + cy) * (long long)tc.cbh;
              long long x0 = std::max(gx0, B.bx0), x1 = std::min(gx0 + tc.cbw, B.bx1);
              long long y0 = std::max(gy0, B.by0), y1 = std::min(gy0 + tc.cbh, B.by1);
              Block blk;
              blk.init((int)(x1 - x0), (int)(y1 - y0), B.bandtype,
                       st.seg.data(), (long long)st.seg.size());
              blk.run(st.passes);
              for (long long yy = 0; yy < y1 - y0; yy++)
                for (long long xx = 0; xx < x1 - x0; xx++) {
                  size_t kk = (size_t)yy * blk.w + xx;
                  int64_t v = blk.mag[kk];
                  if (v) {
                    size_t rr = (size_t)(yy + 1) * blk.W2 + (xx + 1);
                    if (blk.sgn[rr] < 0) v = -v;
                  }
                  B.coeff[(size_t)(y0 - B.by0 + yy) * bw + (x0 - B.bx0 + xx)] = v;
                }
            }
        }

    // inverse DWT per component
    for (int c = 0; c < ncomp; c++) {
      std::vector<int64_t> ll = bands[bidx(c, 0)][0].coeff;
      long long llx0 = bands[bidx(c, 0)][0].bx0, lly0 = bands[bidx(c, 0)][0].by0;
      long long llx1 = bands[bidx(c, 0)][0].bx1;
      for (int r = 1; r < nres; r++) {
        int lev = levels - r + 1;
        BandInfo &HL = bands[bidx(c, r)][0];
        BandInfo &LH = bands[bidx(c, r)][1];
        BandInfo &HH = bands[bidx(c, r)][2];
        long long d = 1LL << (lev - 1);
        long long rx0 = ceil_div(tx0, d), ry0 = ceil_div(ty0, d);
        long long rx1 = ceil_div(tx1, d), ry1 = ceil_div(ty1, d);
        long long RW = rx1 - rx0, RH = ry1 - ry0;
        std::vector<int64_t> a((size_t)RW * RH, 0);
        // interleave: (y, x) absolute; LL at even/even
        for (long long y = ry0; y < ry1; y++)
          for (long long x = rx0; x < rx1; x++) {
            int64_t v;
            bool ye = (y & 1) == 0, xe = (x & 1) == 0;
            long long hy = y >> 1, hx = x >> 1;
            if (ye && xe) v = ll[(size_t)(hy - lly0) * (llx1 - llx0) + (hx - llx0)];
            else if (ye) v = HL.coeff[(size_t)(hy - HL.by0) * (HL.bx1 - HL.bx0) + (hx - HL.bx0)];
            else if (xe) v = LH.coeff[(size_t)(hy - LH.by0) * (LH.bx1 - LH.bx0) + (hx - LH.bx0)];
            else v = HH.coeff[(size_t)(hy - HH.by0) * (HH.bx1 - HH.bx0) + (hx - HH.bx0)];
            a[(size_t)(y - ry0) * RW + (x - rx0)] = v;
          }
        // horizontal then vertical 1D synthesis
        for (long long y = 0; y < RH; y++) sr_1d_53(a.data() + (size_t)y * RW, rx0, rx1, 1);
        for (long long x = 0; x < RW; x++) sr_1d_53(a.data() + (size_t)x, ry0, ry1, RW);
        ll.swap(a);
        llx0 = rx0; lly0 = ry0; llx1 = rx1;
      }
      // write into dst (interleaved components) with DC shift
      long long tw = tx1 - tx0, th = ty1 - ty0;
      (void)tw;
      for (long long y = 0; y < th; y++)
        for (long long x = 0; x < tx1 - tx0; x++) {
          int64_t v = ll[(size_t)y * (llx1 - llx0) + x];
          // store pre-MCT for now; MCT applied after all comps if needed
          dst[(((size_t)(ty0 - yo + y) * W) + (tx0 - xo + x)) * ncomp + c] = (int32_t)v;
        }
    }
    // inverse RCT (reversible MCT)
    if (tc.mct == 1) {
      if (ncomp < 3) return -1;
      for (long long y = ty0 - yo; y < ty1 - yo; y++)
        for (long long x = tx0 - xo; x < tx1 - xo; x++) {
          int32_t *px = dst + ((size_t)y * W + x) * ncomp;
          int64_t Y = px[0], Cb = px[1], Cr = px[2];
          int64_t G = Y - ((Cb + Cr) >> 2);
          px[0] = (int32_t)(Cr + G);
          px[1] = (int32_t)G;
          px[2] = (int32_t)(Cb + G);
        }
    }
  }

  // DC level shift
  for (int c = 0; c < ncomp; c++) {
    if (is_signed[c]) continue;
    int32_t off = 1 << (depth[c] - 1);
    for (long long i = 0; i < H * W; i++) dst[i * ncomp + c] += off;
  }
  return 0;
}
