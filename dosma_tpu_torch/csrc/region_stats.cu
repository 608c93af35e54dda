// Region statistics of a quantitative map under a label mask: for each
// listed label, then for every voxel with mask > 0 (the total), the count,
// float64 mean, population std and exact median of the valid voxels
// (finite and inside the bounds), without a sort.
//
// Replaces no TPU kernel: the JAX package reduces its regions with plain
// jnp / numpy (dosma_tpu/ops/analytics.py, core/quant_vals.py::to_metrics).
// It was added because the port's regional metrics (core/quant_vals.py::
// metric_rows) sorted every region in full to read its median, split the
// regions with nonzero and boolean masks, and made the host wait at each of
// those: on the card that was CUB's radix sort, a select pass, index gathers
// and one host wait a region. The plain PyTorch version of the same passes,
// which the CPU tests and chip_smoke.py hold this kernel against, is
// dosma_tpu_torch/ops/analytics.py::region_stats_reference.
//
// What bounds it on an H100: bytes. Each pass over the map reads the map and
// the mask once (16.7M float32 voxels and a uint8 mask: 83.9 MB, 25 us at
// 3.35 TB/s); a float32 map takes three such passes (a float64 map six), the
// one-block select kernels between them read a few hundred KB. Measured on
// an NVIDIA H100 80GB HBM3 at a 700 W power limit at that size with two
// labels over 11.1M voxels: 0.32 ms for the chain, the passes 74, 110 and
// 76 us, the selects 10-16 us each (calls back to back; chip_smoke.py
// phase 4 times one call with its launches, 0.41 ms). The design:
//   - the median of a region is the element of rank (n-1)/2 and n/2 in
//     the order of its values. Each valid value becomes an integer key
//     whose unsigned order is the float order (the sign bit flipped for a
//     positive value, every bit for a negative one), and the two ranks are
//     found by radix selection over the key's digits, most significant
//     first: 11 bits, 11 bits, then the rest (32-bit keys: 11, 11, 10; 64-bit:
//     11 x 5, 9). A pass histograms the digit of the keys that share the
//     digits chosen so far; a one-block kernel (select_kernel) scans the
//     histogram, keeps the bucket that holds the rank, and subtracts the
//     counts below it. After the last digit the rank's key, and so its
//     value, is exact: the median is the same element a sort gives;
//   - pass 0 tests validity, finds the voxel's slot (its listed label, or
//     "other" for a masked voxel no listed label matches) and histograms the
//     first digit by slot; each block adds its slots' counts, and their sum
//     (the total), to the global histogram. It also sums the values: the
//     total in a register a thread, each label in a row a warp. Pass 1 sums
//     the squared deviations from the means that the first select computed,
//     and histograms the second digit for the targets (region, rank). Later
//     passes only histogram. While a region's two ranks share their chosen
//     digits, the second rank reads the first rank's histogram;
//   - histograms count in shared memory (integer atomics; a warp-level
//     match of equal bins before the atomic was measured slower) and are
//     added to the global histogram once a block; where they do not fit in
//     kSmemCap bytes (many labels), the passes count in global memory.
//     Blocks of 512 threads keep 2048 threads an SM when a pass's
//     histograms take 48 KB (256-thread blocks: 11% slower);
//   - a select kernel is one block of 8 warps, a warp a target, each lane a
//     run of bins read with its loads in flight together;
//   - the float64 sums use no atomics: a thread adds its own voxels in
//     order, a warp reduces a label's values with a fixed butterfly, each
//     block writes its partial sums, and the select kernel reduces those
//     partials in a fixed order. Two calls give the same bits;
//   - the host launches the whole chain on the stream and waits for
//     nothing; the caller reads the (regions, 4) result back once.
//
// Built with -fmad=false (ops/_build.py), like the other kernels: the
// squared deviations are rounded product by product, as in the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;  // see "Blocks of 512 threads" above
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kTile = kThreads * kUnroll;  // voxels a block reads per step
constexpr int kMaxBlocks = 1024;
constexpr int kDigitBits = 11;
constexpr int kBins = 1 << kDigitBits;
constexpr int kMaxLabels = 128;
constexpr int kSelectThreads = 256;
constexpr size_t kSmemCap = 100 * 1024;  // histograms beyond this count in global memory
constexpr unsigned kFull = 0xffffffffu;

enum MaskCode { kNoMask = 0, kU8, kU16, kI16, kU32, kI32, kI64, kF32, kF64 };

struct Params {
  long long n;
  int nlabels;
  int has_bounds, lower_closed, upper_closed;
  double lower, upper;
  long long labels[kMaxLabels];
};

// Positions in the one workspace allocation; regions = nlabels + 1 (the
// labels, then the total), targets = 2 regions (ranks (n-1)/2 and n/2).
struct Work {
  unsigned long long* hist0;   // [regions + 1][kBins]: the first digit; the labels, the
                               // total, then masked voxels of no listed label
  unsigned long long* hist;    // [targets][kBins]: a later digit
  unsigned long long* prefix;  // [targets]: the digits chosen so far
  unsigned long long* rank;    // [targets]: the rank inside those digits
  unsigned long long* count;   // [regions]
  double* mean;                // [regions]
  double* sum;                 // [blocks][regions]: pass 0's partial sums
  double* dev;                 // [blocks][regions]: pass 1's squared deviations
  int* row;                    // [targets]: the histogram a target reads, -1 if empty
};

struct Digit {
  int shift_prev;  // the digits chosen so far are key >> shift_prev
  int shift;       // this digit is (key >> shift) & (2^width - 1)
  int width;
};

template <typename T>
struct Keys;

template <>
struct Keys<float> {
  using U = uint32_t;
  static constexpr int kBits = 32;
  __device__ static U key(float v) {
    const U u = __float_as_uint(v);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  __device__ static double value(unsigned long long k) {
    const U u = (U)k;
    return (double)__uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
  }
};

template <>
struct Keys<double> {
  using U = unsigned long long;
  static constexpr int kBits = 64;
  __device__ static U key(double v) {
    const U u = (U)__double_as_longlong(v);
    return (u >> 63) ? ~u : (u | (1ull << 63));
  }
  __device__ static double value(unsigned long long k) {
    return __longlong_as_double((long long)((k >> 63) ? (k & ~(1ull << 63)) : ~k));
  }
};

// The label test of the torch comparison `mask == label`: an integer mask
// compares as an integer, a floating mask against the label in its own type.
template <typename M>
__device__ __forceinline__ bool same_label(M m, long long label) {
  return (long long)m == label;
}
template <>
__device__ __forceinline__ bool same_label<float>(float m, long long label) {
  return m == (float)label;
}
template <>
__device__ __forceinline__ bool same_label<double>(double m, long long label) {
  return m == (double)label;
}

template <typename M>
struct Mask {
  using Raw = M;
  const M* __restrict__ m;
  __device__ Raw load(long long i) const { return m[i]; }
  // The voxel's slot: its label's index, nlabels for another positive
  // value, -1 outside the mask.
  __device__ int slot(Raw v, int nlabels, const long long* labels) const {
    if (!(v > M(0))) return -1;
    int s = 0;
    while (s < nlabels && !same_label(v, labels[s])) ++s;
    return s;
  }
};

struct Whole {  // no mask: every voxel counts in the total
  using Raw = unsigned char;
  const void* m;
  __device__ Raw load(long long) const { return 1; }
  __device__ int slot(Raw, int nlabels, const long long*) const { return nlabels; }
};

// The validity test: finite and inside the bounds, which torch compares in
// the map's type (converted once a thread).
template <typename T>
struct Validity {
  T lo, hi;
  bool bounded, lower_closed, upper_closed;
  __device__ explicit Validity(const Params& p)
      : lo((T)p.lower), hi((T)p.upper), bounded(p.has_bounds), lower_closed(p.lower_closed),
        upper_closed(p.upper_closed) {}
  __device__ bool operator()(T v) const {
    if (!isfinite(v)) return false;
    if (!bounded) return true;
    const bool above = lower_closed ? v >= lo : v > lo;
    const bool below = upper_closed ? v <= hi : v < hi;
    return above && below;
  }
};

// Adds x of each lane whose slot is a label (s in [0, nlabels)) into its
// warp's row: a lane-ordered butterfly a label present in the warp, the
// sum added by lane 0 (the row's one writer). Every lane of the warp calls it.
__device__ __forceinline__ void add_by_label(int s, double x, int nlabels, double* warp_row) {
  const bool labelled = s >= 0 && s < nlabels;
  unsigned pending = __ballot_sync(kFull, labelled);
  while (pending) {
    const int t = __shfl_sync(kFull, s, __ffs(pending) - 1);
    const bool mine = labelled && s == t;
    double y = mine ? x : 0.0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) y += __shfl_xor_sync(kFull, y, off);
    if ((threadIdx.x & 31) == 0) warp_row[t] += y;
    pending &= ~__ballot_sync(kFull, mine);
  }
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ unsigned long long warp_sum(unsigned long long x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Shared memory of a pass: the warps' label rows, the warps' totals, the
// means, the labels, the targets' prefixes and rows, then (if they fit) the
// histograms.
struct PassSmem {
  size_t warp_rows, warp_totals, mean, labels, prefix, row, hist, bytes;
};

__host__ __device__ inline PassSmem pass_smem(int nlabels, int stage, bool hist_in_smem) {
  const int regions = nlabels + 1, targets = 2 * regions;
  const int rows = stage == 0 ? regions : targets;
  PassSmem s;
  size_t off = 0;
  s.warp_rows = off;
  off += sizeof(double) * kWarps * (nlabels > 0 ? nlabels : 1);
  s.warp_totals = off;
  off += sizeof(double) * kWarps;
  s.mean = off;
  off += sizeof(double) * regions;
  s.labels = off;
  off += sizeof(long long) * nlabels;
  s.prefix = off;
  off += sizeof(unsigned long long) * targets;
  s.row = off;
  off += sizeof(int) * targets;
  off = (off + 15) & ~(size_t)15;
  s.hist = off;
  if (hist_in_smem) off += sizeof(unsigned) * rows * kBins;
  s.bytes = off;
  return s;
}

__host__ __device__ inline bool hist_fits(int nlabels, int stage) {
  return pass_smem(nlabels, stage, true).bytes <= kSmemCap;
}

// One pass over the map and the mask. stage 0: validity, slots, the first
// digit's histogram by slot, the partial sums; stage 1: the squared
// deviations and the second digit's histogram by target; stage 2: a later
// digit's histogram by target.
template <typename T, typename MaskT>
__global__ void __launch_bounds__(kThreads)
    pass_kernel(const T* __restrict__ values, MaskT mask, Params p, Work w, Digit dg, int stage) {
  using K = Keys<T>;
  using U = typename K::U;
  extern __shared__ __align__(16) unsigned char smem[];
  const int L = p.nlabels, regions = L + 1, targets = 2 * regions;
  const bool in_smem = hist_fits(L, stage);
  const PassSmem lay = pass_smem(L, stage, in_smem);
  double* warp_rows = reinterpret_cast<double*>(smem + lay.warp_rows);
  double* warp_totals = reinterpret_cast<double*>(smem + lay.warp_totals);
  double* mean = reinterpret_cast<double*>(smem + lay.mean);
  long long* labels = reinterpret_cast<long long*>(smem + lay.labels);
  unsigned long long* prefix = reinterpret_cast<unsigned long long*>(smem + lay.prefix);
  int* row = reinterpret_cast<int*>(smem + lay.row);
  unsigned* sh_hist = reinterpret_cast<unsigned*>(smem + lay.hist);
  unsigned long long* g_hist = stage == 0 ? w.hist0 : w.hist;
  const int hist_rows = stage == 0 ? regions : targets;
  const int warp = threadIdx.x >> 5;
  double* my_row = warp_rows + warp * (L > 0 ? L : 1);

  for (int i = threadIdx.x; i < kWarps * (L > 0 ? L : 1); i += kThreads) warp_rows[i] = 0.0;
  for (int i = threadIdx.x; i < L; i += kThreads) labels[i] = p.labels[i];
  if (in_smem)
    for (int i = threadIdx.x; i < hist_rows * kBins; i += kThreads) sh_hist[i] = 0u;
  if (stage > 0) {
    for (int i = threadIdx.x; i < regions; i += kThreads) mean[i] = w.mean[i];
    for (int i = threadIdx.x; i < targets; i += kThreads) {
      prefix[i] = w.prefix[i];
      row[i] = w.row[i];
    }
  }
  __syncthreads();

  const U digit_mask = (U)((1u << dg.width) - 1u);
  const Validity<T> valid(p);
  double total = 0.0;
  for (long long base = (long long)blockIdx.x * kTile; base < p.n;
       base += (long long)gridDim.x * kTile) {
    T v[kUnroll];
    typename MaskT::Raw m[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      if (i < p.n) {
        v[k] = values[i];
        m[k] = mask.load(i);
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const long long i = base + k * kThreads + threadIdx.x;
      int s = -1;
      if (i < p.n) {
        s = mask.slot(m[k], L, labels);
        if (s >= 0 && !valid(v[k])) s = -1;
      }
      const U key = s >= 0 ? K::key(v[k]) : (U)0;
      if (stage == 0) {
        const double x = s >= 0 ? (double)v[k] : 0.0;
        if (s >= 0) {
          const int bin = (int)(key >> dg.shift);
          if (in_smem) {
            atomicAdd(sh_hist + s * kBins + bin, 1u);
          } else {
            atomicAdd(g_hist + (size_t)(s < L ? s : L + 1) * kBins + bin, 1ull);
            atomicAdd(g_hist + (size_t)L * kBins + bin, 1ull);
          }
          total += x;
        }
        add_by_label(s, x, L, my_row);
        continue;
      }
      if (stage == 1) {
        const double x = s >= 0 ? (double)v[k] : 0.0;
        double dl = 0.0;
        if (s >= 0) {
          const double dt = x - mean[L];
          total += dt * dt;
          if (s < L) {
            const double d = x - mean[s];
            dl = d * d;
          }
        }
        add_by_label(s, dl, L, my_row);
      }
      if (s < 0) continue;
      const unsigned long long hi = (unsigned long long)(key >> dg.shift_prev);
      const int bin = (int)((key >> dg.shift) & digit_mask);
      // The targets of the voxel's label (if listed) and of the total.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = j < 2 ? (s < L ? 2 * s + j : -1) : 2 * L + (j - 2);
        if (t < 0 || row[t] != t || prefix[t] != hi) continue;
        if (in_smem) atomicAdd(sh_hist + t * kBins + bin, 1u);
        else atomicAdd(g_hist + (size_t)t * kBins + bin, 1ull);
      }
    }
  }

  // The block's totals, in a fixed order.
  total = warp_sum(total);
  if ((threadIdx.x & 31) == 0) warp_totals[warp] = total;
  __syncthreads();
  if (in_smem && stage == 0) {
    // By slot into the labels' rows and the last row; their sum into the total's.
    for (int b = threadIdx.x; b < kBins; b += kThreads) {
      unsigned all = 0;
      for (int s = 0; s <= L; ++s) {
        const unsigned c = sh_hist[s * kBins + b];
        all += c;
        if (c) atomicAdd(g_hist + (size_t)(s < L ? s : L + 1) * kBins + b, (unsigned long long)c);
      }
      if (all) atomicAdd(g_hist + (size_t)L * kBins + b, (unsigned long long)all);
    }
  } else if (in_smem) {
    for (int i = threadIdx.x; i < hist_rows * kBins; i += kThreads) {
      const unsigned c = sh_hist[i];
      if (c) atomicAdd(g_hist + i, (unsigned long long)c);
    }
  }
  if (stage < 2) {
    double* part = (stage == 0 ? w.sum : w.dev) + (size_t)blockIdx.x * regions;
    for (int g = threadIdx.x; g < L; g += kThreads) {
      double acc = 0.0;
      for (int k = 0; k < kWarps; ++k) acc += warp_rows[k * L + g];
      part[g] = acc;
    }
    if (threadIdx.x == 0) {
      double acc = 0.0;
      for (int k = 0; k < kWarps; ++k) acc += warp_totals[k];
      part[L] = acc;
    }
  }
}

// One block: after pass `digit`, each target keeps the bucket of its rank.
// After pass 0 it first computes the counts, the means and the ranks;
// after the last pass it writes the statistics.
template <typename T>
__global__ void __launch_bounds__(kSelectThreads)
    select_kernel(Params p, Work w, Digit dg, int digit, int blocks, int last, double* out) {
  using K = Keys<T>;
  const int L = p.nlabels, regions = L + 1, targets = 2 * regions;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kWarpsHere = kSelectThreads / 32;

  if (digit == 0) {
    for (int g = warp; g < regions; g += kWarpsHere) {
      unsigned long long c = 0;
#pragma unroll 16
      for (int b = lane; b < kBins; b += 32) c += w.hist0[(size_t)g * kBins + b];
      c = warp_sum(c);
      double acc = 0.0;
#pragma unroll 8
      for (int k = lane; k < blocks; k += 32) acc += w.sum[(size_t)k * regions + g];
      acc = warp_sum(acc);
      if (lane == 0) {
        w.count[g] = c;
        w.mean[g] = c ? acc / (double)c : 0.0;
        w.rank[2 * g] = c ? (c - 1) / 2 : 0;
        w.rank[2 * g + 1] = c / 2;
        w.prefix[2 * g] = w.prefix[2 * g + 1] = 0;
        w.row[2 * g] = w.row[2 * g + 1] = c ? g : -1;  // the region's row of hist0
      }
    }
    __syncthreads();
  }

  // A warp a target: each lane owns a run of bins, the warp scans the runs,
  // and the lane whose run holds the rank finds its bin.
  const int nbins = 1 << dg.width, per_lane = nbins / 32;
  for (int t = warp; t < targets; t += kWarpsHere) {
    const int r = w.row[t];
    if (r < 0) continue;
    const unsigned long long* h =
        (digit == 0 ? w.hist0 : w.hist) + (size_t)r * kBins + lane * per_lane;
    unsigned long long run = 0;
#pragma unroll 16
    for (int k = 0; k < per_lane; ++k) run += h[k];
    unsigned long long incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long up = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += up;
    }
    const unsigned long long rank = w.rank[t];
    unsigned long long cum = incl - run;
    if (cum <= rank && rank < incl) {
      int found = 0;
      unsigned long long below = 0;
#pragma unroll 16
      for (int k = 0; k < per_lane; ++k) {  // no early exit: the loads stay in flight together
        if (cum <= rank && rank < cum + h[k]) {
          found = lane * per_lane + k;
          below = cum;
        }
        cum += h[k];
      }
      w.prefix[t] = (w.prefix[t] << dg.width) | (unsigned long long)found;
      w.rank[t] = rank - below;
    }
  }
  __syncthreads();

  // The next pass: a region's second rank reads its first rank's histogram
  // while their digits agree. The later-digit histograms start at zero.
  for (int g = threadIdx.x; g < regions; g += kSelectThreads) {
    if (w.count[g] == 0) continue;
    w.row[2 * g] = 2 * g;
    w.row[2 * g + 1] = w.prefix[2 * g + 1] == w.prefix[2 * g] ? 2 * g : 2 * g + 1;
  }
  for (size_t i = threadIdx.x; i < (size_t)targets * kBins; i += kSelectThreads) w.hist[i] = 0;
  if (!last) return;

  for (int g = warp; g < regions; g += kWarpsHere) {
    double acc = 0.0;
#pragma unroll 8
    for (int k = lane; k < blocks; k += 32) acc += w.dev[(size_t)k * regions + g];
    acc = warp_sum(acc);
    if (lane) continue;
    const unsigned long long n = w.count[g];
    double* o = out + 4 * g;
    o[0] = (double)n;
    if (n == 0) {
      o[1] = o[2] = o[3] = __longlong_as_double(0x7ff8000000000000ll);
      continue;
    }
    const double a = K::value(w.prefix[2 * g]);
    o[1] = w.mean[g];
    o[2] = sqrt(acc / (double)n);
    o[3] = (n & 1) ? a : (a + K::value(w.prefix[2 * g + 1])) / 2.0;
  }
}

int grid_for(long long n) {
  const long long tiles = (n + kTile - 1) / kTile;
  return (int)(tiles < 1 ? 1 : (tiles > kMaxBlocks ? kMaxBlocks : tiles));
}

// Byte offsets of the workspace's arrays.
struct Layout {
  size_t hist0, hist, prefix, rank, count, mean, sum, dev, row, bytes;
};

Layout layout(long long n, int nlabels) {
  const size_t regions = nlabels + 1, targets = 2 * regions, blocks = grid_for(n);
  Layout l;
  size_t off = 0;
  l.hist0 = off;
  off += 8 * (regions + 1) * kBins;
  l.hist = off;
  off += 8 * targets * kBins;
  l.prefix = off;
  off += 8 * targets;
  l.rank = off;
  off += 8 * targets;
  l.count = off;
  off += 8 * regions;
  l.mean = off;
  off += 8 * regions;
  l.sum = off;
  off += 8 * blocks * regions;
  l.dev = off;
  off += 8 * blocks * regions;
  l.row = off;
  off += 4 * targets;
  l.bytes = off;
  return l;
}

template <typename T, typename MaskT>
int launch_chain(const T* values, MaskT mask, const Params& p, void* workspace, double* out,
                 cudaStream_t st) {
  const Layout l = layout(p.n, p.nlabels);
  unsigned char* base = static_cast<unsigned char*>(workspace);
  Work w;
  w.hist0 = reinterpret_cast<unsigned long long*>(base + l.hist0);
  w.hist = reinterpret_cast<unsigned long long*>(base + l.hist);
  w.prefix = reinterpret_cast<unsigned long long*>(base + l.prefix);
  w.rank = reinterpret_cast<unsigned long long*>(base + l.rank);
  w.count = reinterpret_cast<unsigned long long*>(base + l.count);
  w.mean = reinterpret_cast<double*>(base + l.mean);
  w.sum = reinterpret_cast<double*>(base + l.sum);
  w.dev = reinterpret_cast<double*>(base + l.dev);
  w.row = reinterpret_cast<int*>(base + l.row);
  const int blocks = grid_for(p.n);

  cudaError_t err = cudaMemsetAsync(w.hist0, 0, l.hist - l.hist0, st);
  if (err != cudaSuccess) return (int)err;
  constexpr int kBitsKey = Keys<T>::kBits;
  Digit dg{kBitsKey, kBitsKey - kDigitBits, kDigitBits};
  for (int digit = 0; dg.width > 0; ++digit) {
    const int stage = digit == 0 ? 0 : (digit == 1 ? 1 : 2);
    const size_t smem = pass_smem(p.nlabels, stage, hist_fits(p.nlabels, stage)).bytes;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(pass_kernel<T, MaskT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    pass_kernel<T, MaskT><<<blocks, kThreads, smem, st>>>(values, mask, p, w, dg, stage);
    const int next_shift = dg.shift > kDigitBits ? dg.shift - kDigitBits : 0;
    const int last = dg.shift == 0;
    select_kernel<T><<<1, kSelectThreads, 0, st>>>(p, w, dg, digit, blocks, last, out);
    dg = Digit{dg.shift, next_shift, dg.shift - next_shift};
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_mask(const T* values, const void* mask, int mask_code, const Params& p,
                  void* workspace, double* out, cudaStream_t st) {
  switch (mask_code) {
    case kNoMask: return launch_chain(values, Whole{mask}, p, workspace, out, st);
    case kU8: return launch_chain(values, Mask<uint8_t>{(const uint8_t*)mask}, p, workspace, out, st);
    case kU16: return launch_chain(values, Mask<uint16_t>{(const uint16_t*)mask}, p, workspace, out, st);
    case kI16: return launch_chain(values, Mask<int16_t>{(const int16_t*)mask}, p, workspace, out, st);
    case kU32: return launch_chain(values, Mask<uint32_t>{(const uint32_t*)mask}, p, workspace, out, st);
    case kI32: return launch_chain(values, Mask<int32_t>{(const int32_t*)mask}, p, workspace, out, st);
    case kI64: return launch_chain(values, Mask<long long>{(const long long*)mask}, p, workspace, out, st);
    case kF32: return launch_chain(values, Mask<float>{(const float*)mask}, p, workspace, out, st);
    case kF64: return launch_chain(values, Mask<double>{(const double*)mask}, p, workspace, out, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Bytes of the workspace a call over n voxels and nlabels labels needs.
extern "C" long long dosma_region_stats_workspace(long long n, int nlabels) {
  return (long long)layout(n, nlabels).bytes;
}

// values: n float32 (value_code 0) or float64 (1); mask: n values of the
// MaskCode type, or none; labels: nlabels host integers; out: (nlabels + 1)
// x 4 float64 on the card: count, mean, std, median, the total last.
extern "C" int dosma_region_stats(const void* values, int value_code, const void* mask,
                                  int mask_code, long long n, int nlabels,
                                  const long long* labels, int has_bounds, double lower,
                                  double upper, int lower_closed, int upper_closed,
                                  void* workspace, double* out, void* stream) {
  if (nlabels < 0 || nlabels > kMaxLabels || n < 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.n = n;
  p.nlabels = nlabels;
  p.has_bounds = has_bounds;
  p.lower_closed = lower_closed;
  p.upper_closed = upper_closed;
  p.lower = lower;
  p.upper = upper;
  for (int i = 0; i < kMaxLabels; ++i) p.labels[i] = i < nlabels ? labels[i] : 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (value_code == 0)
    return dispatch_mask(static_cast<const float*>(values), mask, mask_code, p, workspace, out, st);
  if (value_code == 1)
    return dispatch_mask(static_cast<const double*>(values), mask, mask_code, p, workspace, out, st);
  return (int)cudaErrorInvalidValue;
}
