// Host (CPU) batched file reader of dosma_tpu_torch: the port's copy of
// native/dosma_io.cpp, built at first use by core/io/_native.py.
//
// The reference parallelizes DICOM file reading with multiprocessing
// (dosma/core/io/dicom_io.py:264-275) — process pools with
// pickled results. Here a C++ thread pool slurps files straight into
// caller-provided buffers (no GIL, no serialization); element parsing stays
// in Python for fidelity. Loaded via ctypes from
// dosma_tpu_torch/core/io/_native.py.
//
// Build: g++ -O3 -fPIC -std=c++17 -pthread -shared, into
// dosma_tpu_torch/_build/ (core/io/_native.py does it at first use).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <sys/stat.h>
#include <thread>
#include <vector>

extern "C" {

// Fill sizes[i] with the byte size of paths[i]. Returns 0 on success.
int dosma_file_sizes(const char **paths, int n, long long *sizes) {
  int err = 0;
  for (int i = 0; i < n; ++i) {
    struct stat st;
    if (stat(paths[i], &st) != 0) {
      sizes[i] = -1;
      err = 1;
    } else {
      sizes[i] = (long long)st.st_size;
    }
  }
  return err;
}

// Read each paths[i] (sizes[i] bytes) into bufs[i] using a thread pool.
// Returns 0 on success, nonzero if any read failed.
int dosma_read_files(const char **paths, int n, char **bufs, const long long *sizes) {
  std::atomic<int> next(0);
  std::atomic<int> err(0);

  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = (int)(hw ? hw : 2);
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      FILE *f = std::fopen(paths[i], "rb");
      if (!f) {
        err.store(1);
        continue;
      }
      size_t want = (size_t)sizes[i];
      size_t got = std::fread(bufs[i], 1, want, f);
      std::fclose(f);
      if (got != want) err.store(1);
    }
  };

  std::vector<std::thread> threads;
  threads.reserve((size_t)n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto &t : threads) t.join();
  return err.load();
}

// Batched uncompressed pixel-data decode: for n DICOM blobs whose PixelData
// payload starts at offsets[i] with rows*cols uint16 little-endian values,
// copy into out (n, rows, cols) contiguous uint16. Returns 0 on success.
int dosma_decode_pixels_u16(const char **blobs, const long long *offsets, int n,
                            int rows, int cols, uint16_t *out) {
  const size_t plane = (size_t)rows * (size_t)cols;
  std::atomic<int> next(0);
  std::atomic<int> err(0);

  unsigned hw = std::thread::hardware_concurrency();
  int n_threads = (int)(hw ? hw : 2);
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;

  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      if (offsets[i] < 0) {
        err.store(1);
        continue;
      }
      std::memcpy(out + (size_t)i * plane, blobs[i] + offsets[i], plane * sizeof(uint16_t));
    }
  };

  std::vector<std::thread> threads;
  threads.reserve((size_t)n_threads);
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto &t : threads) t.join();
  return err.load();
}

}  // extern "C"
