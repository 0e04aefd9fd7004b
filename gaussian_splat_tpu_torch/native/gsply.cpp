// Native PLY data-path: multithreaded (de)interleave between row-major vertex
// records and column-major float32 property arrays.
//
// The port's own copy of gaussian_splat_tpu/native/gsply.cpp (same code; the
// port shares no file with the JAX package). C++ counterpart of the original
// viewer's single-threaded PLY loop (its src/ply_loader.cpp:85-130: 10k-row
// chunked reads with a per-value switch). Design differences:
//   * the Python side parses the header and mmaps the payload; this library
//     only does the bandwidth-bound transpose, split across threads
//   * arbitrary property dtypes are converted per-column (the original
//     assumes an all-float32 stride and mis-reads uchar-color files)
//   * no activations are applied here — parameters stay raw/trainable (the
//     original bakes sigmoid/exp at load, its ply_loader.cpp:116-119)
//
// Built by gaussian_splat_tpu_torch/native/__init__.py with
//   g++ -O3 -shared -fPIC -pthread -std=c++17 gsply.cpp -o _build/libgsply-<hash>.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

enum DType : int32_t {
  F32 = 0,
  F64 = 1,
  I8 = 2,
  U8 = 3,
  I16 = 4,
  U16 = 5,
  I32 = 6,
  U32 = 7,
};

inline float load_as_f32(const char* p, int32_t dt) {
  switch (dt) {
    case F32: {
      float v;
      std::memcpy(&v, p, 4);
      return v;
    }
    case F64: {
      double v;
      std::memcpy(&v, p, 8);
      return static_cast<float>(v);
    }
    case I8:
      return static_cast<float>(*reinterpret_cast<const int8_t*>(p));
    case U8:
      return static_cast<float>(*reinterpret_cast<const uint8_t*>(p));
    case I16: {
      int16_t v;
      std::memcpy(&v, p, 2);
      return static_cast<float>(v);
    }
    case U16: {
      uint16_t v;
      std::memcpy(&v, p, 2);
      return static_cast<float>(v);
    }
    case I32: {
      int32_t v;
      std::memcpy(&v, p, 4);
      return static_cast<float>(v);
    }
    case U32: {
      uint32_t v;
      std::memcpy(&v, p, 4);
      return static_cast<float>(v);
    }
  }
  return 0.0f;
}

void run_rows(int64_t n_rows, int n_threads, const std::function<void(int64_t, int64_t)>& fn) {
  if (n_threads <= 1 || n_rows < (1 << 16)) {
    fn(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  int64_t per = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * per;
    int64_t hi = std::min(n_rows, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(fn, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // namespace

extern "C" {

// Deinterleave: src rows of `stride` bytes; for each of n_cols properties with
// byte offset offs[c] and dtype dts[c], write float32 column dsts[c][row].
void gsply_deinterleave(const char* src, int64_t n_rows, int64_t stride,
                        const int64_t* offs, const int32_t* dts, int32_t n_cols,
                        float** dsts, int32_t n_threads) {
  run_rows(n_rows, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      const char* row = src + r * stride;
      for (int32_t c = 0; c < n_cols; ++c) {
        dsts[c][r] = load_as_f32(row + offs[c], dts[c]);
      }
    }
  });
}

// Interleave: write float32 columns srcs[c] into all-float32 rows (the layout
// our writer emits — property float x, y, z, ...).
void gsply_interleave_f32(const float* const* srcs, int64_t n_rows,
                          int32_t n_cols, float* dst, int32_t n_threads) {
  run_rows(n_rows, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t r = lo; r < hi; ++r) {
      float* row = dst + r * n_cols;
      for (int32_t c = 0; c < n_cols; ++c) {
        row[c] = srcs[c][r];
      }
    }
  });
}

}  // extern "C"
