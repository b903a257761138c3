// Native batch assembler for the host-streaming data path.
//
// The reference's only native layer was inside the TensorFlow runtime
// (SURVEY.md §2.2); this framework's host-side hot loop — assembling a
// batch by gathering N rows from a large uint8 array into one contiguous
// buffer to hand to device DMA — is the one CPU-bound inner loop worth
// native code. numpy fancy indexing does the same work single-threaded
// with an interpreter round-trip per call; this does a tight memcpy loop,
// fanned out across threads for large batches.
//
// Built as a plain shared library (no pybind11) at first use and loaded
// via ctypes from triplegan_tpu_torch/data/native.py; a failed build
// raises with the compiler's output (there is no numpy fallback).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Gather rows: dst[i] = src[idx[i]] for i in [0, n_rows), row_bytes each.
// Negative or out-of-range indices are clamped to [0, src_rows).
void gather_rows_u8(const uint8_t* src, int64_t src_rows, int64_t row_bytes,
                    const int64_t* idx, int64_t n_rows, uint8_t* dst,
                    int32_t n_threads) {
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t j = idx[i];
      if (j < 0) j = 0;
      if (j >= src_rows) j = src_rows - 1;
      std::memcpy(dst + i * row_bytes, src + j * row_bytes,
                  static_cast<size_t>(row_bytes));
    }
  };
  if (n_threads <= 1 || n_rows < 2 * n_threads) {
    work(0, n_rows);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk > n_rows ? n_rows : lo + chunk;
    if (lo >= hi) break;
    threads.emplace_back(work, lo, hi);
  }
  for (auto& th : threads) th.join();
}

}  // extern "C"
