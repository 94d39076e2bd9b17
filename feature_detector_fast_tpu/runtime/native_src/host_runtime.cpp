// Native host runtime for the serving path.
//
// The device side of a detection emits a compact (word_index, word_bits)
// encoding of the keypoint set (ops/compact.py); turning that into the
// user-facing (x, y) keypoint list is host work on the serving critical
// path.  The reference keeps its host-side result handling native too
// (main.rs:4-15 write_keypoints / util.rs draw loop); this is the
// framework's analogue: a bit-scan expansion loop (ctz + clear-lowest
// -bit) instead of numpy's materialized (n_words, 32) bit matrix, plus a
// std::thread fan-out over the frames of a batch.
//
// Exposed via ctypes (see runtime/native.py); pure C ABI, no deps.

#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Expand one frame's packed words into (x, y) uint32 pairs.
//
// word_idx / word_bits: max_words entries; entries with word_bits == 0
// are padding and skipped (matching ops.compact's fill convention).
// Emission order is row-major (ascending flat index) because word_idx is
// ascending and bits are scanned LSB-first — identical to
// ops.compact.expand_words_host and the reference's push order
// (fast_simd.rs:550).
//
// out_xy must hold 2 * out_cap uint32s.  Returns the number of keypoints
// written, or -1 if the true count exceeds out_cap (nothing is written
// beyond the cap; callers retry with a bigger buffer).
int64_t fdf_expand_words(const int32_t* word_idx, const uint32_t* word_bits,
                         int32_t max_words, int32_t width, int64_t out_cap,
                         uint32_t* out_xy) {
  int64_t n = 0;
  for (int32_t i = 0; i < max_words; ++i) {
    uint32_t bits = word_bits[i];
    if (!bits) continue;
    const int64_t base = static_cast<int64_t>(word_idx[i]) * 32;
    while (bits) {
      const int bit = __builtin_ctz(bits);
      bits &= bits - 1;
      if (n >= out_cap) return -1;
      const int64_t flat = base + bit;
      out_xy[2 * n] = static_cast<uint32_t>(flat % width);
      out_xy[2 * n + 1] = static_cast<uint32_t>(flat / width);
      ++n;
    }
  }
  return n;
}

// Batched expansion: `batch` frames stored contiguously — frame f's words
// at word_idx + f*max_words (same for bits), its output at
// out_xy + f*2*per_frame_cap, its count into out_counts[f].  Frames fan
// out over up to `threads` std::threads (the per-frame loops are
// independent).  Any frame overflowing per_frame_cap reports -1 in its
// slot; other frames are unaffected.
void fdf_expand_words_batch(const int32_t* word_idx, const uint32_t* word_bits,
                            int32_t batch, int32_t max_words, int32_t width,
                            int64_t per_frame_cap, uint32_t* out_xy,
                            int64_t* out_counts, int32_t threads) {
  if (threads < 1) threads = 1;
  if (threads > batch) threads = batch;
  auto work = [&](int32_t t) {
    for (int32_t f = t; f < batch; f += threads) {
      out_counts[f] = fdf_expand_words(
          word_idx + static_cast<int64_t>(f) * max_words,
          word_bits + static_cast<int64_t>(f) * max_words, max_words, width,
          per_frame_cap, out_xy + static_cast<int64_t>(f) * 2 * per_frame_cap);
    }
  };
  if (threads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int32_t t = 0; t < threads; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
}

// Superword variant (ops/compact.py superword encoding): entry i covers
// `span` consecutive 32-pixel words starting at word super_idx[i]*span,
// with its word bits stored contiguously at super_bits + i*span.  Padding
// entries have all-zero bit rows and are skipped.  Emission order stays
// row-major: super indices ascend, words within a span ascend, bits scan
// LSB-first.
int64_t fdf_expand_supers(const int32_t* super_idx, const uint32_t* super_bits,
                          int32_t max_supers, int32_t span, int32_t width,
                          int64_t out_cap, uint32_t* out_xy) {
  int64_t n = 0;
  for (int32_t i = 0; i < max_supers; ++i) {
    const uint32_t* row = super_bits + static_cast<int64_t>(i) * span;
    const int64_t word0 = static_cast<int64_t>(super_idx[i]) * span;
    for (int32_t j = 0; j < span; ++j) {
      uint32_t bits = row[j];
      if (!bits) continue;
      const int64_t base = (word0 + j) * 32;
      while (bits) {
        const int bit = __builtin_ctz(bits);
        bits &= bits - 1;
        if (n >= out_cap) return -1;
        const int64_t flat = base + bit;
        out_xy[2 * n] = static_cast<uint32_t>(flat % width);
        out_xy[2 * n + 1] = static_cast<uint32_t>(flat / width);
        ++n;
      }
    }
  }
  return n;
}

// Batched superword expansion; same fan-out scheme as
// fdf_expand_words_batch.  Frame f's indices at super_idx + f*max_supers,
// its bits at super_bits + f*max_supers*span.
void fdf_expand_supers_batch(const int32_t* super_idx,
                             const uint32_t* super_bits, int32_t batch,
                             int32_t max_supers, int32_t span, int32_t width,
                             int64_t per_frame_cap, uint32_t* out_xy,
                             int64_t* out_counts, int32_t threads) {
  if (threads < 1) threads = 1;
  if (threads > batch) threads = batch;
  auto work = [&](int32_t t) {
    for (int32_t f = t; f < batch; f += threads) {
      out_counts[f] = fdf_expand_supers(
          super_idx + static_cast<int64_t>(f) * max_supers,
          super_bits + static_cast<int64_t>(f) * max_supers * span, max_supers,
          span, width, per_frame_cap,
          out_xy + static_cast<int64_t>(f) * 2 * per_frame_cap);
    }
  };
  if (threads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int32_t t = 0; t < threads; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
}

}  // extern "C"
