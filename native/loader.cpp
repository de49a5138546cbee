// Native batch assembler for the packed point-cloud dataset.
//
// Native replacement for the reference's host-bound input path
// (reference provider.py:85-136 does per-sample JSON+npy reads and a
// numpy random resample inside the training loop). Here the dataset is
// already packed into flat ragged arrays (alignnet3d_tpu/data/provider.py);
// this library performs the per-batch work — N-with-replacement resampling
// and the gather into the (B, N, 3) staging buffer — in one pass with a
// counter-based PRNG, no temporaries, no GIL.
//
// Exposed via ctypes (no pybind11 in this image). Build: see
// native/build.sh / Makefile.

#include <cstdint>
#include <cstring>

namespace {

// splitmix64: tiny, statistically solid counter-based PRNG.
static inline uint64_t splitmix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ULL;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

// For each of B samples: draw num_points indices uniformly (with
// replacement) from [0, counts[row]) and gather xyz triples from
// points_flat starting at offsets[row] into out[b]. Empty clouds yield
// zeros (reference provider.py:95-96).
//
// points_flat: (total_points, 3) float32
// offsets/counts: per-row int64 (indexed by rows[b])
// rows: (B,) int64 packed-row numbers
// out: (B, num_points, 3) float32, caller-allocated
void resample_gather(const float* points_flat, const int64_t* offsets,
                     const int64_t* counts, const int64_t* rows,
                     int64_t batch, int64_t num_points, uint64_t seed,
                     float* out) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t row = rows[b];
    const int64_t count = counts[row];
    float* dst = out + b * num_points * 3;
    if (count <= 0) {
      std::memset(dst, 0, sizeof(float) * num_points * 3);
      continue;
    }
    const float* src = points_flat + offsets[row] * 3;
    // per-sample stream base, decorrelated via a full mix so streams of
    // neighboring (b, row) pairs don't overlap counter ranges
    const uint64_t ctr = splitmix64(
        seed ^ splitmix64((static_cast<uint64_t>(row) << 32) ^
                          static_cast<uint64_t>(b) ^ 0xA5A5A5A5DEADBEEFULL));
    for (int64_t i = 0; i < num_points; ++i) {
      const uint64_t r = splitmix64(ctr + static_cast<uint64_t>(i));
      // unbiased-enough 64-bit multiply-shift range reduction
      const uint64_t pick =
          static_cast<uint64_t>((static_cast<unsigned __int128>(r) *
                                 static_cast<unsigned __int128>(count)) >>
                                64);
      const float* p = src + pick * 3;
      dst[i * 3 + 0] = p[0];
      dst[i * 3 + 1] = p[1];
      dst[i * 3 + 2] = p[2];
    }
  }
}

// Gather label rows: out[b] = labels[rows[b]] for a (n_rows, dim) float64
// label matrix.
void gather_labels(const double* labels, const int64_t* rows, int64_t batch,
                   int64_t dim, double* out) {
  for (int64_t b = 0; b < batch; ++b) {
    std::memcpy(out + b * dim, labels + rows[b] * dim,
                sizeof(double) * dim);
  }
}

int loader_abi_version() { return 1; }

}  // extern "C"
