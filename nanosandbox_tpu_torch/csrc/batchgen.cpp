// Native batch gather for the memmap data loader (data/loader.py).
//
// nanoGPT's get_batch samples random-offset (block_size+1)-token windows
// from a uint16 memmap on the host every step. Here the offsets come from
// an xorshift128+ sampler seeded by splitmix64 from (seed, stream), and the
// windows are copied row by row into one contiguous buffer, so neither
// step round-trips through Python per element. The sampler draws the same
// offsets as the JAX package's csrc/batchgen.cpp, bit for bit.
//
// Built by nanosandbox_tpu_torch/utils/native.py with g++ at first use and
// bound with ctypes over the extern "C" surface. No OpenMP: a batch is a
// few dozen memcpy calls, and a second OpenMP runtime beside torch's in
// one process is not worth them.

#include <cstdint>
#include <cstring>

extern "C" {

// Copy B windows of `width` uint16 tokens starting at offsets[b] into out
// (shape [B, width], contiguous). Offsets are clamped into the data.
void gather_windows_u16(const uint16_t* data, int64_t n_tokens,
                        const int64_t* offsets, int64_t batch, int64_t width,
                        uint16_t* out) {
  for (int64_t b = 0; b < batch; ++b) {
    int64_t off = offsets[b];
    if (off < 0) off = 0;
    if (off + width > n_tokens) off = n_tokens - width;
    std::memcpy(out + b * width, data + off,
                static_cast<size_t>(width) * sizeof(uint16_t));
  }
}

// xorshift128+ offset sampler: fills offsets[0..batch) with values in
// [0, n_tokens - width]. Deterministic in (seed, stream).
void sample_offsets(uint64_t seed, uint64_t stream, int64_t n_tokens,
                    int64_t width, int64_t batch, int64_t* offsets) {
  uint64_t z = seed + 0x9E3779B97F4A7C15ULL * (stream + 1);
  auto splitmix = [&z]() {
    z += 0x9E3779B97F4A7C15ULL;
    uint64_t x = z;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
  };
  uint64_t s0 = splitmix(), s1 = splitmix();
  const uint64_t range = static_cast<uint64_t>(n_tokens - width + 1);
  for (int64_t b = 0; b < batch; ++b) {
    uint64_t x = s0, y = s1;
    s0 = y;
    x ^= x << 23;
    s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    offsets[b] = static_cast<int64_t>((s1 + y) % range);
  }
}

}  // extern "C"
