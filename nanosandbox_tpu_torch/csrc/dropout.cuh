// The flash-attention kernels' dropout keep-mask (nanosandbox_tpu/ops/
// attention.py:85-137), shared by flash_attention.cu and
// flash_attention_sm90.cu: murmur3's fmix32 over q_pos * hash_seq_len +
// k_pos (uint32), XORed with a per-(batch*head) stream key from the (6,)
// seed words [seed, b_off, h_off, q_off, k_off, hash_heads]; kept where
// the hash is at or above round(rate * 2^32), bit for bit the Pallas
// kernels' mask.

#pragma once

#include <stdint.h>

namespace nsb {

constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

struct DropoutArgs {
  const long long* seed;  // (6,) words; read only when on
  int on;
  uint32_t threshold;     // keep where fmix32(...) >= threshold
  float scale;            // 1 / (1 - rate), rounded to f32 by the caller
  uint32_t seq_len;       // hash_seq_len
};

struct Dropout {
  static constexpr bool kMay = true;  // attend_f32's dropout branch
  bool on;
  uint32_t mix, q_off, k_off, seq_len, threshold;
  float scale;

  // Whether score element (query i, key j) of this (row, head) is kept.
  __device__ __forceinline__ bool keep(int i, int j) const {
    const uint32_t idx =
        (q_off + static_cast<uint32_t>(i)) * seq_len +
        (k_off + static_cast<uint32_t>(j));
    return fmix32(idx ^ mix) >= threshold;
  }
};

// The per-(call, batch*head) stream key of _dropout_tile_seed; the stream
// id is linearised over the sixth word's global head count (the JAX
// kernels' hash_heads: a head-sharded call holds H of them from the
// head offset seed[2] on), or over this call's H heads when it is 0.
__device__ __forceinline__ Dropout make_dropout(const DropoutArgs& a, int bh,
                                                int H) {
  Dropout d{};
  d.on = a.on != 0;
  if (!d.on) return d;
  const uint32_t s0 = static_cast<uint32_t>(a.seed[0]);
  const uint32_t hash_heads =
      a.seed[5] ? static_cast<uint32_t>(a.seed[5]) : static_cast<uint32_t>(H);
  const uint32_t b =
      static_cast<uint32_t>(bh) / static_cast<uint32_t>(H) +
      static_cast<uint32_t>(a.seed[1]);
  const uint32_t h =
      static_cast<uint32_t>(bh) % static_cast<uint32_t>(H) +
      static_cast<uint32_t>(a.seed[2]);
  d.mix = fmix32(s0 ^ ((b * hash_heads + h) * kGolden));
  d.q_off = static_cast<uint32_t>(a.seed[3]);
  d.k_off = static_cast<uint32_t>(a.seed[4]);
  d.seq_len = a.seq_len;
  d.threshold = a.threshold;
  d.scale = a.scale;
  return d;
}

}  // namespace nsb
