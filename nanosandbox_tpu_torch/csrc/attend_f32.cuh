// The f32 tile loop shared by the CUDA-core attention kernels, for Hopper
// (sm_90a): the paged prefill under an fp32 query or over an fp32 pool
// (K1, paged_prefill_f32_kernel in paged_attention.cu) and the fp32 flash
// forward (K4, flash_fwd_f32_kernel in flash_attention.cu). Both are
// causal attention of a block of queries over the keys at or before them;
// they differ only in where a key position's row lives (an addressing
// policy: a block-table chain for K1, contiguous rows for K4) and in two
// compile-time options (dropout on the p.v sum and the lse store, K4's).
//
// Every product is an exact f32 fmaf: an fp32 query is held to 1e-5 of
// the plain version, which bf16 or TF32 products would not meet. What
// bounds the loop is the f32 FMA rate of the CUDA cores (67 TFLOP/s) and
// the shared-memory reads that feed it. The design:
//   - a block owns kBQ queries (32 or 64) of one (row, head), with 4 kBQ
//     threads; Q stays resident as f32 rows padded by 4 floats;
//   - kKC-position K/V tiles (64, or 32 at D 128 so two blocks share an
//     SM) stream through a two-stage cp.async ring, each 16-byte piece of
//     a stored row addressed through the policy, positions past the
//     tile's last visible key zero-filled by the copy; an f32 tile lands
//     as rows padded by 4 floats, a bf16, int8 or int4 one as its stored
//     bytes (and scales), widened to such rows (exact) with the next tile
//     in flight;
//   - a kTY x 16 grid of threads: thread (ty, tx) owns queries ty + kTY a
//     and keys tx + 16 b of the score tile, read as float4 four deep along
//     D; the online softmax runs in registers (a row's max and sum over
//     its 16 lanes); p goes to shared memory once per tile in rows padded
//     by 16 floats (a warp's two rows 16 banks apart), and p.v gives the
//     thread the same queries and the D/16 output columns from tx D/16,
//     read as float4;
//   - only tiles that cross the diagonal or the tail compare positions.
// The numerics are the Pallas kernels': s = (q . k) * k_scale * sm_scale
// in f32 after the product; l sums the unmasked, unscaled p; p * v_scale
// (dropped and rescaled, under dropout) feeds p.v in f32.

#pragma once

#include <type_traits>

#include "decode_common.cuh"
#include "mma_common.cuh"

namespace nsb {

// Shared memory and thread shape of one instance: kBQ queries a block, 32
// or 64, with 4 kBQ threads. 4 x 4 micro-tiles; 8 x 4 with half the
// threads measured 6-51% slower (PERF.md, section 6).
template <typename TKV, int D, int kBQ_>
struct TilesF32 {
  using L = KV<TKV>;
  static constexpr int kBQ = kBQ_;
  static constexpr int kThreads = 4 * kBQ;
  // Key positions a tile: 32 at D 128, so two blocks still share an SM.
  static constexpr int kKC = D == 128 ? 32 : 64;
  static constexpr int kTY = kThreads / 16;  // rows of the thread grid
  static constexpr int kQR = kBQ / kTY;  // queries a thread: ty + kTY a
  static constexpr int kKB = kKC / 16;  // keys a thread: tx + 16b
  static constexpr int kCW = D / 16;    // output columns a thread
  static constexpr int kDR = D + 4;     // padded row of Q, K, V (floats)
  static constexpr int kPR = kKC + 16;  // padded row of p
  static constexpr bool kQuant = L::kQuant;
  static constexpr bool kWiden = !std::is_same<TKV, float>::value;
  static constexpr int kRowBytes =
      D * static_cast<int>(sizeof(typename L::S)) / L::kDiv;
  static constexpr int kPieces = kRowBytes / 16;  // 16-byte pieces a row
  static constexpr uint32_t kQ = kBQ * kDR * 4;
  static constexpr uint32_t kP = kBQ * kPR * 4;
  static constexpr uint32_t kTile = kKC * kDR * 4;     // f32 K or V
  static constexpr uint32_t kRaw = kKC * kRowBytes;    // stored K or V
  static constexpr uint32_t kScales = 2 * kKC * 4;
  // A stage holds a tile as f32 rows (fp32 pool) or as stored bytes and
  // scales, which are widened into the two f32 tiles after p.
  static constexpr uint32_t kStage =
      kWiden ? 2 * kRaw + (kQuant ? kScales : 0) : 2 * kTile;
  static constexpr size_t kSmem =
      kQ + kP + (kWiden ? 2 * kTile : 0) + 2 * kStage;
  static_assert(kRowBytes % 16 == 0, "whole 16-byte pieces a row");
};

// Four consecutive stored values at src widened to f32 (exact).
template <typename TKV>
__device__ __forceinline__ float4 widen4(const unsigned char* src) {
  if constexpr (std::is_same<TKV, __nv_bfloat16>::value) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&x.y));
    return make_float4(a.x, a.y, b.x, b.y);
  } else if constexpr (std::is_same<TKV, int8_t>::value) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(src);
    return make_float4(sbyte(x, 0), sbyte(x, 1), sbyte(x, 2), sbyte(x, 3));
  } else {
    // Two bytes of packed int4: dim 2j in the low nibble, each biased by 8.
    const uint32_t x = *reinterpret_cast<const uint16_t*>(src);
    return make_float4(static_cast<float>(static_cast<int>(x & 15) - 8),
                       static_cast<float>(static_cast<int>((x >> 4) & 15) - 8),
                       static_cast<float>(static_cast<int>((x >> 8) & 15) - 8),
                       static_cast<float>(static_cast<int>(x >> 12) - 8));
  }
}

// Addressing policies: the pool row (of kRowBytes bytes, and its scales)
// holding key position pos of the block's (row, head).
struct ChainRows {  // K1: through row b's block table (PagedChain)
  PagedChain chain;
  int b, h;
  __device__ __forceinline__ int64_t row(int pos) const {
    return chain.base(b, h, pos / chain.page) + pos % chain.page;
  }
};
struct ContigRows {  // K4: (B*H, T, D) rows, this (row, head)'s from base
  int64_t base;
  __device__ __forceinline__ int64_t row(int pos) const { return base + pos; }
};

// No dropout (K1); K4 passes its Dropout, whose kMay is true.
struct NoDropout {
  static constexpr bool kMay = false;
  bool on = false;
  float scale = 1.f;
  __device__ __forceinline__ bool keep(int, int) const { return true; }
};

// The loop of one block: queries q0 .. q0 + kBQ - 1 of (row, head) bh,
// over q and out of (B*H, T, D), the first at key position first_qpos;
// keys [0, kv_end) are visible to some query of the block. Writes out and,
// with kLse, lse (B*H, T) in natural log.
template <typename TQ, typename TKV, int D, int kBQ, bool kLse,
          typename Rows, typename Drop>
__device__ __forceinline__ void attend_f32(
    const TQ* __restrict__ q, const typename KV<TKV>::S* __restrict__ k,
    const typename KV<TKV>::S* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const Rows& rows, int bh, int T, int q0,
    int first_qpos, int kv_end, TQ* __restrict__ out, float* __restrict__ lse,
    float sm_scale, const Drop& dr) {
  using P = TilesF32<TKV, D, kBQ>;
  constexpr bool kQuant = P::kQuant, kWiden = P::kWiden;
  constexpr int kThreads = P::kThreads, kKC = P::kKC;
  constexpr int kTY = P::kTY, kQR = P::kQR, kKB = P::kKB, kCW = P::kCW;
  constexpr int kDR = P::kDR, kPR = P::kPR;
  extern __shared__ __align__(128) unsigned char smem_f32[];
  float* q_s = reinterpret_cast<float*>(smem_f32);
  float* p_s = reinterpret_cast<float*>(smem_f32 + P::kQ);
  float* wide = reinterpret_cast<float*>(smem_f32 + P::kQ + P::kP);
  unsigned char* ring =
      smem_f32 + P::kQ + P::kP + (kWiden ? 2 * P::kTile : 0);

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qbase = static_cast<int64_t>(bh) * T * D;
  const int n_tiles = (kv_end + kKC - 1) / kKC;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);

  // Tile c into ring stage `slot`; positions at or past kv_end are zero.
  auto load_tile = [&](int c, int slot) {
    const uint32_t st = smem_addr(ring + slot * P::kStage);
    const uint32_t v_off = kWiden ? P::kRaw : P::kTile;
    const int c0 = c * kKC;
#pragma unroll 1
    for (int e = threadIdx.x; e < kKC * P::kPieces; e += kThreads) {
      const int r = e / P::kPieces, p = e % P::kPieces, pos = c0 + r;
      const bool in = pos < kv_end;
      const int64_t off = in ? rows.row(pos) * P::kRowBytes + 16 * p : 0;
      const uint32_t dst =
          st + (kWiden ? r * P::kRowBytes + 16 * p : (r * kDR + 4 * p) * 4);
      cp_async16(dst, kb + off, in ? 16 : 0);
      cp_async16(dst + v_off, vb + off, in ? 16 : 0);
    }
    if constexpr (kQuant) {
#pragma unroll 1
      for (int r = threadIdx.x; r < kKC; r += kThreads) {
        const int pos = c0 + r;
        const bool in = pos < kv_end;
        const int64_t row = in ? rows.row(pos) : 0;
        const uint32_t dst = st + 2 * P::kRaw + 4 * r;
        cp_async4(dst, ks + row, in ? 4 : 0);
        cp_async4(dst + 4 * kKC, vs + row, in ? 4 : 0);
      }
    }
  };

  // Q once, as f32 rows padded by 4 floats (zero past T): an fp32 query by
  // cp.async, a bf16 one widened on the way.
  if constexpr (std::is_same<TQ, float>::value) {
    load_rows_f32<kBQ, D, kThreads>(smem_addr(q_s), q + qbase, q0, T);
  } else {
    for (int e = threadIdx.x; e < kBQ * D / 8; e += kThreads) {
      const int r = e / (D / 8), c = 8 * (e % (D / 8));
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (q0 + r < T)
        KV<__nv_bfloat16>::load(q + qbase + static_cast<int64_t>(q0 + r) * D,
                                c, x);
      float* dst = q_s + r * kDR + c;
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
  cp_async_commit();
  load_tile(0, 0);
  cp_async_commit();

  float m[kQR], l[kQR], acc[kQR][kCW];
#pragma unroll
  for (int a = 0; a < kQR; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCW; ++cc) acc[a][cc] = 0.f;
  }

  for (int c = 0; c < n_tiles; ++c) {
    const int c0 = c * kKC;
    if (c + 1 < n_tiles) load_tile(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and tile c have landed
    __syncthreads();
    const unsigned char* st = ring + (c & 1) * P::kStage;
    const float* k_t = reinterpret_cast<const float*>(st);
    const float* ks_c = reinterpret_cast<const float*>(st + 2 * P::kRaw);
    const float* vs_c = ks_c + kKC;
    if constexpr (kWiden) {
      // Stored bytes to f32 tiles; the next tile stays in flight.
      constexpr int kG = D / 4;  // groups of 4 dims a row
#pragma unroll 4
      for (int e = threadIdx.x; e < 2 * kKC * kG; e += kThreads) {
        const int tile = e / (kKC * kG), r = (e / kG) % kKC, g = e % kG;
        *reinterpret_cast<float4*>(wide + tile * (P::kTile / 4) + r * kDR +
                                   4 * g) =
            widen4<TKV>(st + tile * P::kRaw + r * P::kRowBytes +
                        g * (P::kRowBytes / kG));
      }
      __syncthreads();
      k_t = wide;
    }
    const float* v_t = k_t + P::kTile / 4;

    // Scores: queries ty + kTY a, keys tx + 16b.
    float s[kQR][kKB];
#pragma unroll
    for (int a = 0; a < kQR; ++a)
#pragma unroll
      for (int j = 0; j < kKB; ++j) s[a][j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float qx[kQR][4], kx[kKB][4];
#pragma unroll
      for (int a = 0; a < kQR; ++a)
        lds<4>(q_s + (ty + kTY * a) * kDR + d, qx[a]);
#pragma unroll
      for (int j = 0; j < kKB; ++j)
        lds<4>(k_t + (tx + 16 * j) * kDR + d, kx[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < kQR; ++a)
#pragma unroll
          for (int j = 0; j < kKB; ++j)
            s[a][j] = fmaf(qx[a][e], kx[j][e], s[a][j]);
    }
    // s = (q . k) * k_scale * sm_scale in f32, after the product, as the
    // Pallas kernels compute it. A tile wholly at or before the block's
    // first query position is causally valid for every (query, key) pair
    // and skips the compare (the Pallas kernels' inner/frontier split);
    // diagonal and tail tiles compare positions.
    const bool masked = c0 + kKC - 1 > first_qpos || c0 + kKC > kv_end;
#pragma unroll
    for (int a = 0; a < kQR; ++a) {
      const int il = ty + kTY * a, qpos = first_qpos + il;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKB; ++j) {
        const int jl = tx + 16 * j, kpos = c0 + jl;
        float x = s[a][j];
        if constexpr (kQuant) x *= ks_c[jl];
        x *= sm_scale;
        if (masked && (kpos > qpos || kpos >= kv_end)) x = kNegInf;
        s[a][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      const float alpha = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKB; ++j) {
        const int jl = tx + 16 * j;
        const float p = expf(s[a][j] - m_new);
        sum += p;  // l sums the unmasked, unscaled p
        float pv = kQuant ? p * vs_c[jl] : p;
        // Dropout touches only the p.v sum.
        if constexpr (Drop::kMay) {
          if (dr.on) pv = dr.keep(qpos, c0 + jl) ? pv * dr.scale : 0.f;
        }
        p_s[il * kPR + jl] = pv;
      }
      l[a] = alpha * l[a] + row_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int cc = 0; cc < kCW; ++cc) acc[a][cc] *= alpha;
    }
    __syncthreads();  // p complete

    // p.v: queries ty + kTY a, columns tx kCW + cc. p stays f32, JAX's dot
    // dtype for every pair this loop takes.
#pragma unroll
    for (int j = 0; j < kKC; j += 4) {
      float px[kQR][4];
#pragma unroll
      for (int a = 0; a < kQR; ++a)
        lds<4>(p_s + (ty + kTY * a) * kPR + j, px[a]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float vx[kCW];
        lds<kCW>(v_t + (j + e) * kDR + tx * kCW, vx);
#pragma unroll
        for (int a = 0; a < kQR; ++a)
#pragma unroll
          for (int cc = 0; cc < kCW; ++cc)
            acc[a][cc] = fmaf(px[a][e], vx[cc], acc[a][cc]);
      }
    }
    __syncthreads();  // stage c & 1, the widened tiles and p are free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < kQR; ++a) {
    const int i = q0 + ty + kTY * a;
    if (i < T) {
      TQ* row = out + qbase + static_cast<int64_t>(i) * D + tx * kCW;
#pragma unroll
      for (int cc = 0; cc < kCW; ++cc) row[cc] = from_f<TQ>(acc[a][cc] / l[a]);
      if constexpr (kLse) {
        if (tx == 0) lse[static_cast<int64_t>(bh) * T + i] = m[a] + logf(l[a]);
      }
    }
  }
}

// SMs of the current device, read once.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

// The query tile of a launch: 64 once 64-query blocks fill every SM twice
// over (each block then walks the keys for 64 queries), else 32, so that a
// small call still spreads over every SM (PERF.md, section 6).
inline bool wide_query_tiles(int64_t rows, int T) {
  return rows * ((T + 63) / 64) >= 2 * static_cast<int64_t>(sm_count());
}

}  // namespace nsb
