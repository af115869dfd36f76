// Device code shared by the single-query decode kernels and the paged
// prefill kernels (paged_attention.cu, flash_decode.cu, attend_f32.cuh),
// for Hopper (sm_90a).
//
// K/V storage modes (the `kv` dtype code of every entry point):
//   kF32, kBF16  values as they are;
//   kI8          int8 values with one f32 scale per (row|block, head,
//                position): value = int * scale;
//   kI4          packed int4: two signed nibbles per byte along head_dim,
//                dim 2j in the low nibble and 2j+1 in the high one, each
//                biased by +8, with the same per-position f32 scales.
// The scales are never applied to K/V values. They fold into the math
// exactly as the Pallas kernels fold them (nanosandbox_tpu/ops/
// flash_decode.py): the k scale multiplies a score after the q.k
// reduction, the v scale multiplies the probability before p.v, and the
// softmax normaliser l sums the UNscaled probabilities. The probability
// (times the v scale) is rounded to the Pallas kernels' dot dtype before
// p.v: a bf16 query's over a bf16, int8 or int4 pool rounds it to bf16
// (kRoundP); an fp32 query, or an fp32 pool, keeps it in f32.
//
// Two decode walks, each one query per (row, head) over that row's
// positions [0, len), each templated on an addressing policy saying where
// a position lives: a block table (PagedChain) or contiguous slot rows
// (DenseRows).
//   decode_split  serves K2 (paged_decode_kernel, over a PagedChain): the
//                 row's positions are split over S blocks of whole pages,
//                 each lane loads 16 bytes of a row in every pool mode, and
//                 the last block of a (row, head) to finish merges the
//                 splits' softmax states in split order.
//   decode_row    serves K3 (flash_decode_kernel, over DenseRows): one
//                 block walks the whole row, 8 (int8) or 4 (int4) bytes a
//                 lane load.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace nsb {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kI4 = 3 };

struct Int4 {};  // tag type of the packed int4 mode (storage: uint8_t)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Sign-extend byte i of a 32-bit word.
__device__ __forceinline__ float sbyte(uint32_t w, int i) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * i)) >> 24);
}

// KV<T>: how one K/V row of D dims is read.
//   S       storage element type;
//   kDiv    dims per storage element (2 for packed int4), so a row is
//           D / kDiv elements;
//   kN      dims one lane loads at once (load), converted to f32. Each
//           lane keeps ~8 dims whatever the mode (4 for fp32): 16-byte
//           loads for fp32/bf16, 8-byte for int8, 4-byte for int4, so
//           the quantized modes need no more registers than bf16;
//   kQuant  the row carries a per-position scale;
//   at(row, d)  one dim, for the prefill kernel's element-wise staging.
template <typename T>
struct KV;
template <>
struct KV<float> {
  using S = float;
  static constexpr int kN = 4, kDiv = 1;
  static constexpr bool kQuant = false;
  static __device__ __forceinline__ void load(const S* row, int d0,
                                              float* o) {
    const float4 x = *reinterpret_cast<const float4*>(row + d0);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
  static __device__ __forceinline__ float at(const S* row, int d) {
    return row[d];
  }
};
template <>
struct KV<__nv_bfloat16> {
  using S = __nv_bfloat16;
  static constexpr int kN = 8, kDiv = 1;
  static constexpr bool kQuant = false;
  static __device__ __forceinline__ void load(const S* row, int d0,
                                              float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(row + d0);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ float at(const S* row, int d) {
    return __bfloat162float(row[d]);
  }
};
template <>
struct KV<int8_t> {
  using S = int8_t;
  static constexpr int kN = 8, kDiv = 1;
  static constexpr bool kQuant = true;
  static __device__ __forceinline__ void load(const S* row, int d0,
                                              float* o) {
    const uint2 x = *reinterpret_cast<const uint2*>(row + d0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i] = sbyte(x.x, i);
      o[4 + i] = sbyte(x.y, i);
    }
  }
  static __device__ __forceinline__ float at(const S* row, int d) {
    return static_cast<float>(row[d]);
  }
};
template <>
struct KV<Int4> {
  using S = uint8_t;
  static constexpr int kN = 8, kDiv = 2;
  static constexpr bool kQuant = true;
  static __device__ __forceinline__ void load(const S* row, int d0,
                                              float* o) {
    const uint32_t x = *reinterpret_cast<const uint32_t*>(row + d0 / 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = (x >> (8 * j)) & 0xff;
      o[2 * j] = static_cast<float>((b & 15) - 8);
      o[2 * j + 1] = static_cast<float>((b >> 4) - 8);
    }
  }
  static __device__ __forceinline__ float at(const S* row, int d) {
    const int b = row[d >> 1];
    return static_cast<float>(((d & 1) ? (b >> 4) : (b & 15)) - 8);
  }
};

// Merge softmax state (m2, l2, acc2) into (m, l, acc).
template <int N>
__device__ __forceinline__ void merge_state(float& m, float& l, float* acc,
                                            float m2, float l2,
                                            const float* acc2) {
  const float mn = fmaxf(m, m2);
  const float a1 = expf(m - mn), a2 = expf(m2 - mn);
  l = l * a1 + l2 * a2;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = acc[i] * a1 + acc2[i] * a2;
  m = mn;
}

// ---------------------------------------------------------------------------
// Addressing policies of the decode walks. A row's positions come in chunks
// of chunk() consecutive positions; chunk j of (row b, head h) starts at
// position-row index base(b, h, j) of the pool viewed as (rows, D) values
// and (rows,) scales. capacity() bounds the positions a row can have.
// decode_split asks a policy's split(b, h, lo, hi, pages_s) for the
// block's view of positions [lo, hi), lo a whole number of chunks, whose
// row(pos) gives the position-row index of any position in it (PagedChain
// has one; decode_row's DenseRows does not need it).
// ---------------------------------------------------------------------------

constexpr int kMaxSplitPages = 256;  // pages of one split (pages_s)

// (N, H, page, D) block pool; chunk j of row b is block table[b, j].
// Table entries outside [0, N) (the engine's sentinel) are clamped before
// any address is formed; their positions lie past the row's frontier.
struct PagedChain {
  const int* table;
  int nb, N, page, H;
  __device__ __forceinline__ int chunk() const { return page; }
  __device__ __forceinline__ int capacity() const { return nb * page; }
  __device__ __forceinline__ int64_t base(int b, int h, int j) const {
    const int blk = min(max(table[(int64_t)b * nb + j], 0), N - 1);
    return ((int64_t)blk * H + h) * page;
  }
  // A split's pages, clamped, staged once in shared memory. i / page is
  // umulhi(2i, ceil(2^31 / page)), exact while i * page < 2^31 (the host
  // keeps a split's positions times the page below it).
  struct Split {
    const int* pages;
    int page, H, h, lo;
    uint32_t magic;
    __device__ __forceinline__ int64_t row(int pos) const {
      const uint32_t i = static_cast<uint32_t>(pos - lo);
      const uint32_t pg = __umulhi(2u * i, magic);
      return ((int64_t)pages[pg] * H + h) * page +
             static_cast<int>(i - pg * static_cast<uint32_t>(page));
    }
  };
  // Every thread of the block calls this (it holds a barrier).
  __device__ __forceinline__ Split split(int b, int h, int lo, int hi,
                                         int* pages_s) const {
    const int n = hi > lo ? (hi - lo + page - 1) / page : 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      pages_s[i] = min(max(table[(int64_t)b * nb + lo / page + i], 0), N - 1);
    __syncthreads();
    return Split{pages_s, page, H, h, lo,
                 static_cast<uint32_t>((0x80000000ull + page - 1) / page)};
  }
};

// (B, H, L, D) contiguous slot rows, walked in chunks of kChunk positions.
struct DenseRows {
  static constexpr int kChunk = 64;
  int L, H;
  __device__ __forceinline__ int chunk() const { return kChunk; }
  __device__ __forceinline__ int capacity() const { return L; }
  __device__ __forceinline__ int64_t base(int b, int h, int j) const {
    return ((int64_t)b * H + h) * L + (int64_t)j * kChunk;
  }
};

// ---------------------------------------------------------------------------
// decode_row (K3): one block per (head, row); each warp takes every
// kDecWarps-th chunk of the row's positions.
//
// Within a warp, kLPR lanes share one K/V row (each lane kN dims of it),
// so a load instruction moves kRPW whole rows, coalesced. q.k is a shuffle
// reduction over those lanes; each lane group keeps its own online-softmax
// state (m, l, and the p.v accumulator for its lane's dims) over the
// positions it visits. The groups merge by shuffles, the warps through
// shared memory: softmax states merge exactly, as in the Pallas kernels'
// carry across grid steps. Only chunks below the frontier are read.
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecUnroll = 4;  // row groups in flight per lane

template <typename TQ, typename TKV, int D, typename Chain>
__device__ __forceinline__ void decode_row(
    const TQ* __restrict__ q, const typename KV<TKV>::S* __restrict__ k,
    const typename KV<TKV>::S* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const Chain& chain, int length,
    TQ* __restrict__ out, int b, int h, int H, float sm_scale) {
  using L = KV<TKV>;
  // JAX's dot dtype is q's for a quantized pool and the wider of (q, pool)
  // otherwise (flash_decode.py _flash_decode_kernel): bf16 exactly when a
  // bf16 query meets a pool that is not fp32.
  constexpr bool kRoundP = std::is_same<TQ, __nv_bfloat16>::value &&
                           !std::is_same<TKV, float>::value;
  constexpr int kVN = L::kN;         // dims per lane load
  constexpr int kLPR = D / kVN;      // lanes per K/V row
  constexpr int kRPW = 32 / kLPR;    // rows per warp load
  constexpr int kRow = D / L::kDiv;  // storage elements per row
  static_assert(kLPR <= 32 && 32 % kLPR == 0, "head_dim vs lane width");
  __shared__ float m_s[kDecWarps], l_s[kDecWarps];
  __shared__ float acc_s[kDecWarps][D];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int sub = lane / kLPR;         // which row of the warp's load
  const int d0 = (lane % kLPR) * kVN;  // this lane's dims [d0, d0 + kVN)
  const int64_t row = (int64_t)b * H + h;
  const int len = min(length, chain.capacity());

  float qv[kVN], acc[kVN];
#pragma unroll
  for (int i = 0; i < kVN; ++i) {
    qv[i] = to_f(q[row * D + d0 + i]) * sm_scale;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  const int C = chain.chunk();
  const int n_chunks = len > 0 ? (len + C - 1) / C : 0;
  for (int j = warp; j < n_chunks; j += kDecWarps) {
    const int64_t base = chain.base(b, h, j);
    const int valid_rows = min(C, len - j * C);
    for (int p0 = 0; p0 < valid_rows; p0 += kRPW * kDecUnroll) {
      float kx[kDecUnroll][kVN], vx[kDecUnroll][kVN];
      float ksc[kDecUnroll], vsc[kDecUnroll];
      bool ok[kDecUnroll];
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        const int p = p0 + u * kRPW + sub;
        ok[u] = p < valid_rows;
        ksc[u] = vsc[u] = 0.f;
        if (ok[u]) {
          L::load(k + (base + p) * kRow, d0, kx[u]);
          L::load(v + (base + p) * kRow, d0, vx[u]);
          if constexpr (L::kQuant) {
            ksc[u] = ks[base + p];
            vsc[u] = vs[base + p];
          }
        } else {
#pragma unroll
          for (int i = 0; i < kVN; ++i) kx[u][i] = vx[u][i] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kVN; ++i) s += qv[i] * kx[u][i];
#pragma unroll
        for (int o = kLPR / 2; o > 0; o >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o);
        if constexpr (L::kQuant) s *= ksc[u];
        if (ok[u]) {
          const float m_new = fmaxf(m, s);
          const float alpha = expf(m - m_new), p = expf(s - m_new);
          l = l * alpha + p;
          float pv = L::kQuant ? p * vsc[u] : p;
          if constexpr (kRoundP) pv = __bfloat162float(__float2bfloat16(pv));
#pragma unroll
          for (int i = 0; i < kVN; ++i) acc[i] = acc[i] * alpha + pv * vx[u][i];
          m = m_new;
        }
      }
    }
  }
  // Merge the warp's row groups (lanes kLPR, 2 kLPR, ... apart).
#pragma unroll
  for (int o = kLPR; o < 32; o <<= 1) {
    float acc2[kVN];
#pragma unroll
    for (int i = 0; i < kVN; ++i)
      acc2[i] = __shfl_xor_sync(0xffffffffu, acc[i], o);
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge_state<kVN>(m, l, acc, m2, l2, acc2);
  }
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < kVN; ++i) acc_s[warp][d0 + i] = acc[i];
    if (lane == 0) {
      m_s[warp] = m;
      l_s[warp] = l;
    }
  }
  __syncthreads();
  // Merge the warps. When len >= 1, warp 0 saw position 0, so mx is
  // finite; a warp that saw nothing (m = -1e30, l = 0, acc = 0) weighs
  // exp(-huge) = 0. A row with len <= 0 saw no key at all: lsum is 0 and
  // its output is 0, as in the plain versions.
  if (t < D) {
    float mx = m_s[0];
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w) mx = fmaxf(mx, m_s[w]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float a = expf(m_s[w] - mx);
      lsum += l_s[w] * a;
      o += acc_s[w][t] * a;
    }
    out[row * D + t] = from_f<TQ>(lsum > 0.f ? o / lsum : 0.f);
  }
}

// ---------------------------------------------------------------------------
// decode_split (K2): the row's positions [0, len) are split over S blocks,
// block (h, b, s) walking [s Ls, min((s + 1) Ls, len)), Ls a whole number
// of chunks. S and Ls come from the host (ops/flash_decode.py
// decode_splits: from B, H, the capacity and the SM count, never from the
// lengths), so the grid fills the card however few rows there are. A block
// stages its split's pages while the row's length is in flight; a split
// at or past the row's frontier then returns before any K/V load.
//
// Every lane loads 16 bytes of a K or V row at a time in every pool mode
// (Lane16: 4 fp32, 8 bf16, 16 int8 or 32 int4 dims), so kLPR = D / kN
// lanes share a row and a warp load moves kRPW = 32 / kLPR whole rows; a
// lane keeps Lane16::kUnroll such row groups in flight, as stored bytes, and
// widens them as they are used (int8 and int4 by exponent-bias magic: a
// byte permute and a subtract, no int-to-float conversion). A row group's
// scores share one max, one rescale of the accumulator and one exp each.
// The scales are loaded once per row, by the first lane of its group, and
// shuffled to the others.
//
// A split leaves its unnormalised state (acc[D], m, l) in f32 scratch
// part (B*H, S, D + 2); the last block of a (row, head) to finish, known by
// a ticket counter it resets (tickets (B*H,) int32, zero between calls),
// merges the states in split order and writes the output, so two calls
// give equal bits. A row that fits one split writes its output directly.
// ---------------------------------------------------------------------------

// 16-byte lane loads widened to f32 (exact). kUnroll: row groups a lane
// keeps in flight: 8 for fp32 and 4 for bf16 (16 rows a warp step at any
// head_dim; 8 bf16 groups measured 7% slower at the serving shape,
// PERF.md section 6), 4 for int8 and 2 for int4 (32 rows a warp step;
// their 16 and 32 widened dims a lane take the registers).
template <typename TKV>
struct Lane16;
template <>
struct Lane16<float> {
  static constexpr int kN = 4, kUnroll = 8;
  static __device__ __forceinline__ void widen(const uint4& x, float* o) {
    o[0] = __uint_as_float(x.x); o[1] = __uint_as_float(x.y);
    o[2] = __uint_as_float(x.z); o[3] = __uint_as_float(x.w);
  }
};
template <>
struct Lane16<__nv_bfloat16> {
  static constexpr int kN = 8, kUnroll = 4;
  static __device__ __forceinline__ void widen(const uint4& x, float* o) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half
      o[2 * i] = __uint_as_float(w[i] << 16);
      o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
// 0x4B0000xx is the float 2^23 + xx: a byte permuted under that exponent,
// less the bias, is the stored integer.
template <>
struct Lane16<int8_t> {
  static constexpr int kN = 16, kUnroll = 4;
  static __device__ __forceinline__ void widen(const uint4& x, float* o) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;  // byte b + 128
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[4 * i + j] =
            __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
            8388736.f;
    }
  }
};
template <>
struct Lane16<Int4> {
  static constexpr int kN = 32, kUnroll = 2;
  static __device__ __forceinline__ void widen(const uint4& x, float* o) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = w[i] & 0x0F0F0F0Fu, hi = (w[i] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // dim 2j low nibble, 2j + 1 high
        o[8 * i + 2 * j] =
            __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 + j)) -
            8388616.f;
        o[8 * i + 2 * j + 1] =
            __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 + j)) -
            8388616.f;
      }
    }
  }
};

template <typename TQ, typename TKV, int D, typename Chain>
__device__ __forceinline__ void decode_split(
    const TQ* __restrict__ q, const typename KV<TKV>::S* __restrict__ k,
    const typename KV<TKV>::S* __restrict__ v, const float* __restrict__ ks,
    const float* __restrict__ vs, const Chain& chain, int length, int Ls,
    TQ* __restrict__ out, float* __restrict__ part, int* __restrict__ tickets,
    int b, int h, int s, int S, int H, float sm_scale) {
  using L = KV<TKV>;
  using W = Lane16<TKV>;
  constexpr bool kQuant = L::kQuant;
  constexpr bool kRoundP = std::is_same<TQ, __nv_bfloat16>::value &&
                           !std::is_same<TKV, float>::value;
  constexpr int kN = W::kN;          // dims a lane load
  constexpr int kLPR = D / kN;       // lanes a row
  constexpr int kRPW = 32 / kLPR;    // rows a warp load
  constexpr int kU = W::kUnroll;
  constexpr int kG = kRPW * kU;      // positions a warp step
  constexpr int kRowBytes = D * static_cast<int>(sizeof(typename L::S)) /
                            L::kDiv;
  static_assert(kLPR >= 1 && kLPR <= 32 && 32 % kLPR == 0,
                "head_dim vs the 16-byte lane load");
  __shared__ int pages_s[kMaxSplitPages];
  __shared__ float m_s[kDecWarps], l_s[kDecWarps];
  __shared__ float acc_s[kDecWarps][D];
  __shared__ int last_s;

  // The split's pages are staged while the row's length is in flight.
  const int cap = chain.capacity(), lo = s * Ls;
  const auto rows = chain.split(b, h, lo, min(lo + Ls, cap), pages_s);
  const int len = min(length, cap);
  const int n_act = len > 0 ? (len + Ls - 1) / Ls : 0;  // splits with keys
  if (s > 0 && s >= n_act) return;  // past the frontier: no K/V load
  const int hi = min(lo + Ls, len);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int sub = lane / kLPR;            // which row of the warp's load
  const int piece = lane % kLPR;          // which 16 bytes of it
  const int lead = lane - piece;          // the row's first lane
  const int d0 = piece * kN;              // dims [d0, d0 + kN)
  const int64_t row = (int64_t)b * H + h;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k) +
                            16 * piece;
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v) +
                            16 * piece;

  float qv[kN], acc[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    qv[i] = to_f(q[row * D + d0 + i]);
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  for (int g0 = lo + warp * kG; g0 < hi; g0 += kDecWarps * kG) {
    uint4 kr[kU], vr[kU];
    float ksc[kU], vsc[kU];
    bool ok[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int pos = g0 + u * kRPW + sub;
      ok[u] = pos < hi;
      kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
      ksc[u] = vsc[u] = 0.f;
      if (ok[u]) {
        const int64_t r = rows.row(pos);
        kr[u] = __ldg(reinterpret_cast<const uint4*>(kb + r * kRowBytes));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(vb + r * kRowBytes));
        if constexpr (kQuant) {
          if (piece == 0) {
            ksc[u] = __ldg(ks + r);
            vsc[u] = __ldg(vs + r);
          }
        }
      }
    }
    // Scores of the kU rows, one max over them.
    float sc[kU];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float kx[kN];
      W::widen(kr[u], kx);
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < kN; ++i) d = fmaf(qv[i], kx[i], d);
#pragma unroll
      for (int o = kLPR / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if constexpr (kQuant) {
        d *= __shfl_sync(0xffffffffu, ksc[u], lead);
        vsc[u] = __shfl_sync(0xffffffffu, vsc[u], lead);
      }
      d *= sm_scale;
      sc[u] = ok[u] ? d : kNegInf;
      mx = fmaxf(mx, sc[u]);
    }
    const float alpha = expf(m - mx);
    float psum = 0.f, pv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const float p = ok[u] ? expf(sc[u] - mx) : 0.f;
      psum += p;  // l sums the unscaled p; the v scale folds in here
      pv[u] = kQuant ? p * vsc[u] : p;
      if constexpr (kRoundP) pv[u] = __bfloat162float(__float2bfloat16(pv[u]));
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < kN; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float vx[kN];
      W::widen(vr[u], vx);
#pragma unroll
      for (int i = 0; i < kN; ++i) acc[i] = fmaf(pv[u], vx[i], acc[i]);
    }
    m = mx;
  }
  // Merge the warp's row groups (lanes kLPR, 2 kLPR, ... apart), then the
  // warps through shared memory.
#pragma unroll
  for (int o = kLPR; o < 32; o <<= 1) {
    float acc2[kN];
#pragma unroll
    for (int i = 0; i < kN; ++i)
      acc2[i] = __shfl_xor_sync(0xffffffffu, acc[i], o);
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    merge_state<kN>(m, l, acc, m2, l2, acc2);
  }
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) acc_s[warp][d0 + i] = acc[i];
    if (lane == 0) {
      m_s[warp] = m;
      l_s[warp] = l;
    }
  }
  __syncthreads();
  // A warp that saw nothing (m = -1e30, l = 0, acc = 0) weighs exp(-huge)
  // = 0 once another saw a key; a row with len <= 0 saw no key at all: its
  // l is 0 and its output 0, as in the plain versions.
  float mx = kNegInf, lsum = 0.f, o = 0.f;
  if (t < D) {
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) mx = fmaxf(mx, m_s[w]);
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float a = expf(m_s[w] - mx);
      lsum += l_s[w] * a;
      o += acc_s[w][t] * a;
    }
  }
  if (n_act <= 1) {
    if (t < D) out[row * D + t] = from_f<TQ>(lsum > 0.f ? o / lsum : 0.f);
    return;
  }
  float* mine = part + (row * S + s) * (D + 2);
  if (t < D) {
    mine[t] = o;
    if (t == 0) {
      mine[D] = mx;
      mine[D + 1] = lsum;
    }
  }
  __threadfence();  // the state is visible before the ticket is taken
  __syncthreads();
  if (t == 0) last_s = atomicAdd(tickets + row, 1) == n_act - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // The last block: every split has a key (m finite, l > 0); merged in
  // split order whichever block finished last, in one pass whose loads
  // run ahead of the arithmetic (unrolled).
  if (t < D) {
    const float* st = part + row * S * (D + 2);
    float M = kNegInf, lt = 0.f, ot = 0.f;
#pragma unroll 4
    for (int j = 0; j < n_act; ++j) {
      const float* sj = st + j * (D + 2);
      const float mj = __ldcg(sj + D), lj = __ldcg(sj + D + 1);
      const float oj = __ldcg(sj + t);
      const float mn = fmaxf(M, mj);
      const float a = expf(M - mn), c = expf(mj - mn);
      lt = lt * a + lj * c;
      ot = ot * a + oj * c;
      M = mn;
    }
    out[row * D + t] = from_f<TQ>(ot / lt);
  }
  if (t == 0) tickets[row] = 0;
}

// ---------------------------------------------------------------------------
// Dispatch on (q dtype, kv dtype, head_dim): F::run<TQ, TKV, D>(args...)
// for the instance asked for; false when there is none.
// ---------------------------------------------------------------------------

template <typename F, typename TQ, typename TKV, typename... Args>
bool dispatch_d(int D, Args... args) {
  switch (D) {
    case 32: F::template run<TQ, TKV, 32>(args...); return true;
    case 64: F::template run<TQ, TKV, 64>(args...); return true;
    case 128: F::template run<TQ, TKV, 128>(args...); return true;
    default: return false;
  }
}

template <typename F, typename TQ, typename... Args>
bool dispatch_kv(int kv_dtype, int D, Args... args) {
  switch (kv_dtype) {
    case kF32: return dispatch_d<F, TQ, float>(D, args...);
    case kBF16: return dispatch_d<F, TQ, __nv_bfloat16>(D, args...);
    case kI8: return dispatch_d<F, TQ, int8_t>(D, args...);
    case kI4: return dispatch_d<F, TQ, Int4>(D, args...);
    default: return false;
  }
}

template <typename F, typename... Args>
bool dispatch(int q_dtype, int kv_dtype, int D, Args... args) {
  switch (q_dtype) {
    case kF32: return dispatch_kv<F, float>(kv_dtype, D, args...);
    case kBF16: return dispatch_kv<F, __nv_bfloat16>(kv_dtype, D, args...);
    default: return false;
  }
}

}  // namespace nsb
