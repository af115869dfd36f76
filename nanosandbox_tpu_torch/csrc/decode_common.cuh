// Device code shared by the single-query decode kernels and the paged
// prefill kernel (paged_attention.cu, flash_decode.cu), for Hopper
// (sm_90a).
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
// The decode walk (decode_row) is one query per (row, head) over that
// row's positions [0, len), with an addressing policy saying where each
// chunk of positions lives: a block table (PagedChain, K2) or contiguous
// slot rows (DenseRows, K3). Each is launched by its own __global__.

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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
// Addressing policies of the decode walk. A row's positions come in chunks
// of chunk() consecutive positions; chunk j of (row b, head h) starts at
// position-row index base(b, h, j) of the pool viewed as (rows, D) values
// and (rows,) scales. capacity() bounds the positions a row can have.
// ---------------------------------------------------------------------------

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
// The decode walk: one block per (head, row); each warp takes every
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
