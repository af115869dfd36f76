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
// positions [0, len), split over a grid (H, B, S) whose S comes from the
// host (ops/flash_decode.py decode_splits / dense_decode_splits: from the
// shapes and the SM count, never from the lengths); the last block of a
// (row, head) to finish merges the splits' softmax states in split order
// (finish_split).
//   decode_split  serves K2 (paged_decode_kernel, through the block table,
//                 PagedChain): splits of Ls positions (whole pages), each
//                 lane loading 16 bytes of a row from device memory in
//                 every pool mode.
//   K3 (flash_decode_kernel, flash_decode.cu, over contiguous slot rows)
//                 splits a row only as far as its length pays for the
//                 merge, and brings each split's rows into a shared-memory
//                 ring by bulk copies; its warps widen them as
//                 decode_split's lanes do (Lane16).

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

// KV<T>: how one K/V row of D dims is stored.
//   S       storage element type;
//   kDiv    dims per storage element (2 for packed int4), so a row is
//           D / kDiv elements;
//   kQuant  the row carries a per-position scale;
//   at(row, d)  one dim, for the prefill kernel's element-wise staging.
// The decode walks read rows 16 bytes a lane (Lane16, below).
template <typename T>
struct KV;
template <>
struct KV<float> {
  using S = float;
  static constexpr int kDiv = 1;
  static constexpr bool kQuant = false;
  static __device__ __forceinline__ float at(const S* row, int d) {
    return row[d];
  }
};
template <>
struct KV<__nv_bfloat16> {
  using S = __nv_bfloat16;
  static constexpr int kDiv = 1;
  static constexpr bool kQuant = false;
  static __device__ __forceinline__ float at(const S* row, int d) {
    return __bfloat162float(row[d]);
  }
};
template <>
struct KV<int8_t> {
  using S = int8_t;
  static constexpr int kDiv = 1;
  static constexpr bool kQuant = true;
  static __device__ __forceinline__ float at(const S* row, int d) {
    return static_cast<float>(row[d]);
  }
};
template <>
struct KV<Int4> {
  using S = uint8_t;
  static constexpr int kDiv = 2;
  static constexpr bool kQuant = true;
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
// The block-table addressing of the paged kernels. capacity() bounds the
// positions a row can have; split(b, h, lo, hi, pages_s) gives a block's
// view of positions [lo, hi) of (row b, head h), lo a whole number of
// pages, whose row(pos) is the position-row index of any position in it,
// in the pool viewed as (rows, D) values and (rows,) scales.
// ---------------------------------------------------------------------------

constexpr int kMaxSplitPages = 256;  // pages of one split (pages_s)

// (N, H, page, D) block pool; page j of row b is block table[b, j].
// Table entries outside [0, N) (the engine's sentinel) are clamped before
// any address is formed; their positions lie past the row's frontier.
struct PagedChain {
  const int* table;
  int nb, N, page, H;
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

// ---------------------------------------------------------------------------
// 16-byte lane loads widened to f32 (exact), for both walks. Every lane
// reads 16 bytes of a K or V row at a time in every pool mode (4 fp32, 8
// bf16, 16 int8 or 32 int4 dims), so kLPR = D / kN lanes share a row and a
// warp load moves kRPW = 32 / kLPR whole rows; int8 and int4 widen by
// exponent-bias magic (a byte permute and a subtract, no int-to-float
// conversion). kUnroll: the row groups a K2 lane keeps in flight: 8 for
// fp32 and 4 for bf16 (16 rows a warp step at any head_dim; 8 bf16 groups
// measured 7% slower at the serving shape, PERF.md section 6), 4 for int8
// and 2 for int4 (32 rows a warp step; their 16 and 32 widened dims a lane
// take the registers).
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// finish_split: the end of a split walk, by the walk's kDecWarps warps (the
// first of the block) alone, through named barrier 1. A lane holds the
// online-softmax state (m, l, acc) of the positions its row group saw,
// acc its kN dims [d0, d0 + kN). The warp's row groups (lanes kLPR,
// 2 kLPR, ... apart) merge by shuffles, the warps through shared memory;
// a warp that saw nothing (m = -1e30, l = 0, acc = 0) weighs exp(-huge) = 0
// once another saw a key, and a row with len <= 0 saw no key at all: its l
// is 0 and its output 0, as in the plain versions.
//
// A (row, head) with one active split (n_act <= 1) writes its output here.
// Otherwise the split leaves its unnormalised state (acc[D], m, l) in f32
// scratch part (B*H, S, D + 2); the last split of the (row, head) to
// finish, known by a ticket counter it resets (tickets (B*H,) int32, zero
// between calls), merges the n_act states in split order and writes the
// output, so two calls give equal bits.
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;

__device__ __forceinline__ void dec_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kDecThreads) : "memory");
}

template <typename TQ, int D, int kN>
__device__ __forceinline__ void finish_split(
    float m, float l, float* acc, int n_act, TQ* __restrict__ out,
    float* __restrict__ part, int* __restrict__ tickets, int64_t row, int s,
    int S) {
  constexpr int kLPR = D / kN;
  __shared__ float m_s[kDecWarps], l_s[kDecWarps];
  __shared__ float acc_s[kDecWarps][D];
  __shared__ int last_s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int sub = lane / kLPR, d0 = (lane % kLPR) * kN;
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
  dec_sync();
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
  dec_sync();
  if (t == 0) last_s = atomicAdd(tickets + row, 1) == n_act - 1;
  dec_sync();
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
// decode_split (K2): the row's positions [0, len) are split over S blocks,
// block (h, b, s) walking [s Ls, min((s + 1) Ls, len)), Ls a whole number
// of chunks, so the grid fills the card however few rows there are. A
// block stages its split's pages while the row's length is in flight; a
// split at or past the row's frontier then returns before any K/V load.
//
// A lane keeps Lane16::kUnroll row groups in flight, as stored bytes, and
// widens them as they are used. A row group's scores share one max, one
// rescale of the accumulator and one exp each. The scales are loaded once
// per row, by the first lane of its group, and shuffled to the others.
// ---------------------------------------------------------------------------

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
  finish_split<TQ, D, kN>(m, l, acc, n_act, out, part, tickets, row, s, S);
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
