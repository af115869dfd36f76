// Paged attention over a block-paged KV pool, for Hopper (sm_90a).
//
// Two kernels, each the CUDA counterpart of a Pallas kernel in
// nanosandbox_tpu/ops/flash_decode.py:
//
//   paged_decode_kernel  <- _paged_decode_kernel  (flash_decode_paged)
//       one query per (row, head) over the row's block chain, up to
//       lengths[b] positions. Bound by bytes: every position of the
//       chain is read once (K and V) for 4*D flops. One block per
//       (row, head) leaves a long row to one SM's share of the memory
//       rate, and B*H blocks (96 at 8 slots) under-fill 132 SMs;
//       splitting a row's chain over blocks is later work.
//   paged_prefill_kernel <- _paged_prefill_kernel (flash_prefill_paged)
//       T queries per row at positions start[b] .. start[b]+T-1, causal
//       over the row's chain (the resident prefix included). It does
//       about T times the decode's flops per byte; this first version
//       runs the products on CUDA cores in f32, not on the tensor cores.
//
// Layouts (row-major, contiguous): q (B, H, D) or (B, H, T, D); k, v
// (N, H, page, D); block_table (B, nb) int32, where an entry >= N is the
// engine's "no block" sentinel; lengths / start (B,) int32; out like q.
// q and out are float or bf16; k and v are float or bf16, independently
// of q. Scores, the softmax and the accumulators are f32 throughout, so
// an fp32 pool under a bf16 query keeps its precision.
//
// Design. The Pallas kernels walk a sequential grid axis over the chain
// and carry the online-softmax state (acc, m, l) in VMEM scratch from
// one grid step to the next. CUDA blocks run in no order, so here one
// block owns a whole (row, head) -- or a (row, head, query tile) for
// prefill -- and the carry is a loop inside the block. Each block reads
// its own block-table entries; sentinel entries are clamped to N - 1 so
// they never address memory outside the pool (their positions lie past
// the frontier and are masked, exactly as in the Pallas index maps).
//
// Every entry point returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF

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

// 16-byte vector loads: 4 floats or 8 bf16 per load, converted to f32.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  static __device__ __forceinline__ void load(const float* p, float* o) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* o) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
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

// Element offset of position `pos` of row b, head h, in a (N, H, page, D)
// pool. Table entries outside [0, N) are clamped, never dereferenced raw.
__device__ __forceinline__ int64_t kv_offset(const int* __restrict__ table,
                                             int b, int nb, int pos, int page,
                                             int N, int H, int h, int D) {
  int blk = table[(int64_t)b * nb + pos / page];
  blk = min(max(blk, 0), N - 1);
  return (((int64_t)blk * H + h) * page + pos % page) * D;
}

// ---------------------------------------------------------------------------
// Decode: one block per (head, row); each warp walks every kDecWarps-th
// page of the row's chain.
//
// Within a warp, kLPR lanes share one K/V row (each lane one 16-byte
// vector of it), so a load instruction moves kRPW whole rows, coalesced.
// q.k is a shuffle reduction over those lanes; each lane group keeps its
// own online-softmax state (m, l, and the p.v accumulator for its lane's
// dims) over the positions it visits. The groups merge by shuffles, the
// warps through shared memory: softmax states merge exactly, as in the
// Pallas kernel's carry across grid steps.
// ---------------------------------------------------------------------------

constexpr int kDecWarps = 8;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecUnroll = 4;  // row groups in flight per lane

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

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ table,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    int H, int N, int page, int nb, float sm_scale) {
  constexpr int kVN = Vec<TKV>::kN;  // elements per 16-byte vector
  constexpr int kLPR = D / kVN;      // lanes per K/V row
  constexpr int kRPW = 32 / kLPR;    // rows per warp load
  static_assert(kLPR <= 32 && 32 % kLPR == 0, "head_dim vs vector width");
  __shared__ float m_s[kDecWarps], l_s[kDecWarps];
  __shared__ float acc_s[kDecWarps][D];

  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int sub = lane / kLPR;           // which row of the warp's load
  const int d0 = (lane % kLPR) * kVN;    // this lane's dims [d0, d0 + kVN)
  const int64_t row = (int64_t)b * H + h;
  const int len = min(lengths[b], nb * page);

  float qv[kVN], acc[kVN];
#pragma unroll
  for (int i = 0; i < kVN; ++i) {
    qv[i] = to_f(q[row * D + d0 + i]) * sm_scale;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  // Only pages below the frontier are visited: the rest are never read.
  const int n_pages = (len + page - 1) / page;
  for (int j = warp; j < n_pages; j += kDecWarps) {
    const int blk = min(max(table[(int64_t)b * nb + j], 0), N - 1);
    const int64_t base = ((int64_t)blk * H + h) * page * D + d0;
    const int valid_rows = min(page, len - j * page);
    for (int p0 = 0; p0 < page; p0 += kRPW * kDecUnroll) {
      float kx[kDecUnroll][kVN], vx[kDecUnroll][kVN];
      bool ok[kDecUnroll];
#pragma unroll
      for (int u = 0; u < kDecUnroll; ++u) {
        const int p = p0 + u * kRPW + sub;
        ok[u] = p < valid_rows;
        if (ok[u]) {
          Vec<TKV>::load(k + base + (int64_t)p * D, kx[u]);
          Vec<TKV>::load(v + base + (int64_t)p * D, vx[u]);
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
        if (ok[u]) {
          const float m_new = fmaxf(m, s);
          const float alpha = expf(m - m_new), p = expf(s - m_new);
          l = l * alpha + p;
#pragma unroll
          for (int i = 0; i < kVN; ++i) acc[i] = acc[i] * alpha + p * vx[u][i];
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
  // its output is 0, as in the plain version.
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
// Prefill: one block per (query tile, head, row); K/V chunks staged in
// shared memory, an f32 score tile, the online softmax per query row.
// ---------------------------------------------------------------------------

constexpr int kPfThreads = 128;
constexpr int kPfQT = 16;  // queries per block

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kPfThreads)
paged_prefill_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                     const TKV* __restrict__ v, const int* __restrict__ table,
                     const int* __restrict__ start, TQ* __restrict__ out,
                     int H, int T, int N, int page, int nb, float sm_scale) {
  constexpr int kKC = 2048 / D;          // key positions per chunk
  constexpr int kDP = D + 1;             // padded row: no bank conflicts
  constexpr int kWarps = kPfThreads / 32;
  constexpr int kNRG = kPfThreads / D;   // query-row groups in the p.v pass
  constexpr int kRPT = kPfQT / kNRG;     // query rows per thread
  __shared__ float q_s[kPfQT][kDP];
  __shared__ float k_s[kKC][kDP];
  __shared__ float v_s[kKC][kDP];
  __shared__ float p_s[kPfQT][kKC + 1];
  __shared__ float m_s[kPfQT], l_s[kPfQT], a_s[kPfQT];

  const int q0 = blockIdx.x * kPfQT, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t qrow = ((int64_t)b * H + h) * T;
  const int base = start[b];  // position of query 0 of this row

  for (int e = t; e < kPfQT * D; e += kPfThreads) {
    const int i = e / D, d = e % D;
    q_s[i][d] = q0 + i < T ? to_f(q[(qrow + q0 + i) * D + d]) * sm_scale : 0.f;
  }
  if (t < kPfQT) {
    m_s[t] = kNegInf;
    l_s[t] = 0.f;
  }
  // Keys any query of the tile can see; nothing past the chain exists.
  const int last_q = min(q0 + kPfQT, T) - 1;
  const int kv_end = min(base + last_q + 1, nb * page);
  const int first_qpos = base + q0;
  const int d_own = t % D, rg = t / D;
  float acc[kRPT];
#pragma unroll
  for (int r = 0; r < kRPT; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < kv_end; c0 += kKC) {
    for (int e = t; e < kKC * D; e += kPfThreads) {
      const int j = e / D, d = e % D, pos = c0 + j;
      float kx = 0.f, vx = 0.f;
      if (pos < kv_end) {
        const int64_t off = kv_offset(table, b, nb, pos, page, N, H, h, D) + d;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      k_s[j][d] = kx;
      v_s[j][d] = vx;
    }
    __syncthreads();
    // A chunk wholly at or before the tile's first query position is
    // causally valid for every (query, key) pair and skips the mask; only
    // chunks that cross the frontier compare positions (the Pallas
    // kernel's inner/frontier split).
    const bool frontier = c0 + kKC - 1 > first_qpos;
    for (int e = t; e < kPfQT * kKC; e += kPfThreads) {
      const int i = e / kKC, j = e % kKC;
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s += q_s[i][d] * k_s[j][d];
      const int kpos = c0 + j;
      if (kpos >= kv_end || (frontier && kpos > first_qpos + i)) s = kNegInf;
      p_s[i][j] = s;
    }
    __syncthreads();
    for (int i = warp; i < kPfQT; i += kWarps) {
      float mx = kNegInf;
      for (int j = lane; j < kKC; j += 32) mx = fmaxf(mx, p_s[i][j]);
      mx = warp_max(mx);
      const float m_old = m_s[i];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < kKC; j += 32) {
        const float p = expf(p_s[i][j] - m_new);
        p_s[i][j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[i] = alpha;
        l_s[i] = l_s[i] * alpha + sum;
        m_s[i] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRPT; ++r) {
      const int i = rg + r * kNRG;
      float a = acc[r] * a_s[i];
#pragma unroll 8
      for (int j = 0; j < kKC; ++j) a += p_s[i][j] * v_s[j][d_own];
      acc[r] = a;
    }
    __syncthreads();  // k_s, v_s and p_s are rewritten by the next chunk
  }
#pragma unroll
  for (int r = 0; r < kRPT; ++r) {
    const int i = rg + r * kNRG;
    if (q0 + i < T)
      out[(qrow + q0 + i) * D + d_own] = from_f<TQ>(acc[r] / l_s[i]);
  }
}

// ---------------------------------------------------------------------------
// Dispatch on (q dtype, kv dtype, head_dim).
// ---------------------------------------------------------------------------

enum DType { kF32 = 0, kBF16 = 1 };

template <typename TQ, typename TKV, int D>
void launch_decode(const void* q, const void* k, const void* v,
                   const int* table, const int* lengths, void* out, int B,
                   int H, int N, int page, int nb, float sm_scale,
                   cudaStream_t stream) {
  paged_decode_kernel<TQ, TKV, D><<<dim3(H, B), kDecThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), table, lengths, static_cast<TQ*>(out), H, N,
      page, nb, sm_scale);
}

template <typename TQ, typename TKV, int D>
void launch_prefill(const void* q, const void* k, const void* v,
                    const int* table, const int* start, void* out, int B,
                    int H, int T, int N, int page, int nb, float sm_scale,
                    cudaStream_t stream) {
  const dim3 grid((T + kPfQT - 1) / kPfQT, H, B);
  paged_prefill_kernel<TQ, TKV, D><<<grid, kPfThreads, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), table, start, static_cast<TQ*>(out), H, T,
      N, page, nb, sm_scale);
}

// LAUNCH##_any(q dtype, kv dtype, head_dim, args...) picks the template
// instance; false when the combination has none.
#define NSB_BY_HEAD_DIM(LAUNCH)                                      \
  template <typename TQ, typename TKV, typename... Args>               \
  bool LAUNCH##_d(int D, Args... args) {                               \
    switch (D) {                                                       \
      case 32: LAUNCH<TQ, TKV, 32>(args...); return true;              \
      case 64: LAUNCH<TQ, TKV, 64>(args...); return true;              \
      case 128: LAUNCH<TQ, TKV, 128>(args...); return true;            \
      default: return false;                                           \
    }                                                                  \
  }                                                                    \
  template <typename... Args>                                          \
  bool LAUNCH##_any(int qdt, int kvdt, int D, Args... args) {          \
    if (qdt == kF32 && kvdt == kF32)                                   \
      return LAUNCH##_d<float, float>(D, args...);                     \
    if (qdt == kF32 && kvdt == kBF16)                                  \
      return LAUNCH##_d<float, __nv_bfloat16>(D, args...);             \
    if (qdt == kBF16 && kvdt == kF32)                                  \
      return LAUNCH##_d<__nv_bfloat16, float>(D, args...);             \
    if (qdt == kBF16 && kvdt == kBF16)                                 \
      return LAUNCH##_d<__nv_bfloat16, __nv_bfloat16>(D, args...);     \
    return false;                                                      \
  }

NSB_BY_HEAD_DIM(launch_decode)
NSB_BY_HEAD_DIM(launch_prefill)

}  // namespace

extern "C" {

// Returns a cudaError_t: cudaSuccess (0) once the kernel is queued.
int nsb_paged_decode(const void* q, const void* k, const void* v,
                     const int* table, const int* lengths, void* out, int B,
                     int H, int D, int N, int page, int nb, float sm_scale,
                     int q_dtype, int kv_dtype, void* stream) {
  if (!launch_decode_any(q_dtype, kv_dtype, D, q, k, v, table, lengths, out,
                         B, H, N, page, nb, sm_scale,
                         static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int nsb_paged_prefill(const void* q, const void* k, const void* v,
                      const int* table, const int* start, void* out, int B,
                      int H, int T, int D, int N, int page, int nb,
                      float sm_scale, int q_dtype, int kv_dtype,
                      void* stream) {
  if (!launch_prefill_any(q_dtype, kv_dtype, D, q, k, v, table, start, out,
                          B, H, T, N, page, nb, sm_scale,
                          static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
