// Paged attention over a block-paged KV pool, for Hopper (sm_90a).
//
// Two kernels, each the CUDA counterpart of a Pallas kernel in
// nanosandbox_tpu/ops/flash_decode.py:
//
//   paged_decode_kernel  <- _paged_decode_kernel  (flash_decode_paged)
//       one query per (row, head) over the row's block chain, up to
//       lengths[b] positions (decode_common.cuh decode_row over a
//       PagedChain). Bound by bytes: every position of the chain is read
//       once (K and V, and their scales in the int8/int4 modes) for 4*D
//       flops. One block per (row, head) leaves a long row to one SM's
//       share of the memory rate, and B*H blocks (96 at 8 slots)
//       under-fill 132 SMs; splitting a row's chain over blocks is later
//       work.
//   paged_prefill_kernel <- _paged_prefill_kernel (flash_prefill_paged)
//       T queries per row at positions start[b] .. start[b]+T-1, causal
//       over the row's chain (the resident prefix included). It does
//       about T times the decode's flops per byte; this first version
//       runs the products on CUDA cores in f32, not on the tensor cores.
//
// Layouts (row-major, contiguous): q (B, H, D) or (B, H, T, D); k, v
// (N, H, page, D), or (N, H, page, D/2) bytes for packed int4; k_scale,
// v_scale (N, H, page) f32 for int8/int4 pools (unused otherwise);
// block_table (B, nb) int32, where an entry >= N is the engine's "no
// block" sentinel; lengths / start (B,) int32; out like q. q and out are
// float or bf16; the pool is float, bf16, int8 or packed int4,
// independently of q (decode_common.cuh). Scores, the softmax and the
// accumulators are f32 throughout, so an fp32 pool under a bf16 query
// keeps its precision, and the int8/int4 scale folds happen in f32.
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

#include "decode_common.cuh"

namespace nsb {
namespace {

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const TQ* __restrict__ q,
                    const typename KV<TKV>::S* __restrict__ k,
                    const typename KV<TKV>::S* __restrict__ v,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    int H, int N, int page, int nb, float sm_scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  decode_row<TQ, TKV, D>(q, k, v, ks, vs, PagedChain{table, nb, N, page, H},
                         lengths[b], out, b, h, H, sm_scale);
}

// ---------------------------------------------------------------------------
// Prefill: one block per (query tile, head, row); K/V chunks staged in
// shared memory converted to f32 (int4 unpacked, int8 widened, their
// scales staged beside them and applied to scores and probabilities,
// never to the staged values), an f32 score tile, the online softmax per
// query row.
// ---------------------------------------------------------------------------

constexpr int kPfThreads = 128;
constexpr int kPfQT = 16;  // queries per block

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kPfThreads)
paged_prefill_kernel(const TQ* __restrict__ q,
                     const typename KV<TKV>::S* __restrict__ k,
                     const typename KV<TKV>::S* __restrict__ v,
                     const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int* __restrict__ table,
                     const int* __restrict__ start, TQ* __restrict__ out,
                     int H, int T, int N, int page, int nb, float sm_scale) {
  using L = KV<TKV>;
  constexpr int kRow = D / L::kDiv;      // storage elements per K/V row
  constexpr int kKC = 2048 / D;          // key positions per chunk
  constexpr int kDP = D + 1;             // padded row: no bank conflicts
  constexpr int kWarps = kPfThreads / 32;
  constexpr int kNRG = kPfThreads / D;   // query-row groups in the p.v pass
  constexpr int kRPT = kPfQT / kNRG;     // query rows per thread
  __shared__ float q_s[kPfQT][kDP];
  __shared__ float k_s[kKC][kDP];
  __shared__ float v_s[kKC][kDP];
  __shared__ float p_s[kPfQT][kKC + 1];
  __shared__ float ks_s[kKC], vs_s[kKC];
  __shared__ float m_s[kPfQT], l_s[kPfQT], a_s[kPfQT];

  const int q0 = blockIdx.x * kPfQT, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t qrow = ((int64_t)b * H + h) * T;
  const int base = start[b];  // position of query 0 of this row
  const PagedChain chain{table, nb, N, page, H};

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
  const int kv_end = min(base + last_q + 1, chain.capacity());
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
        const int64_t r = chain.base(b, h, pos / page) + pos % page;
        kx = L::at(k + r * kRow, d);
        vx = L::at(v + r * kRow, d);
      }
      k_s[j][d] = kx;
      v_s[j][d] = vx;
    }
    if constexpr (L::kQuant) {
      for (int j = t; j < kKC; j += kPfThreads) {
        const int pos = c0 + j;
        float kss = 0.f, vss = 0.f;
        if (pos < kv_end) {
          const int64_t r = chain.base(b, h, pos / page) + pos % page;
          kss = ks[r];
          vss = vs[r];
        }
        ks_s[j] = kss;
        vs_s[j] = vss;
      }
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
      if constexpr (L::kQuant) s *= ks_s[j];
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
        sum += p;  // l sums the unscaled p; the v scale folds in below
        p_s[i][j] = L::kQuant ? p * vs_s[j] : p;
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

struct LaunchDecode {
  template <typename TQ, typename TKV, int D>
  static void run(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* table,
                  const int* lengths, void* out, int B, int H, int N,
                  int page, int nb, float sm_scale, cudaStream_t stream) {
    using S = typename KV<TKV>::S;
    paged_decode_kernel<TQ, TKV, D><<<dim3(H, B), kDecThreads, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const S*>(k),
        static_cast<const S*>(v), ks, vs, table, lengths,
        static_cast<TQ*>(out), H, N, page, nb, sm_scale);
  }
};

struct LaunchPrefill {
  template <typename TQ, typename TKV, int D>
  static void run(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* table,
                  const int* start, void* out, int B, int H, int T, int N,
                  int page, int nb, float sm_scale, cudaStream_t stream) {
    using S = typename KV<TKV>::S;
    const dim3 grid((T + kPfQT - 1) / kPfQT, H, B);
    paged_prefill_kernel<TQ, TKV, D><<<grid, kPfThreads, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const S*>(k),
        static_cast<const S*>(v), ks, vs, table, start,
        static_cast<TQ*>(out), H, T, N, page, nb, sm_scale);
  }
};

}  // namespace
}  // namespace nsb

extern "C" {

// Returns a cudaError_t: cudaSuccess (0) once the kernel is queued. D is
// the logical head_dim (twice the stored bytes of a packed int4 row).
int nsb_paged_decode(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int* table, const int* lengths, void* out, int B,
                     int H, int D, int N, int page, int nb, float sm_scale,
                     int q_dtype, int kv_dtype, void* stream) {
  if (!nsb::dispatch<nsb::LaunchDecode>(
          q_dtype, kv_dtype, D, q, k, v, k_scale, v_scale, table, lengths,
          out, B, H, N, page, nb, sm_scale,
          static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

int nsb_paged_prefill(const void* q, const void* k, const void* v,
                      const float* k_scale, const float* v_scale,
                      const int* table, const int* start, void* out, int B,
                      int H, int T, int D, int N, int page, int nb,
                      float sm_scale, int q_dtype, int kv_dtype,
                      void* stream) {
  if (!nsb::dispatch<nsb::LaunchPrefill>(
          q_dtype, kv_dtype, D, q, k, v, k_scale, v_scale, table, start,
          out, B, H, T, N, page, nb, sm_scale,
          static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
