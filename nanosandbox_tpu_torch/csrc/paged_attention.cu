// Paged attention over a block-paged KV pool, for Hopper (sm_90a).
//
// The CUDA counterparts of two Pallas kernels in
// nanosandbox_tpu/ops/flash_decode.py:
//
//   paged_decode_kernel  <- _paged_decode_kernel  (flash_decode_paged, K2)
//       one query per (row, head) over the row's block chain, up to
//       lengths[b] positions (decode_common.cuh decode_split over a
//       PagedChain). Bound by bytes: every position of the chain is read
//       once (K and V, and their scales in the int8/int4 modes) for 4*D
//       flops. So the chain is split over blocks, a grid (H, B, S) of
//       whole-page splits chosen on the host to fill every SM twice over,
//       and every lane loads 16 bytes at a time in every pool mode; the
//       last split of a (row, head) to finish merges the others' states.
//   paged_prefill_mma_kernel, paged_prefill_f32_kernel
//                        <- _paged_prefill_kernel (flash_prefill_paged, K1)
//       T queries per row at positions start[b] .. start[b]+T-1, causal
//       over the row's chain (the resident prefix included).
//
// K1 does about T/2 times the decode's flops per byte read. At an 8 x 512
// admission wave (GPT-2 124M, head_dim 64, start 0) it moves 25 MB (K/V of
// the visited positions, q, out): 0.0075 ms at 3.35 TB/s, its bound; its
// 3.2 GFLOP take 0.0033 ms on the bf16 tensor cores but 0.048 ms at the
// f32 peak of the CUDA cores. So a bf16 query's products go to the tensor
// cores, and each K/V chunk is staged once per query tile.
//
//   paged_prefill_mma_kernel: a bf16 query over a bf16, int8 or int4
//     pool, on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
//     accumulate; building blocks in mma_common.cuh). A block owns 64
//     queries of one (row, head), a warp 16; Q is loaded once into A
//     fragments. 64-position K/V chunks stream through a two-stage
//     cp.async ring, each 16-byte piece of a stored row addressed through
//     the block table, positions past the tile's last visible key
//     zero-filled by the copy. A bf16 chunk lands straight in swizzled
//     tiles; an int8/int4 chunk lands as its stored bytes and scales and
//     is widened to bf16 tiles in shared memory (exact), with the next
//     chunk in flight. K's B fragments come by ldmatrix, V's by
//     ldmatrix.trans. The scales fold where the Pallas kernel folds them:
//     s = (q . k_int) * k_scale * sm_scale in f32 after the product, l
//     sums the unscaled p, and p * v_scale is rounded to bf16 as the A
//     fragment of p.v -- JAX's own rounding, since it feeds the MXU in a
//     bf16 query's dtype. The online softmax runs in registers (exp2 of
//     pre-multiplied scores; a row's max and sum over its four lanes).
//   paged_prefill_f32_kernel: every other (query, pool) pair -- an fp32
//     query over any pool, a bf16 query over an fp32 pool -- on CUDA cores
//     with exact f32 products. An fp32 query is held to 1e-5 of the plain
//     version and the fp32 engines to token identity, which bf16 or TF32
//     products would not meet; a bf16 query over an fp32 pool attends in
//     f32, as JAX does (its dot dtype is promote_types(bf16, f32)). Bound
//     by the f32 FMA rate (the wave's 3.2 GFLOP take 0.048 ms at 67
//     TFLOP/s) and the shared-memory reads that feed it. Its loop is
//     attend_f32.cuh's, shared with the fp32 flash forward (K4), over the
//     row's chain: 32- or 64-query blocks (64 once such blocks fill every
//     SM twice over: 192 32-query blocks for the 132 SMs at B 2, T 256;
//     64-query blocks at an 8 x 512 wave), each reading the chain once
//     through a two-stage cp.async ring of 16-byte pieces addressed
//     through the block table.
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
// one grid step to the next. CUDA blocks run in no order: a prefill block
// owns a (row, head, query tile) and the carry is a loop inside it; a
// decode block owns a (row, head, split) and the splits' carries merge
// exactly, in split order, in the last block to finish. Each block reads
// its own block-table entries; sentinel entries are clamped to N - 1 so
// they never address memory outside the pool (their positions lie past
// the frontier and are masked, exactly as in the Pallas index maps).
//
// Every entry point returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not cudaSuccess.

#include <type_traits>

#include "attend_f32.cuh"
#include "decode_common.cuh"
#include "mma_common.cuh"

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
                    float* __restrict__ part, int* __restrict__ tickets,
                    int H, int N, int page, int nb, int Ls, float sm_scale) {
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z;
  decode_split<TQ, TKV, D>(q, k, v, ks, vs, PagedChain{table, nb, N, page, H},
                           lengths[b], Ls, out, part, tickets, b, h, s,
                           gridDim.z, H, sm_scale);
}

// ---------------------------------------------------------------------------
// Prefill on CUDA cores in f32: an fp32 query over any pool, or a bf16
// query over an fp32 pool. One block per (row*head, query tile of 32 or
// 64), the grid's y the query tile, the longest walk first; the loop is
// attend_f32's over the row's block chain.
// ---------------------------------------------------------------------------

template <typename TQ, typename TKV, int D, int kBQ>
__global__ void __launch_bounds__(TilesF32<TKV, D, kBQ>::kThreads, 2)
paged_prefill_f32_kernel(const TQ* __restrict__ q,
                         const typename KV<TKV>::S* __restrict__ k,
                         const typename KV<TKV>::S* __restrict__ v,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ table,
                         const int* __restrict__ start, TQ* __restrict__ out,
                         int H, int T, int N, int page, int nb,
                         float sm_scale) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const PagedChain chain{table, nb, N, page, H};
  const int base = start[b];  // position of query 0 of this row
  // Keys any query of the tile can see; nothing past the chain exists.
  const int kv_end = min(base + min(q0 + kBQ, T), chain.capacity());
  attend_f32<TQ, TKV, D, kBQ, false>(q, k, v, ks, vs, ChainRows{chain, b, h},
                                     bh, T, q0, base + q0, kv_end, out,
                                     nullptr, sm_scale, NoDropout{});
}

// ---------------------------------------------------------------------------
// Prefill on the tensor cores: a bf16 query over a bf16, int8 or int4 pool.
// One block per (row*head, 64-query tile), the grid's y the query tile, the
// longest walk first; a warp owns 16 queries. K/V arrive in 64-position
// chunks of the row's chain through a two-stage cp.async ring, each
// 16-byte piece of a stored row addressed through the block table (so a
// chunk may span several blocks, at any page size and any start).
// ---------------------------------------------------------------------------

constexpr int kPmKC = 64;  // key positions per chunk
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one instance: Q; for a quantized pool the widened bf16
// K and V tiles and the chunk's k and v scales; then two ring stages. A
// stage holds a chunk as the pool stores it: swizzled bf16 K and V tiles,
// or the K and V bytes unswizzled (D or D/2 a position) and the scales.
template <typename TKV, int D>
struct PrefillMma {
  using L = KV<TKV>;
  // 4 warps (64 queries) at every head_dim: 8 warps at D <= 64 measured
  // 2.5% faster on the bf16 wave but 14-20% slower on the int8/int4 waves
  // and slower on small prefills (PERF.md, section 6).
  static constexpr int kWarps = 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBM = 16 * kWarps;  // queries per block
  static constexpr bool kQuant = L::kQuant;
  static constexpr int kRowBytes =
      D * static_cast<int>(sizeof(typename L::S)) / L::kDiv;
  static constexpr int kPieces = kRowBytes / 16;  // 16-byte pieces a row
  static constexpr uint32_t kQ = kBM * D * sizeof(bf16);
  static constexpr uint32_t kTile = kPmKC * D * sizeof(bf16);  // K or V
  static constexpr uint32_t kRaw = kPmKC * kRowBytes;  // stored K or V
  static constexpr uint32_t kScales = 2 * kPmKC * sizeof(float);
  static constexpr uint32_t kWide = kQuant ? 2 * kTile + kScales : 0;
  static constexpr uint32_t kStage = kQuant ? 2 * kRaw + kScales : 2 * kTile;
  static constexpr size_t kSmem = kQ + kWide + 2 * kStage;
  static_assert(kRowBytes % 16 == 0, "whole 16-byte pieces a row");
};

// Byte j of x, two int4 values, widened to a bf16 pair: the low nibble is
// the even dim; each is biased by +8.
__device__ __forceinline__ uint32_t nibbles(uint32_t x, int j) {
  const int byte = (x >> (8 * j)) & 0xff;
  return pack_bf16(static_cast<float>((byte & 15) - 8),
                   static_cast<float>((byte >> 4) - 8));
}

// A quantized chunk's stored bytes at raw, widened to the swizzled bf16 K
// and V tiles at wide (exact: int8 values lie in [-127, 127], int4 values
// in [-8, 7]), and its scales
// copied beside them, so the ring stage is free once this returns.
template <typename TKV, int D>
__device__ __forceinline__ void widen_chunk(const unsigned char* raw,
                                            unsigned char* wide) {
  using P = PrefillMma<TKV, D>;
  constexpr int kOut = kPmKC * D / 8;  // 16-byte bf16 chunks of a tile
  constexpr int kIn = P::kRowBytes * 8 / D;  // stored bytes behind one
#pragma unroll 4
  for (int i = 0; i < 2 * kOut / P::kThreads; ++i) {
    const int e = threadIdx.x + i * P::kThreads;
    const int tile = e / kOut, r = (e % kOut) / (D / 8), c = e % (D / 8);
    const unsigned char* src = raw + tile * P::kRaw + r * P::kRowBytes +
                               c * kIn;
    uint4 o;
    if constexpr (std::is_same<TKV, int8_t>::value) {
      const uint2 x = *reinterpret_cast<const uint2*>(src);
      o = make_uint4(pack_bf16(sbyte(x.x, 0), sbyte(x.x, 1)),
                     pack_bf16(sbyte(x.x, 2), sbyte(x.x, 3)),
                     pack_bf16(sbyte(x.y, 0), sbyte(x.y, 1)),
                     pack_bf16(sbyte(x.y, 2), sbyte(x.y, 3)));
    } else {
      const uint32_t x = *reinterpret_cast<const uint32_t*>(src);
      o = make_uint4(nibbles(x, 0), nibbles(x, 1), nibbles(x, 2),
                     nibbles(x, 3));
    }
    *reinterpret_cast<uint4*>(wide + tile * P::kTile + swz<D>(r, c)) = o;
  }
  const float* s_in = reinterpret_cast<const float*>(raw + 2 * P::kRaw);
  float* s_out = reinterpret_cast<float*>(wide + 2 * P::kTile);
  for (int j = threadIdx.x; j < 2 * kPmKC; j += P::kThreads)
    s_out[j] = s_in[j];
}

template <typename TKV, int D>
__global__ void __launch_bounds__(PrefillMma<TKV, D>::kThreads)
paged_prefill_mma_kernel(const bf16* __restrict__ q,
                         const typename KV<TKV>::S* __restrict__ k,
                         const typename KV<TKV>::S* __restrict__ v,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ table,
                         const int* __restrict__ start, bf16* __restrict__ out,
                         int H, int T, int N, int page, int nb,
                         float sm_scale) {
  using P = PrefillMma<TKV, D>;
  constexpr bool kQuant = P::kQuant;
  constexpr int kThreads = P::kThreads, kBM = P::kBM;
  constexpr int kKS = D / 16;     // k-steps of Q K^T
  constexpr int kNT = kPmKC / 8;  // 8-key column slices of a score tile
  constexpr int kDT = D / 8;      // 8-wide column slices of o
  extern __shared__ __align__(128) unsigned char smem_pm[];
  const uint32_t q_s = smem_addr(smem_pm);
  unsigned char* wide = smem_pm + P::kQ;
  const uint32_t ring = q_s + P::kQ + P::kWide;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t qbase = static_cast<int64_t>(bh) * T * D;
  const PagedChain chain{table, nb, N, page, H};
  const int base = start[b];  // position of query 0 of this row
  // Keys any query of the tile can see; nothing past the chain exists.
  const int kv_end = min(base + min(q0 + kBM, T), chain.capacity());
  const int n_chunks = (kv_end + kPmKC - 1) / kPmKC;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);

  // Chunk c into ring stage `slot`; positions at or past kv_end are zero.
  auto load_chunk = [&](int c, int slot) {
    const uint32_t st = ring + slot * P::kStage;
    const uint32_t v_off = kQuant ? P::kRaw : P::kTile;
    const int c0 = c * kPmKC;
#pragma unroll 1
    for (int e = threadIdx.x; e < kPmKC * P::kPieces; e += kThreads) {
      const int r = e / P::kPieces, p = e % P::kPieces, pos = c0 + r;
      const bool in = pos < kv_end;
      const int64_t off =
          in ? (chain.base(b, h, pos / page) + pos % page) * P::kRowBytes +
                   16 * p
             : 0;
      const uint32_t dst =
          st + (kQuant ? r * P::kRowBytes + 16 * p : swz<D>(r, p));
      cp_async16(dst, kb + off, in ? 16 : 0);
      cp_async16(dst + v_off, vb + off, in ? 16 : 0);
    }
    if constexpr (kQuant) {
#pragma unroll 1
      for (int r = threadIdx.x; r < kPmKC; r += kThreads) {
        const int pos = c0 + r;
        const bool in = pos < kv_end;
        const int64_t row = in ? chain.base(b, h, pos / page) + pos % page : 0;
        const uint32_t dst = st + 2 * P::kRaw + 4 * r;
        cp_async4(dst, ks + row, in ? 4 : 0);
        cp_async4(dst + 4 * kPmKC, vs + row, in ? 4 : 0);
      }
    }
  };

  load_rows<kBM, D, kThreads>(q_s, q + qbase, q0, T);
  cp_async_commit();
  load_chunk(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  const int r_lo = q0 + 16 * warp;  // the warp's first query
  const int i0 = r_lo + g, i1 = i0 + 8;
  const int qp_lo = base + r_lo, qp0 = base + i0, qp1 = base + i1;
  uint32_t qf[kKS][4];
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk)
    ldsm_x4(qf[kk], q_s + swz<D>(16 * warp + (lane & 15),
                                 2 * kk + (lane >> 4)));

  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  // Rows i0 and i1: running max (log2 units) and this lane's part of l.
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float scale2 = sm_scale * kLog2e;

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kPmKC;
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // chunk c has landed
    __syncthreads();
    const uint32_t st = ring + (c & 1) * P::kStage;
    uint32_t k_s = st, v_s = st + P::kTile;
    const float *ks_c = nullptr, *vs_c = nullptr;
    if constexpr (kQuant) {
      // The next chunk's bytes stay in flight while this one widens.
      widen_chunk<TKV, D>(smem_pm + (st - q_s), wide);
      __syncthreads();
      k_s = q_s + P::kQ;
      v_s = k_s + P::kTile;
      ks_c = reinterpret_cast<const float*>(wide + 2 * P::kTile);
      vs_c = ks_c + kPmKC;
    }
    // Warp-uniform: a chunk whose keys all lie past the warp's last query,
    // or a warp whose rows all lie past T, adds nothing.
    if (c0 <= qp_lo + 15 && r_lo < T) {
      float s[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
        for (int np = 0; np < kNT; np += 2) {
          uint32_t bfr[4];
          ldsm_x4(bfr, k_s + swz<D>(8 * np + (lane & 7) + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1)));
          mma_bf16(s[np], qf[kk], bfr[0], bfr[1]);
          mma_bf16(s[np + 1], qf[kk], bfr[2], bfr[3]);
        }
      // A chunk wholly at or before the warp's first query position is
      // causally valid for every (query, key) pair and skips the compare
      // (the Pallas kernel's inner/frontier split); frontier and tail
      // chunks compare positions.
      const bool masked = c0 + kPmKC - 1 > qp_lo || c0 + kPmKC > kv_end;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int jl = 8 * nt + 2 * t + e, j = c0 + jl;
          // s = (q . k_int) * k_scale * sm_scale, in f32 after the product.
          const float sc = kQuant ? ks_c[jl] * scale2 : scale2;
          float x0 = s[nt][e] * sc, x1 = s[nt][2 + e] * sc;
          if (masked) {
            if (j > qp0 || j >= kv_end) x0 = kNegInf;
            if (j > qp1 || j >= kv_end) x1 = kNegInf;
          }
          s[nt][e] = x0;
          s[nt][2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      // p as the A fragments of p.v: k-step kk takes slices 2kk, 2kk + 1.
      // l sums the unscaled p; p * v_scale is rounded to bf16 (JAX feeds
      // the MXU in the query's dtype).
      uint32_t pf[kNT / 2][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float p00 = exp2f(s[nt][0] - m0), p01 = exp2f(s[nt][1] - m0);
        float p10 = exp2f(s[nt][2] - m1), p11 = exp2f(s[nt][3] - m1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        if constexpr (kQuant) {
          const float v0 = vs_c[8 * nt + 2 * t], v1 = vs_c[8 * nt + 2 * t + 1];
          p00 *= v0;
          p01 *= v1;
          p10 *= v0;
          p11 *= v1;
        }
        pf[nt >> 1][(nt & 1) * 2] = pack_bf16(p00, p01);
        pf[nt >> 1][(nt & 1) * 2 + 1] = pack_bf16(p10, p11);
      }
      l0 = al0 * l0 + sum0;
      l1 = al1 * l1 + sum1;
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        acc[dt][0] *= al0;
        acc[dt][1] *= al0;
        acc[dt][2] *= al1;
        acc[dt][3] *= al1;
      }
#pragma unroll
      for (int kk = 0; kk < kPmKC / 16; ++kk)
#pragma unroll
        for (int dp = 0; dp < kDT; dp += 2) {
          uint32_t bfr[4];
          ldsm_x4_t(bfr, v_s + swz<D>(16 * kk + (lane & 15), dp + (lane >> 4)));
          mma_bf16(acc[dp], pf[kk], bfr[0], bfr[1]);
          mma_bf16(acc[dp + 1], pf[kk], bfr[2], bfr[3]);
        }
    }
    // A bf16 pool's stage c & 1 is refilled by the next iteration: every
    // warp must be done with it. A quantized chunk left its stage at the
    // widening barrier, and its widened tiles are rewritten only after the
    // next iteration's first barrier.
    if constexpr (!kQuant) __syncthreads();
  }
  cp_async_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = 8 * dt + 2 * t;
    if (i0 < T)
      *reinterpret_cast<uint32_t*>(out + qbase + static_cast<int64_t>(i0) * D +
                                   col) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (i1 < T)
      *reinterpret_cast<uint32_t*>(out + qbase + static_cast<int64_t>(i1) * D +
                                   col) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
}

struct LaunchDecode {
  template <typename TQ, typename TKV, int D>
  static void run(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* table,
                  const int* lengths, void* out, float* part, int* tickets,
                  int B, int H, int N, int page, int nb, int S, int Ls,
                  float sm_scale, cudaStream_t stream) {
    using S_ = typename KV<TKV>::S;
    paged_decode_kernel<TQ, TKV, D><<<dim3(H, B, S), kDecThreads, 0,
                                      stream>>>(
        static_cast<const TQ*>(q), static_cast<const S_*>(k),
        static_cast<const S_*>(v), ks, vs, table, lengths,
        static_cast<TQ*>(out), part, tickets, H, N, page, nb, Ls, sm_scale);
  }
};

// The f32 K1 with kBQ-query blocks.
template <typename TQ, typename TKV, int D, int kBQ>
void launch_prefill_f32(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* table,
                        const int* start, void* out, int B, int H, int T,
                        int N, int page, int nb, float sm_scale,
                        cudaStream_t stream) {
  using P = TilesF32<TKV, D, kBQ>;
  using S = typename KV<TKV>::S;
  constexpr size_t smem = P::kSmem;
  if (cudaFuncSetAttribute(paged_prefill_f32_kernel<TQ, TKV, D, kBQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return;
  const dim3 grid(B * H, (T + kBQ - 1) / kBQ);
  paged_prefill_f32_kernel<TQ, TKV, D, kBQ><<<grid, P::kThreads, smem,
                                              stream>>>(
      static_cast<const TQ*>(q), static_cast<const S*>(k),
      static_cast<const S*>(v), ks, vs, table, start, static_cast<TQ*>(out),
      H, T, N, page, nb, sm_scale);
}

// A bf16 query over a bf16, int8 or int4 pool takes the tensor-core kernel;
// an fp32 query, or any query over an fp32 pool, the f32 CUDA-core one,
// with the query tile of wide_query_tiles (attend_f32.cuh).
struct LaunchPrefill {
  template <typename TQ, typename TKV, int D>
  static void run(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* table,
                  const int* start, void* out, int B, int H, int T, int N,
                  int page, int nb, float sm_scale, cudaStream_t stream) {
    using S = typename KV<TKV>::S;
    if constexpr (std::is_same<TQ, bf16>::value &&
                  !std::is_same<TKV, float>::value) {
      using P = PrefillMma<TKV, D>;
      constexpr size_t smem = P::kSmem;
      // Above 48 KB, dynamic shared memory has to be allowed per kernel;
      // a refusal is left for the entry point's cudaGetLastError().
      if (cudaFuncSetAttribute(paged_prefill_mma_kernel<TKV, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem)) != cudaSuccess)
        return;
      const dim3 grid(B * H, (T + P::kBM - 1) / P::kBM);
      paged_prefill_mma_kernel<TKV, D><<<grid, P::kThreads, smem, stream>>>(
          static_cast<const bf16*>(q), static_cast<const S*>(k),
          static_cast<const S*>(v), ks, vs, table, start,
          static_cast<bf16*>(out), H, T, N, page, nb, sm_scale);
    } else {
      if (wide_query_tiles(static_cast<int64_t>(B) * H, T))
        launch_prefill_f32<TQ, TKV, D, 64>(q, k, v, ks, vs, table, start,
                                           out, B, H, T, N, page, nb,
                                           sm_scale, stream);
      else
        launch_prefill_f32<TQ, TKV, D, 32>(q, k, v, ks, vs, table, start,
                                           out, B, H, T, N, page, nb,
                                           sm_scale, stream);
    }
  }
};

}  // namespace
}  // namespace nsb

extern "C" {

// Returns a cudaError_t: cudaSuccess (0) once the kernel is queued. D is
// the logical head_dim (twice the stored bytes of a packed int4 row). S
// splits of Ls positions each (ops/flash_decode.py decode_splits): Ls a
// whole number of pages, at most kMaxSplitPages of them, Ls * page below
// 2^31, S * Ls covering the chain; part a (B*H, S, D + 2) f32 scratch
// when S > 1; tickets (B*H,) int32, zero, left zero.
int nsb_paged_decode(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int* table, const int* lengths, void* out,
                     float* part, int* tickets, int B, int H, int D, int N,
                     int page, int nb, int S, int Ls, float sm_scale,
                     int q_dtype, int kv_dtype, void* stream) {
  if (page < 1 || S < 1 || Ls < page || Ls % page != 0 ||
      Ls / page > nsb::kMaxSplitPages ||
      static_cast<long long>(Ls) * page >= (1ll << 31) ||
      static_cast<long long>(S) * Ls < static_cast<long long>(nb) * page ||
      tickets == nullptr || (S > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!nsb::dispatch<nsb::LaunchDecode>(
          q_dtype, kv_dtype, D, q, k, v, k_scale, v_scale, table, lengths,
          out, part, tickets, B, H, N, page, nb, S, Ls, sm_scale,
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
