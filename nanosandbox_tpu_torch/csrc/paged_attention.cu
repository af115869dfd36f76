// Paged attention over a block-paged KV pool, for Hopper (sm_90a).
//
// The CUDA counterparts of two Pallas kernels in
// nanosandbox_tpu/ops/flash_decode.py:
//
//   paged_decode_kernel  <- _paged_decode_kernel  (flash_decode_paged, K2)
//       one query per (row, head) over the row's block chain, up to
//       lengths[b] positions (decode_common.cuh decode_row over a
//       PagedChain). Bound by bytes: every position of the chain is read
//       once (K and V, and their scales in the int8/int4 modes) for 4*D
//       flops. One block per (row, head) leaves a long row to one SM's
//       share of the memory rate, and B*H blocks (96 at 8 slots)
//       under-fill 132 SMs; splitting a row's chain over blocks is later
//       work.
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
//     TFLOP/s) and the shared-memory reads that feed it. A block owns 32
//     queries of one (row, head), or 64 once such blocks fill every SM
//     twice over (192 blocks for the 132 SMs at B 2, T 256; 64-query
//     blocks at an 8 x 512 wave), and reads the row's chain once, in
//     64-position chunks (32 at D 128, so two blocks share an SM) through
//     a two-stage cp.async ring addressed as above; an fp32 chunk lands as
//     f32 tiles of rows padded by 4 floats, a bf16, int8 or int4 chunk as
//     its stored bytes and scales, widened to such tiles (exact) with the
//     next chunk in flight.
//     Each thread's 4 x 4 micro-tile of scores is read as float4, four
//     deep along D; p goes to shared memory once per chunk and p.v reads
//     it as float4. The scales and sm_scale fold as in the Pallas kernel:
//     s = (q . k) * k_scale * sm_scale in f32 after the product, l sums
//     the unscaled p, and p * v_scale feeds p.v in f32 (JAX's dot dtype
//     for every pair this kernel takes).
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

#include <type_traits>

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
                    int H, int N, int page, int nb, float sm_scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  decode_row<TQ, TKV, D>(q, k, v, ks, vs, PagedChain{table, nb, N, page, H},
                         lengths[b], out, b, h, H, sm_scale);
}

// ---------------------------------------------------------------------------
// Prefill on CUDA cores in f32: an fp32 query over any pool, or a bf16
// query over an fp32 pool. One block per (row*head, query tile of 32 or
// 64), the grid's y the query tile, the longest walk first; kKC-position
// K/V chunks stream through a two-stage cp.async ring, each 16-byte piece
// of a stored row addressed through the block table, positions past the
// tile's last visible key zero-filled by the copy. An fp32 chunk lands as
// f32 tiles of rows padded by 4 floats; a bf16, int8 or int4 chunk lands
// as its stored bytes (and scales) and is widened to such tiles (exact),
// with the next chunk in flight. A kTY x 16 grid of threads: thread
// (ty, tx) owns queries ty + kTY a and keys tx + 16b of the score tile,
// read as float4 four deep along D, the online softmax in registers (a
// row's max and sum over its 16 lanes); p goes to shared memory once per
// chunk, and p.v gives the thread the same queries and the D/16 output
// columns from tx D/16, read as float4.
// ---------------------------------------------------------------------------

// kBQ queries a block, 32 or 64, with 4 kBQ threads (see LaunchPrefill):
// 4 x 4 micro-tiles; 8 x 4 with half the threads measured 6-11% slower at
// the wave (PERF.md, section 6).
template <typename TKV, int D, int kBQ_>
struct PrefillF32 {
  using L = KV<TKV>;
  static constexpr int kBQ = kBQ_;
  static constexpr int kThreads = 4 * kBQ;
  // Key positions a chunk: 32 at D 128, so two blocks still share an SM.
  static constexpr int kKC = D == 128 ? 32 : 64;
  static constexpr int kTY = kThreads / 16;  // rows of the thread grid
  static constexpr int kQR = kBQ / kTY;  // queries a thread: ty + kTY a
  static constexpr int kKB = kKC / 16;  // keys a thread: tx + 16b
  static constexpr int kCW = D / 16;    // output columns a thread
  static constexpr int kDR = D + 4;     // padded row of Q, K, V (floats)
  static constexpr int kPR = kKC + 16;  // padded row of p: a warp's two
                                        // rows fall 16 banks apart
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
  // A stage holds a chunk as f32 tiles (fp32 pool) or as stored bytes and
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
  if constexpr (std::is_same<TKV, bf16>::value) {
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

template <typename TQ, typename TKV, int D, int kBQ_>
__global__ void __launch_bounds__(PrefillF32<TKV, D, kBQ_>::kThreads, 2)
paged_prefill_f32_kernel(const TQ* __restrict__ q,
                         const typename KV<TKV>::S* __restrict__ k,
                         const typename KV<TKV>::S* __restrict__ v,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ table,
                         const int* __restrict__ start, TQ* __restrict__ out,
                         int H, int T, int N, int page, int nb,
                         float sm_scale) {
  using P = PrefillF32<TKV, D, kBQ_>;
  constexpr bool kQuant = P::kQuant, kWiden = P::kWiden;
  constexpr int kThreads = P::kThreads, kBQ = P::kBQ, kKC = P::kKC;
  constexpr int kTY = P::kTY, kQR = P::kQR, kKB = P::kKB, kCW = P::kCW;
  constexpr int kDR = P::kDR, kPR = P::kPR;
  extern __shared__ __align__(128) unsigned char smem_pf[];
  float* q_s = reinterpret_cast<float*>(smem_pf);
  float* p_s = reinterpret_cast<float*>(smem_pf + P::kQ);
  float* wide = reinterpret_cast<float*>(smem_pf + P::kQ + P::kP);
  unsigned char* ring =
      smem_pf + P::kQ + P::kP + (kWiden ? 2 * P::kTile : 0);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t qbase = static_cast<int64_t>(bh) * T * D;
  const PagedChain chain{table, nb, N, page, H};
  const int base = start[b];  // position of query 0 of this row
  // Keys any query of the tile can see; nothing past the chain exists.
  const int kv_end = min(base + min(q0 + kBQ, T), chain.capacity());
  const int n_chunks = (kv_end + kKC - 1) / kKC;
  const int first_qpos = base + q0;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);

  // Chunk c into ring stage `slot`; positions at or past kv_end are zero.
  auto load_chunk = [&](int c, int slot) {
    const uint32_t st = smem_addr(ring + slot * P::kStage);
    const uint32_t v_off = kWiden ? P::kRaw : P::kTile;
    const int c0 = c * kKC;
#pragma unroll 1
    for (int e = threadIdx.x; e < kKC * P::kPieces; e += kThreads) {
      const int r = e / P::kPieces, p = e % P::kPieces, pos = c0 + r;
      const bool in = pos < kv_end;
      const int64_t off =
          in ? (chain.base(b, h, pos / page) + pos % page) * P::kRowBytes +
                   16 * p
             : 0;
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
        const int64_t row = in ? chain.base(b, h, pos / page) + pos % page : 0;
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
        KV<bf16>::load(q + qbase + static_cast<int64_t>(q0 + r) * D, c, x);
      float* dst = q_s + r * kDR + c;
      *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
  cp_async_commit();
  load_chunk(0, 0);
  cp_async_commit();

  float m[kQR], l[kQR], acc[kQR][kCW];
#pragma unroll
  for (int a = 0; a < kQR; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int cc = 0; cc < kCW; ++cc) acc[a][cc] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int c0 = c * kKC;
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and chunk c have landed
    __syncthreads();
    const unsigned char* st = ring + (c & 1) * P::kStage;
    const float* k_t = reinterpret_cast<const float*>(st);
    const float* ks_c = reinterpret_cast<const float*>(st + 2 * P::kRaw);
    const float* vs_c = ks_c + kKC;
    if constexpr (kWiden) {
      // Stored bytes to f32 tiles; the next chunk stays in flight.
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
    // Pallas kernel computes it. A chunk wholly at or before the tile's
    // first query position is causally valid for every (query, key) pair
    // and skips the compare (the Pallas kernel's inner/frontier split);
    // frontier and tail chunks compare positions.
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
        sum += p;  // l sums the unscaled p; the v scale folds in here
        p_s[il * kPR + jl] = kQuant ? p * vs_c[jl] : p;
      }
      l[a] = alpha * l[a] + row_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int cc = 0; cc < kCW; ++cc) acc[a][cc] *= alpha;
    }
    __syncthreads();  // p complete

    // p.v: queries ty + kTY a, columns tx kCW + cc. p stays f32, JAX's dot
    // dtype for every pair this kernel takes.
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
    }
  }
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
                  const int* lengths, void* out, int B, int H, int N,
                  int page, int nb, float sm_scale, cudaStream_t stream) {
    using S = typename KV<TKV>::S;
    paged_decode_kernel<TQ, TKV, D><<<dim3(H, B), kDecThreads, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const S*>(k),
        static_cast<const S*>(v), ks, vs, table, lengths,
        static_cast<TQ*>(out), H, N, page, nb, sm_scale);
  }
};

// The f32 K1 with kBQ-query blocks.
template <typename TQ, typename TKV, int D, int kBQ>
void launch_prefill_f32(const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* table,
                        const int* start, void* out, int B, int H, int T,
                        int N, int page, int nb, float sm_scale,
                        cudaStream_t stream) {
  using P = PrefillF32<TKV, D, kBQ>;
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

// SMs of the current device, read once.
int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

// A bf16 query over a bf16, int8 or int4 pool takes the tensor-core kernel;
// an fp32 query, or any query over an fp32 pool, the f32 CUDA-core one:
// with 64-query blocks once those fill every SM twice over (an admission
// wave: each block then reads the row's chain for 64 queries), else with
// 32-query blocks, so a small prefill still spreads over every SM (B 2,
// T 256: 192 blocks; PERF.md, section 6).
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
      const int64_t blocks64 = static_cast<int64_t>(B) * H * ((T + 63) / 64);
      if (blocks64 >= 2 * sm_count())
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
