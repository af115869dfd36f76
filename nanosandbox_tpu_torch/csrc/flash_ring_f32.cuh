// The fp32 flash-attention kernels of ring attention's non-causal blocks,
// for Hopper (sm_90a), included by flash_attention.cu, whose nsb_flash_fwd
// and nsb_flash_bwd send every non-causal fp32 call here:
//
//   flash_fwd_ring_f32_kernel<D, kDrop>   <- nanosandbox_tpu/ops/
//     attention.py _flash_fwd_kernel (K4), causal=False;
//   flash_bwd_ring_prep_kernel<D, true> + flash_bwd_ring_f32_kernel<D, kBK,
//     true, kDrop> <- _flash_bwd_tiles_kernel(with_dq=True) (K5);
//   flash_bwd_dq_ring_f32_kernel<D, kBQ, kDrop> <- _flash_bwd_dq_kernel
//     (K6), the split backward's dQ pass;
//   flash_bwd_ring_prep_kernel<D, false> + flash_bwd_ring_f32_kernel<D,
//     kBK, false, kDrop> <- _flash_bwd_tiles_kernel(with_dq=False) (K7),
//     the split backward's dK/dV pass;
//
// all causal=False, the backwards with or without the lse cotangent dlse.
//
// Every product is an exact f32 fmaf on the CUDA cores: the fp32 kernels
// are held to 1e-5 (o, lse) and 1e-4 (gradients) of the plain version with
// TF32 off, which bf16 or TF32 products would not meet. What bounds them is
// the f32 FMA rate (67 TFLOP/s: at the ring's block, B 1, H 12, T 1024,
// D 64, K4's 3.2 GFLOP take 0.048 ms, K5's 8.1 GFLOP 0.120 ms, K6's 4.8
// 0.072 ms and K7's 6.4 0.096 ms) and the shared-memory reads that feed
// it, as in flash_attention.cu's f32 kernels: rows padded to D + 4 floats,
// tiles landed by 16-byte cp.async and read as float4, 4 x 4 micro-tiles
// read four deep along the contracted dimension.
//
// flash_attention.cu's f32 kernels were designed for the causal training
// shape (B 16). At the ring's block, B 1, their K4 launches 384 blocks that
// fit two to an SM (1.45 waves on 132 SMs, 8 warps an SM) and their K5, K6
// and K7 192 blocks of 256 threads (0.73 waves: 72 SMs hold one block, and
// nothing hides its loads). These kernels cut the work finer and hold more
// of it on an SM at once:
//   - K4: a block owns 32 queries of one (row, head) with 128 threads and
//     walks every key tile (64 keys, 32 at D 128), on attend_f32.cuh's
//     thread grid. K and V of a tile land in buffers of their own, each
//     loaded while the other is read: K of tile c + 1 while p.v reads V of
//     tile c, V of tile c + 1 (issued as p.v ends) while the scores read K
//     of tile c + 1. One buffer of each makes 53,760 bytes of shared memory
//     a block at D 64 (88,576 with the two-stage ring of both), so four
//     blocks, 16 warps, share an SM at 128 registers a thread, and the 384
//     blocks of B 1 run in one wave of 528 slots.
//   - K5: a block owns kBK keys of one (row, head) with 4 kBK threads and
//     walks every 64-query tile (32 at D 128): S^T = K Q^T and dP^T = V dO^T
//     (keys ty + 8a, queries tx + 16b), P~^T and dS^T to shared memory, then
//     dK += dS^T Q, then dV += P~^T dO, then dQ = dS K over the tile, scaled
//     by sm_scale and added into the f32 dq with 16-byte atomics. Q and lse
//     of the next tile load as soon as dK has read Q, dO and Drow as soon as
//     dV has read dO, so each load overlaps the products left in the tile.
//     32-key blocks take 70,144 bytes of shared memory at D 64: three
//     blocks, 12 warps, an SM, and the 384 blocks of B 1 run in one wave of
//     396 slots. Once 64-key blocks fill every SM twice over (B 2 and up),
//     those run instead, two an SM, 16 warps: there the finer grid gains
//     nothing and measured 1-4% slower. The pre-pass computes Drow =
//     rowsum(dO o) - dlse once per row and zeroes dq. Every block writes
//     only its own keys' dK and dV, so those are the same bits on every
//     call; dQ's summation order changes from run to run.
//   - K7: K5's kernel without its dQ half (kWithDq = false compiles out
//     dQ = dS K and its atomics; dS^T stays, for dK), after the pre-pass
//     without the zeroing, on K5's choice of key blocks. It writes only its
//     own keys' dK and dV: the same bits on every call.
//   - K6: K4's walk with the backward's products. A block owns 32 queries
//     of one (row, head) with 128 threads on the same 8 x 16 thread grid
//     (64 queries with 256 threads, two an SM, once those fill every SM
//     twice over, as K5's and K7's key blocks: 5-9% faster there); Q, dO
//     and, in registers, each thread's rows' lse (in log2 units) and
//     Drow = rowsum(dO o) - dlse (computed at the start by the 16 lanes of
//     a row from o and dO in device memory) stay resident. For every key
//     tile (64 keys, 32 at D 128): dP = dO V^T, S = Q K^T, p = exp2 of the
//     log2(e)-scaled scores less lse, dS = p (dP~ - Drow) to shared memory
//     once, dQ += dS K. K is read twice a tile and V once, hence that
//     order: V of tile c + 1 loads as soon as dP has read V (overlapping S,
//     dS and dQ), K of tile c + 1 once dQ has read K (overlapping dP).
//     dQ stays in registers to one store, scaled by sm_scale: no atomics,
//     so K6 + K7 give the same bits on every call. Q, dO, one K and one V
//     buffer and the dS tile of 32 queries take 62,464 bytes at D 64: three
//     blocks an SM, and the 384 blocks of B 1 run in one wave of 396
//     slots. Four would
//     need at most 57,344 bytes a block: the dS tile (10,240 bytes) would
//     have to leave shared memory, by shuffles over a row's 16 lanes (one
//     shuffle for every 4 FMAs of dQ += dS K, where a 16-byte load of dS
//     feeds 16), or share V's buffer, whose next tile could then load only
//     after dQ and would stall the next dP.
//   - Dropout is a template instance, chosen at launch, and the tail (keys
//     or queries past T) an instance of the per-element step, chosen per
//     tile: no uniform branch sits in a per-element loop, where it would
//     expose each exponential's latency.
//
// Numerics are flash_attention.cu's f32 kernels': scores scaled in f32
// after the product, the forward's l sums the unmasked p, dropout touches
// only the p.v sum (and dP), ds = p (dp - Drow), dK and dQ scaled by
// sm_scale at the end. K4 scales by sm_scale log2(e) and takes exp2, as
// the tensor-core kernels do (lse is stored in natural log), and sums each
// lane's part of l, reducing a row's 16 parts once at the end: 4% off its
// time on an H100 at B 1 and B 4, its error against the plain version
// unmoved (PERF.md section 6); K6 takes exp2 the same way. Layouts as
// flash_attention.cu's: q, k, v, o, dO, dq, dk, dv (B*H, T, D) f32, lse,
// dlse and Drow (B*H, T) f32.

#pragma once

#include <stdint.h>

#include "decode_common.cuh"
#include "dropout.cuh"
#include "mma_common.cuh"

// In the unnamed namespace of the source that includes it, as
// flash_attention.cu's own kernels are: kernels in nsb's unnamed namespace
// as well would give the host stub's registration two unnamed namespaces
// to name through flash_attention.cu's `using namespace nsb`.
namespace {

using namespace nsb;

// The two products every kernel here is made of, on a (blockDim / 16) x 16
// thread grid (ty = threadIdx.x / 16, tx = threadIdx.x % 16) over f32
// tiles in shared memory whose rows are padded to D + 4 floats.

// acc[a][b] = A[ty + kTY a] . B[tx + 16 b] over the D columns, both rows
// read as float4, four deep (S = Q K^T, dP = dO V^T and their transposes).
template <int D, int kTY, int kA, int kB>
__device__ __forceinline__ void ring_rows_dot(const float* __restrict__ a_s,
                                              const float* __restrict__ b_s,
                                              float (&acc)[kA][kB]) {
  constexpr int kDR = D + 4;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < kA; ++a)
#pragma unroll
    for (int b = 0; b < kB; ++b) acc[a][b] = 0.f;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float ax[kA][4], bx[kB][4];
#pragma unroll
    for (int a = 0; a < kA; ++a) lds<4>(a_s + (ty + kTY * a) * kDR + d, ax[a]);
#pragma unroll
    for (int b = 0; b < kB; ++b) lds<4>(b_s + (tx + 16 * b) * kDR + d, bx[b]);
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int a = 0; a < kA; ++a)
#pragma unroll
        for (int b = 0; b < kB; ++b)
          acc[a][b] = fmaf(ax[a][e], bx[b][e], acc[a][b]);
  }
}

// acc[a][c] += sum over j < kJ of P[ty + kTY a][j] V[j][tx D/16 + c]: P's
// rows padded to kPR floats and read as float4 four deep along j, V's to
// D + 4 (p.v, dQ += dS K, dK += dS^T Q, dV += P~^T dO).
template <int D, int kTY, int kA, int kJ, int kPR>
__device__ __forceinline__ void ring_rows_times(
    const float* __restrict__ p_s, const float* __restrict__ v_s,
    float (&acc)[kA][D / 16]) {
  constexpr int kDR = D + 4, kCW = D / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < kJ; j += 4) {
    float px[kA][4];
#pragma unroll
    for (int a = 0; a < kA; ++a) lds<4>(p_s + (ty + kTY * a) * kPR + j, px[a]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float vx[kCW];
      lds<kCW>(v_s + (j + e) * kDR + tx * kCW, vx);
#pragma unroll
      for (int a = 0; a < kA; ++a)
#pragma unroll
        for (int c = 0; c < kCW; ++c)
          acc[a][c] = fmaf(px[a][e], vx[c], acc[a][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4
// ---------------------------------------------------------------------------

template <int D>
struct RingFwdF32 {
  static constexpr int kBQ = 32;                  // queries a block
  static constexpr int kThreads = 4 * kBQ;        // an 8 x 16 thread grid
  static constexpr int kKC = D == 128 ? 32 : 64;  // keys a tile
  static constexpr int kTY = kThreads / 16;
  static constexpr int kQR = kBQ / kTY;  // queries a thread: ty + kTY a
  static constexpr int kKB = kKC / 16;   // keys a thread: tx + 16 b
  static constexpr int kCW = D / 16;     // output columns a thread
  static constexpr int kDR = D + 4;      // padded row of Q, K, V (floats)
  static constexpr int kPR = kKC + 16;   // padded row of p: a warp's two
                                         // rows 16 banks apart
  // Four blocks an SM (128 registers a thread); three at D 128.
  static constexpr int kMinBlocks = D == 128 ? 3 : 4;
  static constexpr int kQ = kBQ * kDR, kKV = kKC * kDR, kP = kBQ * kPR;
  static constexpr size_t kSmem = sizeof(float) * (kQ + 2 * kKV + kP);
};

// The online softmax of one key tile's scores s (queries ty + kTY a, keys
// tx + 16 b; a row's max over its 16 lanes), in log2 units (scale2 =
// sm_scale log2(e)): p into p_s, dropped and rescaled under kDrop, this
// lane's part of l and acc rescaled to the new max. kTail (the last,
// partial tile) masks keys at or past Tn. kTail and kDrop are
// template arguments so that no branch splits the per-element loop.
template <int D, bool kTail, bool kDrop>
__device__ __forceinline__ void ring_softmax(
    float (&s)[RingFwdF32<D>::kQR][RingFwdF32<D>::kKB],
    float (&m)[RingFwdF32<D>::kQR], float (&l)[RingFwdF32<D>::kQR],
    float (&acc)[RingFwdF32<D>::kQR][RingFwdF32<D>::kCW],
    float* __restrict__ p_s, int c0, int q0, int Tn, float scale2,
    const Dropout& dr) {
  using P = RingFwdF32<D>;
  constexpr int kTY = P::kTY, kQR = P::kQR, kKB = P::kKB, kCW = P::kCW;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < kQR; ++a) {
    const int il = ty + kTY * a;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kKB; ++j) {
      float x = s[a][j] * scale2;
      if (kTail && c0 + tx + 16 * j >= Tn) x = kNegInf;
      s[a][j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m[a], row_max(mx));
    const float alpha = exp2f(m[a] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kKB; ++j) {
      const int jl = tx + 16 * j;
      const float p = exp2f(s[a][j] - m_new);
      sum += p;  // l sums the unmasked p
      float pv = p;
      if (kDrop) pv = dr.keep(q0 + il, c0 + jl) ? p * dr.scale : 0.f;
      p_s[il * P::kPR + jl] = pv;
    }
    l[a] = alpha * l[a] + sum;  // this lane's part; summed at the end
    m[a] = m_new;
#pragma unroll
    for (int cc = 0; cc < kCW; ++cc) acc[a][cc] *= alpha;
  }
}

template <int D, bool kDrop>
__global__ void __launch_bounds__(RingFwdF32<D>::kThreads,
                                  RingFwdF32<D>::kMinBlocks)
flash_fwd_ring_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          float* __restrict__ lse, int H, int Tn,
                          float sm_scale, DropoutArgs da) {
  using P = RingFwdF32<D>;
  constexpr int kThreads = P::kThreads, kKC = P::kKC, kTY = P::kTY;
  constexpr int kQR = P::kQR, kKB = P::kKB, kCW = P::kCW, kPR = P::kPR;
  extern __shared__ __align__(16) float smem_ring[];
  float* q_s = smem_ring;
  float* k_s = q_s + P::kQ;
  float* v_s = k_s + P::kKV;
  float* p_s = v_s + P::kKV;

  const int q0 = blockIdx.x * P::kBQ, bh = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const int n_tiles = (Tn + kKC - 1) / kKC;
  const Dropout dr = kDrop ? make_dropout(da, bh, H) : Dropout{};
  const float scale2 = sm_scale * 1.4426950408889634f;  // log2(e)

  // Q with key tile 0, then V of tile 0: two copy groups.
  load_rows_f32<P::kBQ, D, kThreads>(smem_addr(q_s), q + base, q0, Tn);
  load_rows_f32<kKC, D, kThreads>(smem_addr(k_s), k + base, 0, Tn);
  cp_async_commit();
  load_rows_f32<kKC, D, kThreads>(smem_addr(v_s), v + base, 0, Tn);
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
    cp_async_wait<1>();  // Q and K of tile c have landed; V may not have
    __syncthreads();

    // Scores: queries ty + kTY a, keys tx + 16 b.
    float s[kQR][kKB];
    ring_rows_dot<D, kTY>(q_s, k_s, s);
    if (c0 + kKC > Tn)
      ring_softmax<D, true, kDrop>(s, m, l, acc, p_s, c0, q0, Tn, scale2,
                                   dr);
    else
      ring_softmax<D, false, kDrop>(s, m, l, acc, p_s, c0, q0, Tn, scale2,
                                    dr);
    cp_async_wait<0>();  // V of tile c has landed
    __syncthreads();     // p complete; K is free
    if (c + 1 < n_tiles)
      load_rows_f32<kKC, D, kThreads>(smem_addr(k_s), k + base, c0 + kKC,
                                      Tn);
    cp_async_commit();

    // p.v: queries ty + kTY a, columns tx kCW + cc.
    ring_rows_times<D, kTY, kQR, kKC, kPR>(p_s, v_s, acc);
    __syncthreads();  // V and p are free
    if (c + 1 < n_tiles)
      load_rows_f32<kKC, D, kThreads>(smem_addr(v_s), v + base, c0 + kKC,
                                      Tn);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < kQR; ++a) l[a] = row_sum(l[a]);  // the lanes' parts
#pragma unroll
  for (int a = 0; a < kQR; ++a) {
    const int i = q0 + ty + kTY * a;
    if (i < Tn) {
      float* row = o + base + static_cast<int64_t>(i) * D + tx * kCW;
      if constexpr (kCW % 4 == 0) {
#pragma unroll
        for (int cc = 0; cc < kCW; cc += 4)
          *reinterpret_cast<float4*>(row + cc) =
              make_float4(acc[a][cc] / l[a], acc[a][cc + 1] / l[a],
                          acc[a][cc + 2] / l[a], acc[a][cc + 3] / l[a]);
      } else {
        *reinterpret_cast<float2*>(row) =
            make_float2(acc[a][0] / l[a], acc[a][1] / l[a]);
      }
      if (tx == 0)
        lse[static_cast<int64_t>(bh) * Tn + i] =
            m[a] * 0.6931471805599453f + logf(l[a]);  // ln(2)
    }
  }
}

// ---------------------------------------------------------------------------
// K5
// ---------------------------------------------------------------------------

// kBK keys a block (32, or 64 once such blocks fill the card: run_bwd_ring),
// with 4 kBK threads.
template <int D, int kBK_>
struct RingBwdF32 {
  static constexpr int kBK = kBK_;                // keys a block
  static constexpr int kBQ = D == 128 ? 32 : 64;  // queries a tile
  static constexpr int kThreads = 4 * kBK;  // a (kBK / 4) x 16 thread grid
  static constexpr int kTY = kThreads / 16;
  static constexpr int kKA = kBK / kTY;  // keys a thread: ty + kTY a
  static constexpr int kQB = kBQ / 16;   // queries a thread in S^T: tx + 16b
  static constexpr int kCW = D / 16;     // columns a thread in dK, dV, dQ
  static constexpr int kQD = kBQ / kTY;  // queries a thread in dQ: ty kQD + a
  static constexpr int kDR = D + 4, kPR = kBQ + 4;  // padded rows (floats)
  // 32-key blocks: three an SM (170 registers a thread), two at D 128,
  // where three would need 234 KB of shared memory. 64-key blocks: two an
  // SM (128 registers), one at D 128.
  static constexpr int kMinBlocks =
      kBK == 32 ? (D == 128 ? 2 : 3) : (D == 128 ? 1 : 2);
  static constexpr int kKV = kBK * kDR;  // floats of K or V
  static constexpr int kQT = kBQ * kDR;  // floats of Q or dO
  static constexpr int kPT = kBK * kPR;  // floats of P~^T or dS^T
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kKV + 2 * kQT + 2 * kPT + 2 * kBQ);
};

// P~^T (p dropped and rescaled under kDrop) and dS^T = p (dP~ - Drow) of
// one query tile into shared memory, key-major, from S^T and dP^T (keys
// ty + kTY a, queries tx + 16 b). kTail (keys or queries past Tn in the
// tile) zeroes p there. kTail and kDrop are template arguments so that no
// branch splits the per-element loop.
template <int D, int kBK, bool kTail, bool kDrop>
__device__ __forceinline__ void ring_p_ds(
    const float (&s)[RingBwdF32<D, kBK>::kKA][RingBwdF32<D, kBK>::kQB],
    const float (&dp)[RingBwdF32<D, kBK>::kKA][RingBwdF32<D, kBK>::kQB],
    float* __restrict__ pt_s, float* __restrict__ dst_s,
    const float* __restrict__ lse_s, const float* __restrict__ drow_s,
    int k0, int q0, int Tn, float sm_scale, const Dropout& dr) {
  using P = RingBwdF32<D, kBK>;
  constexpr int kTY = P::kTY, kKA = P::kKA, kQB = P::kQB, kPR = P::kPR;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < kKA; ++a) {
    const int jl = ty + kTY * a, j = k0 + jl;
#pragma unroll
    for (int b = 0; b < kQB; ++b) {
      const int il = tx + 16 * b, i = q0 + il;
      float p = expf(s[a][b] * sm_scale - lse_s[il]);
      if (kTail && (i >= Tn || j >= Tn)) p = 0.f;
      float pv = p, dpv = dp[a][b];
      if (kDrop) {
        const bool keep = dr.keep(i, j);
        pv = keep ? p * dr.scale : 0.f;
        dpv = keep ? dpv * dr.scale : 0.f;
      }
      pt_s[jl * kPR + il] = pv;
      dst_s[jl * kPR + il] = p * (dpv - drow_s[il]);
    }
  }
}

// Drow = rowsum(dO o) - dlse (dlse may be null) for every (row*head, query),
// and under kZeroDq (K5) those rows of dq zeroed for the main kernel's
// atomics: D/4 lanes a row, each a 16-byte load of o and of dO.
template <int D, bool kZeroDq>
__global__ void __launch_bounds__(256)
flash_bwd_ring_prep_kernel(const float* __restrict__ o,
                           const float* __restrict__ dout,
                           const float* __restrict__ dlse,
                           float* __restrict__ drow, float* __restrict__ dq,
                           int64_t n_rows) {
  constexpr int kL = D / 4;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t row = idx / kL;
  const int part = threadIdx.x % kL;
  float acc = 0.f;
  if (row < n_rows) {
    const int64_t off = row * D + 4 * part;
    const float4 a = *reinterpret_cast<const float4*>(o + off);
    const float4 b = *reinterpret_cast<const float4*>(dout + off);
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
    if constexpr (kZeroDq)
      *reinterpret_cast<float4*>(dq + off) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < n_rows)
    drow[row] = dlse != nullptr ? acc - dlse[row] : acc;
}

// K5 (kWithDq) or K7: dq is unused without kWithDq.
template <int D, int kBK, bool kWithDq, bool kDrop>
__global__ void __launch_bounds__(RingBwdF32<D, kBK>::kThreads,
                                  RingBwdF32<D, kBK>::kMinBlocks)
flash_bwd_ring_f32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ drow,
                          float* __restrict__ dq, float* __restrict__ dk,
                          float* __restrict__ dv, int H, int Tn,
                          float sm_scale, DropoutArgs da) {
  using P = RingBwdF32<D, kBK>;
  constexpr int kThreads = P::kThreads, kBQ = P::kBQ;
  constexpr int kTY = P::kTY, kKA = P::kKA, kQB = P::kQB, kCW = P::kCW;
  constexpr int kQD = P::kQD, kDR = P::kDR, kPR = P::kPR;
  extern __shared__ __align__(16) float smem_ring[];
  float* k_s = smem_ring;
  float* v_s = k_s + P::kKV;
  float* q_s = v_s + P::kKV;
  float* do_s = q_s + P::kQT;
  float* pt_s = do_s + P::kQT;   // P~^T, key-major
  float* dst_s = pt_s + P::kPT;  // dS^T, key-major
  float* lse_s = dst_s + P::kPT;
  float* drow_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBK, bh = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const float* lse_bh = lse + static_cast<int64_t>(bh) * Tn;
  const float* drow_bh = drow + static_cast<int64_t>(bh) * Tn;
  const int n_qt = (Tn + kBQ - 1) / kBQ;
  // K5 makes the dropout state once; K7 once a tile, so that it lives only
  // through ring_p_ds: held across the tile, K7's 64-key instance spilled
  // at 128 registers.
  const Dropout dr_k5 =
      kDrop && kWithDq ? make_dropout(da, bh, H) : Dropout{};

  auto load_q = [&](int qt) {  // Q and lse of query tile qt
    load_rows_f32<kBQ, D, kThreads>(smem_addr(q_s), q + base, qt * kBQ, Tn);
    load_floats<kBQ>(smem_addr(lse_s), lse_bh, qt * kBQ, Tn);
  };
  auto load_do = [&](int qt) {  // dO and Drow of query tile qt
    load_rows_f32<kBQ, D, kThreads>(smem_addr(do_s), dout + base, qt * kBQ,
                                    Tn);
    load_floats<kBQ>(smem_addr(drow_s), drow_bh, qt * kBQ, Tn);
  };
  load_rows_f32<kBK, D, kThreads>(smem_addr(k_s), k + base, k0, Tn);
  load_rows_f32<kBK, D, kThreads>(smem_addr(v_s), v + base, k0, Tn);
  load_q(0);
  cp_async_commit();
  load_do(0);
  cp_async_commit();

  float dk_acc[kKA][kCW], dv_acc[kKA][kCW];
#pragma unroll
  for (int a = 0; a < kKA; ++a)
#pragma unroll
    for (int c = 0; c < kCW; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    cp_async_wait<0>();  // Q, lse, dO and Drow of this tile have landed
    __syncthreads();     // (and the last tile's dQ or dV has read its tile)

    // S^T and dP^T: keys ty + kTY a, queries tx + 16 b.
    float s[kKA][kQB], dp[kKA][kQB];
    ring_rows_dot<D, kTY>(k_s, q_s, s);
    ring_rows_dot<D, kTY>(v_s, do_s, dp);
    const Dropout dr =
        kDrop && !kWithDq ? make_dropout(da, bh, H) : dr_k5;
    if (k0 + kBK > Tn || q0 + kBQ > Tn)
      ring_p_ds<D, kBK, true, kDrop>(s, dp, pt_s, dst_s, lse_s, drow_s, k0,
                                     q0, Tn, sm_scale, dr);
    else
      ring_p_ds<D, kBK, false, kDrop>(s, dp, pt_s, dst_s, lse_s, drow_s, k0,
                                      q0, Tn, sm_scale, dr);
    __syncthreads();  // P~^T and dS^T complete

    // dK += dS^T Q: keys ty + kTY a, columns tx kCW + c.
    ring_rows_times<D, kTY, kKA, kBQ, kPR>(dst_s, q_s, dk_acc);
    __syncthreads();  // Q and lse are free
    if (qt + 1 < n_qt) load_q(qt + 1);
    cp_async_commit();

    // dV += P~^T dO: keys ty + kTY a, columns tx kCW + c.
    ring_rows_times<D, kTY, kKA, kBQ, kPR>(pt_s, do_s, dv_acc);
    __syncthreads();  // dO and Drow are free
    if (qt + 1 < n_qt) load_do(qt + 1);
    cp_async_commit();

    if constexpr (kWithDq) {
      // dQ = dS K over this block's keys: queries ty kQD + a, columns
      // tx kCW + c, scaled and added into dq.
      float dqa[kQD][kCW];
#pragma unroll
      for (int a = 0; a < kQD; ++a)
#pragma unroll
        for (int c = 0; c < kCW; ++c) dqa[a][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        float ds[kQD], kx[kCW];
        lds<kQD>(dst_s + j * kPR + ty * kQD, ds);
        lds<kCW>(k_s + j * kDR + tx * kCW, kx);
#pragma unroll
        for (int a = 0; a < kQD; ++a)
#pragma unroll
          for (int c = 0; c < kCW; ++c)
            dqa[a][c] = fmaf(ds[a], kx[c], dqa[a][c]);
      }
#pragma unroll
      for (int a = 0; a < kQD; ++a) {
        const int i = q0 + ty * kQD + a;
        if (i >= Tn) continue;
        float* row = dq + base + static_cast<int64_t>(i) * D + tx * kCW;
        if constexpr (kCW == 2) {
          atomicAdd(reinterpret_cast<float2*>(row),
                    make_float2(dqa[a][0] * sm_scale, dqa[a][1] * sm_scale));
        } else {
#pragma unroll
          for (int c = 0; c < kCW; c += 4)
            atomicAdd(reinterpret_cast<float4*>(row + c),
                      make_float4(dqa[a][c] * sm_scale,
                                  dqa[a][c + 1] * sm_scale,
                                  dqa[a][c + 2] * sm_scale,
                                  dqa[a][c + 3] * sm_scale));
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < kKA; ++a) {
    const int j = k0 + ty + kTY * a;
    if (j < Tn) {
      const int64_t off = base + static_cast<int64_t>(j) * D + tx * kCW;
#pragma unroll
      for (int c = 0; c < kCW; c += 2) {
        *reinterpret_cast<float2*>(dk + off + c) =
            make_float2(dk_acc[a][c] * sm_scale, dk_acc[a][c + 1] * sm_scale);
        *reinterpret_cast<float2*>(dv + off + c) =
            make_float2(dv_acc[a][c], dv_acc[a][c + 1]);
      }
    }
  }
}


// ---------------------------------------------------------------------------
// K6
// ---------------------------------------------------------------------------

// kBQ queries a block (32, or 64 once such blocks fill the card:
// run_bwd_dq_ring) with 4 kBQ threads on K4's thread grid and key tiles
// (64 keys, 32 at D 128), holding Q and dO, one K and one V buffer and the
// dS tile. 32-query blocks: three an SM (168 registers a thread), four at
// D 32 (128). 64-query blocks: two an SM (128 registers), one at D 128.
template <int D, int kBQ_>
struct RingDqF32 {
  static constexpr int kBQ = kBQ_;                // queries a block
  static constexpr int kThreads = 4 * kBQ;        // a (kBQ / 4) x 16 grid
  static constexpr int kKC = D == 128 ? 32 : 64;  // keys a tile
  static constexpr int kTY = kThreads / 16;
  static constexpr int kQR = kBQ / kTY;  // queries a thread: ty + kTY a
  static constexpr int kKB = kKC / 16;   // keys a thread: tx + 16 b
  static constexpr int kCW = D / 16;     // dQ columns a thread
  static constexpr int kDR = D + 4;      // padded row of Q, dO, K, V
  static constexpr int kPR = kKC + 16;   // padded row of dS: a warp's two
                                         // rows 16 banks apart
  static constexpr int kMinBlocks =
      kBQ == 32 ? (D == 32 ? 4 : 3) : (D == 128 ? 1 : 2);
  static constexpr int kQ = kBQ * kDR, kKV = kKC * kDR, kP = kBQ * kPR;
  static constexpr size_t kSmem = sizeof(float) * (2 * kQ + 2 * kKV + kP);
};

// dS = p (dP~ - Drow) of one key tile into ds_s, query-major, from S and dP
// (queries ty + kTY a, keys tx + 16 b): p = exp2 of the log2(e)-scaled
// score less lse2 (lse in log2 units), dP dropped and rescaled under kDrop.
// kTail (the last, partial tile) zeroes p at keys at or past Tn; a query
// past Tn needs nothing, its dq row is never stored. kTail and kDrop are
// template arguments so that no branch splits the per-element loop.
template <int D, int kBQ, bool kTail, bool kDrop>
__device__ __forceinline__ void ring_dq_ds(
    const float (&s)[RingDqF32<D, kBQ>::kQR][RingDqF32<D, kBQ>::kKB],
    const float (&dp)[RingDqF32<D, kBQ>::kQR][RingDqF32<D, kBQ>::kKB],
    const float (&lse2)[RingDqF32<D, kBQ>::kQR],
    const float (&drow)[RingDqF32<D, kBQ>::kQR], float* __restrict__ ds_s,
    int c0, int q0, int Tn, float scale2, const Dropout& dr) {
  using P = RingDqF32<D, kBQ>;
  constexpr int kTY = P::kTY, kQR = P::kQR, kKB = P::kKB, kPR = P::kPR;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < kQR; ++a) {
    const int il = ty + kTY * a;
#pragma unroll
    for (int b = 0; b < kKB; ++b) {
      const int jl = tx + 16 * b;
      float p = exp2f(s[a][b] * scale2 - lse2[a]);
      if (kTail && c0 + jl >= Tn) p = 0.f;
      float dpv = dp[a][b];
      if (kDrop) dpv = dr.keep(q0 + il, c0 + jl) ? dpv * dr.scale : 0.f;
      ds_s[il * kPR + jl] = p * (dpv - drow[a]);
    }
  }
}

template <int D, int kBQ_, bool kDrop>
__global__ void __launch_bounds__(RingDqF32<D, kBQ_>::kThreads,
                                  RingDqF32<D, kBQ_>::kMinBlocks)
flash_bwd_dq_ring_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ o,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dlse,
                             float* __restrict__ dq, int H, int Tn,
                             float sm_scale, DropoutArgs da) {
  using P = RingDqF32<D, kBQ_>;
  constexpr int kThreads = P::kThreads, kBQ = P::kBQ, kKC = P::kKC;
  constexpr int kTY = P::kTY, kQR = P::kQR, kKB = P::kKB, kCW = P::kCW;
  constexpr int kPR = P::kPR;
  extern __shared__ __align__(16) float smem_ring[];
  float* q_s = smem_ring;
  float* do_s = q_s + P::kQ;
  float* k_s = do_s + P::kQ;
  float* v_s = k_s + P::kKV;
  float* ds_s = v_s + P::kKV;

  const int q0 = blockIdx.x * kBQ, bh = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const int n_tiles = (Tn + kKC - 1) / kKC;
  const Dropout dr = kDrop ? make_dropout(da, bh, H) : Dropout{};
  const float log2e = 1.4426950408889634f;
  const float scale2 = sm_scale * log2e;

  // Q, dO and V of tile 0: one copy group (dP reads V first).
  load_rows_f32<kBQ, D, kThreads>(smem_addr(q_s), q + base, q0, Tn);
  load_rows_f32<kBQ, D, kThreads>(smem_addr(do_s), dout + base, q0, Tn);
  load_rows_f32<kKC, D, kThreads>(smem_addr(v_s), v + base, 0, Tn);
  cp_async_commit();

  // This thread's rows' lse (log2 units) and Drow = rowsum(dO o) - dlse,
  // each row's sum over its 16 lanes, kCW columns a lane, while the copies
  // are in flight (zero past Tn).
  float lse2[kQR], drow[kQR];
#pragma unroll
  for (int a = 0; a < kQR; ++a) {
    const int i = q0 + ty + kTY * a;
    const bool in = i < Tn;
    float acc = 0.f;
    if (in) {
      const int64_t off = base + static_cast<int64_t>(i) * D + tx * kCW;
      float x[kCW], y[kCW];
      lds<kCW>(o + off, x);
      lds<kCW>(dout + off, y);
#pragma unroll
      for (int c = 0; c < kCW; ++c) acc = fmaf(x[c], y[c], acc);
    }
    acc = row_sum(acc);
    const int64_t row = static_cast<int64_t>(bh) * Tn + i;
    drow[a] = in ? (dlse != nullptr ? acc - dlse[row] : acc) : 0.f;
    lse2[a] = in ? lse[row] * log2e : 0.f;
  }

  float acc[kQR][kCW];
#pragma unroll
  for (int a = 0; a < kQR; ++a)
#pragma unroll
    for (int cc = 0; cc < kCW; ++cc) acc[a][cc] = 0.f;

  for (int c = 0; c < n_tiles; ++c) {
    const int c0 = c * kKC;
    cp_async_wait<0>();  // V of tile c (with Q and dO at c = 0) has landed
    __syncthreads();     // (and the last tile's dQ has read K and dS)
    load_rows_f32<kKC, D, kThreads>(smem_addr(k_s), k + base, c0, Tn);
    cp_async_commit();

    // dP = dO V^T: queries ty + kTY a, keys tx + 16 b.
    float dp[kQR][kKB];
    ring_rows_dot<D, kTY>(do_s, v_s, dp);
    cp_async_wait<0>();  // K of tile c has landed
    __syncthreads();     // and V is free
    if (c + 1 < n_tiles)
      load_rows_f32<kKC, D, kThreads>(smem_addr(v_s), v + base, c0 + kKC,
                                      Tn);
    cp_async_commit();

    // S = Q K^T: queries ty + kTY a, keys tx + 16 b.
    float s[kQR][kKB];
    ring_rows_dot<D, kTY>(q_s, k_s, s);
    if (c0 + kKC > Tn)
      ring_dq_ds<D, kBQ, true, kDrop>(s, dp, lse2, drow, ds_s, c0, q0, Tn,
                                      scale2, dr);
    else
      ring_dq_ds<D, kBQ, false, kDrop>(s, dp, lse2, drow, ds_s, c0, q0,
                                       Tn, scale2, dr);
    __syncthreads();  // dS complete

    // dQ += dS K: queries ty + kTY a, columns tx kCW + cc.
    ring_rows_times<D, kTY, kQR, kKC, kPR>(ds_s, k_s, acc);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < kQR; ++a) {
    const int i = q0 + ty + kTY * a;
    if (i < Tn) {
      float* row = dq + base + static_cast<int64_t>(i) * D + tx * kCW;
      if constexpr (kCW % 4 == 0) {
#pragma unroll
        for (int cc = 0; cc < kCW; cc += 4)
          *reinterpret_cast<float4*>(row + cc) = make_float4(
              acc[a][cc] * sm_scale, acc[a][cc + 1] * sm_scale,
              acc[a][cc + 2] * sm_scale, acc[a][cc + 3] * sm_scale);
      } else {
        *reinterpret_cast<float2*>(row) =
            make_float2(acc[a][0] * sm_scale, acc[a][1] * sm_scale);
      }
    }
  }
}

}  // namespace
