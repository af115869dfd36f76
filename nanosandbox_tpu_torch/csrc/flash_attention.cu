// Flash attention for training, forward and backward, for Hopper (sm_90a):
// the causal kernels here; the non-causal ones (ring attention's
// off-diagonal blocks) are flash_attention_sm90.cu's in bf16 and
// flash_ring_f32.cuh's in fp32, a header this file includes and launches.
//
// Each kernel is the CUDA counterpart of a Pallas kernel in
// nanosandbox_tpu/ops/attention.py. Two designs, chosen by the input type
// and nothing else:
//
//   bf16, causal, on the tensor cores (mma.sync; building blocks in
//   mma_common.cuh):
//     flash_fwd_mma_kernel              <- _flash_fwd_kernel (K4)
//     flash_bwd_mma_kernel<D, true>     <- _flash_bwd_tiles_kernel(
//       with_dq=True) (K5), after flash_bwd_drow_kernel, its pre-pass for
//       the row term Drow = rowsum(dO o);
//     flash_bwd_dq_mma_kernel           <- _flash_bwd_dq_kernel (K6), the
//       split backward's dQ pass, parallel over query tiles;
//     flash_bwd_mma_kernel<D, false>    <- _flash_bwd_tiles_kernel(
//       with_dq=False) (K7), the split backward's dK/dV pass: the same
//       kernel and pre-pass without the dQ half;
//   f32, on CUDA cores (every product an exact f32 fmaf):
//     flash_fwd_f32_kernel<D, kBQ>      <- K4, causal
//     flash_bwd_kv_kernel<D, true>      <- K5, causal, after the f32
//       instance of flash_bwd_drow_kernel;
//     flash_bwd_kv_kernel<D, false>     <- K7, causal, after the same
//       pre-pass;
//     flash_bwd_dq_f32_kernel<D>        <- K6, causal;
//     flash_fwd_ring_f32_kernel, flash_bwd_ring_prep_kernel +
//       flash_bwd_ring_f32_kernel, flash_bwd_dq_ring_f32_kernel
//       (flash_ring_f32.cuh) <- K4, K5 and K7, K6, non-causal: ring
//       attention's blocks, designed for their shape.
//   f32 stays on CUDA cores because its kernels are held to 1e-5 of the
//   plain version with TF32 off, which bf16 or TF32 products would not
//   meet.
//
// What bounds them. Per (row, head) the forward does 4*D*T(T+1)/2 flops and
// moves q, k, v and o once; the fused backward does 2.5x those flops over
// about twice the bytes. At GPT-2 124M's training shape (B 16, H 12,
// T 1024, D 64, bf16) the forward's 25.8 GFLOP take 0.026 ms at the bf16
// tensor-core peak and its ~101 MB 0.030 ms at 3.35 TB/s: the work sits at
// the ridge point, so a kernel is bound by how fast it feeds the tensor
// cores.
//
// The tensor-core design (bf16). Every product is mma.sync.m16n8k16 on
// bf16 fragments with f32 accumulation; each warp owns 16 rows of its
// output. Tiles stay bf16 in shared memory, each 16-byte chunk of a row
// XOR-swizzled by the row so that ldmatrix's eight 16-byte rows fall in
// distinct banks; operands needed transposed (V, dO, Q, dS) come through
// ldmatrix.trans, never through a copy. Global tiles arrive by cp.async
// through a two-stage ring: the next tile is in flight while the current
// one is multiplied, and rows past T are zero-filled by the copy itself.
//   - K4: a block owns 16 * warps queries (128 for D <= 64, 64 for D 128)
//     of one (row, head); Q is loaded once into A fragments, 64-key K/V
//     tiles stream through the ring. The online softmax runs in registers
//     (a row's max over the four lanes that hold it, by shuffles); p is
//     rounded to bf16 in registers and is the A fragment of p.v as it
//     stands. A warp skips the key tiles that lie wholly past its rows.
//     Registers are capped so that two blocks share an SM.
//   - K5: a block owns 64 keys of one (row, head), a warp 16 of them, and
//     walks the 32-query tiles at or after the diagonal: S^T = K Q^T and
//     dP^T = V dO^T, then dV += P~^T dO and dK += dS^T Q from those same
//     accumulators as A fragments. dS^T goes to shared memory once per
//     tile; dQ += dS K (ldmatrix.trans of dS^T and of K) is split over the
//     warps and added into the zeroed f32 buffer with 16-byte vector
//     atomics (a lane pair trades halves so each lane holds four
//     consecutive columns of one row); its summation order changes from
//     run to run. Drow comes from the pre-pass, computed once per row
//     instead of once per key tile that visits it. The small query tile
//     keeps three blocks on an SM.
//   - K7: K5's kernel compiled without the dS^T store, the barrier after
//     it, the dQ product and its atomics (and without the dS^T tile in
//     shared memory). Every block writes only its own keys' dK and dV, so
//     the split backward's result is the same bit for bit on every run.
//   - K6: K4's walk with a second product. A block owns 64 queries, a
//     warp 16; S = Q K^T and dP = dO V^T from the same 64-key K/V tiles
//     of the ring, dS = P (dP - Drow) rounded to bf16 in registers is the
//     A fragment of dQ += dS K (K by ldmatrix.trans), and dQ stays in
//     registers to the end: no atomics, no dS round trip through shared
//     memory. Drow is computed once per row at the start.
// The CUDA-core design (f32). What bounds these kernels is the f32 FMA
// rate of the CUDA cores (67 TFLOP/s: K6's 38.7 GFLOP at the training
// shape take 0.578 ms) and the shared-memory reads that feed it. Rows are
// padded to D + 4 floats, so tiles arrive by 16-byte cp.async and are read
// as float4; each thread's micro-tile is read four deep along the
// contracted dimension. The forward (K4) is attend_f32.cuh's loop, the one
// the fp32 paged prefill (K1) runs, over contiguous rows: 32- or 64-query
// blocks of 4 threads a query (64 once they fill every SM twice over, as
// at the training shape's 3072 blocks), Q resident, 64-key K/V tiles (32
// at D 128) through a two-stage cp.async ring, 4 x 4 micro-tiles, the
// online softmax in registers, p through shared memory; two blocks an SM.
// K5 and K7 walk the query tiles (a two-stage ring, or one stage and a
// second block on the SM), Drow comes from the pre-pass, and K5 adds dQ
// with 16-byte vector atomics. K6 walks the 64-key K/V tiles with Q, dO,
// lse and its own Drow resident (one stage and two blocks an SM at D <=
// 64, a two-stage ring at D 128); dS goes to shared memory once per tile,
// and dQ stays in registers to one store. sm_scale multiplies each score
// after its product and dK, dQ once at the end.
//
// The kernels of this file are causal only (the Pallas kernels'
// `causal=True`): the non-causal bf16 K4-K7 are flash_attention_sm90.cu's
// wgmma kernels, the non-causal fp32 ones flash_ring_f32.cuh's, designed
// for the ring's block. Ring attention (ops/ring_attention.py) calls
// flash_attention_lse with causal=False for the blocks whose keys lie
// wholly before its queries: there every query tile walks every key tile,
// and only the tail tile compares positions (the port masks ragged tails,
// so a ring chunk need not be a tile multiple). The backwards take an
// optional lse cotangent dlse (B*H, T) f32 (a pointer of its own, null for
// none), which folds into the row term: ds = p (dp - (Drow - dlse)), in the
// Drow pre-pass of K5 and K7 and where K6 computes Drow.
//
// Blocks run in no order, where the Pallas kernels walk a sequential grid
// axis and keep state in VMEM across it (the forward's online softmax,
// K5's resident dQ). So K4 and K6 give one block a query tile and loop
// over the key tiles at or before the diagonal inside the block; K5 and
// K7 give one block a key tile and loop over the query tiles at or after
// it; K5's dQ, summed over key tiles on different SMs, goes through f32
// atomics (K6 + K7 give a deterministic backward instead). The longest
// walks are launched first. Any T is taken: only tiles that cross the
// diagonal or the tail compare positions.
//
// Numerics follow the Pallas kernels, in both designs: scores are scaled
// in f32 after the product; the forward's l sums the UNMASKED, unrounded
// f32 p, and dropout touches only the p.v sum; p is rounded to v's type
// before p.v, ds to q's type before ds^T q and ds k (the MXU's bf16
// inputs); Drow = rowsum(dO o) in f32; dK and dQ are scaled by sm_scale at
// the end. (The tensor-core kernels take exp2 of scores pre-multiplied by
// log2(e); lse is stored in natural log.)
//
// Dropout keep-mask: murmur3's fmix32 over q_pos * hash_seq_len + k_pos
// (uint32), XORed with a per-(batch*head) stream key from the (5,) seed
// words [seed, b_off, h_off, q_off, k_off]; kept where the hash is at or
// above round(rate * 2^32) -- bit for bit the Pallas kernels' mask
// (attention.py _dropout_tile_seed / _dropout_keep). In an m16n8k16
// accumulator lane l holds rows l/4 and l/4 + 8 and columns 2(l%4) and
// 2(l%4) + 1 of each 8-column slice; the mask, lse and Drow are looked up
// by those positions.
//
// Layouts (row-major, contiguous): q, k, v, o, dO, dK, dV (B*H, T, D) in
// float or bf16 (all one type); lse, dlse and K5's and K7's Drow scratch
// (B*H, T) f32; the fused dQ buffer (B*H, T, D) f32; seed (5,) int64 words
// holding uint32 values. Every entry point returns cudaGetLastError()
// after its launches; the Python wrapper raises when it is not
// cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attend_f32.cuh"
#include "dropout.cuh"
#include "flash_ring_f32.cuh"
#include "mma_common.cuh"

namespace {

using namespace nsb;

constexpr int kTile = 64;          // queries and keys per tile
constexpr int kThreads = 256;      // a 16 x 16 grid of threads

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

// ---------------------------------------------------------------------------
// K4 on CUDA cores (f32), causal: attend_f32 (attend_f32.cuh, the fp32 paged
// prefill's loop) over contiguous rows, with dropout on the p.v sum and the
// lse store compiled in. One block per (row*head, query tile of kBQ), the
// grid's y the query tile, the longest walks first.
// ---------------------------------------------------------------------------

template <int D, int kBQ>
__global__ void __launch_bounds__(TilesF32<float, D, kBQ>::kThreads, 2)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Tn, float sm_scale,
                     DropoutArgs da) {
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  attend_f32<float, float, D, kBQ, true>(
      q, k, v, nullptr, nullptr, ContigRows{static_cast<int64_t>(bh) * Tn},
      bh, Tn, q0, q0, min(q0 + kBQ, Tn), o, lse, sm_scale,
      make_dropout(da, bh, H));
}

// ---------------------------------------------------------------------------
// K5 (kWithDq) and K7 on CUDA cores (f32): the key-parallel backward. One
// block per (64-key tile, row*head), looping over the kBQ-query tiles at
// or after the diagonal; Drow comes from flash_bwd_drow_kernel.
//
// Every product is an exact f32 fmaf. Tiles are f32 in shared memory with
// rows padded by 4 floats, so 16-byte cp.async copies and float4 loads
// stay aligned and a row's neighbour starts 4 banks over. K and V stay
// resident; Q, dO, lse and Drow of the next query tile are in flight
// through a two-stage cp.async ring while the current one is multiplied
// (one stage at D <= 64, where a second block on the SM hides the load;
// see BwdF32).
// A 16 x 16 grid of threads: thread (ty, tx) owns keys ty + 16a (a < 4)
// and queries tx + 16b of S^T = K Q^T and dP^T = V dO^T, read as float4
// along D; P~^T and dS^T go to shared memory once per tile, key-major;
// dV += P~^T dO and dK += dS^T Q give the thread keys ty + 16a and the D/16
// columns from tx D/16, read as float4 along the queries; dQ += dS K gives
// it kBQ/16 consecutive queries and the same columns, added into the f32
// buffer with 16-byte (8-byte at D 32) vector atomics.
// ---------------------------------------------------------------------------

// Two blocks share an SM at D <= 64 (128 registers a thread): each one's
// barriers and loads are covered by the other's products, which measured
// faster than one block with more registers and a two-stage ring (the
// ring and two blocks do not fit together at D 64). At D 128 one block
// fills the SM, with 32-query tiles, and the ring is what overlaps loads.
template <int D>
struct BwdF32 {
  static constexpr int kBQ = D == 128 ? 32 : 64;  // queries a tile
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;
  static constexpr int kStages = kMinBlocks == 1 ? 2 : 1;
  static constexpr int kDR = D + 4, kPR = kBQ + 4;  // padded rows
  static constexpr int kKV = kTile * kDR;           // floats of K or V
  static constexpr int kQT = kBQ * kDR;             // floats of Q or dO
  static constexpr int kStage = 2 * kQT + 2 * kBQ;  // Q, dO, lse, Drow
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kKV + kStages * kStage + 2 * kTile * kPR);
};

template <int D, bool kWithDq>
__global__ void __launch_bounds__(kThreads, BwdF32<D>::kMinBlocks)
flash_bwd_kv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ drow,
                    float* __restrict__ dq_acc, float* __restrict__ dk,
                    float* __restrict__ dv, int H, int Tn, float sm_scale,
                    DropoutArgs da) {
  using P = BwdF32<D>;
  constexpr int kBQ = P::kBQ, kDR = P::kDR, kPR = P::kPR;
  constexpr int kQB = kBQ / 16;  // queries a thread in S^T; rows in dQ
  constexpr int kCW = D / 16;    // columns a thread in dK, dV, dQ
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + P::kKV;
  float* ring = v_s + P::kKV;
  float* pt_s = ring + P::kStages * P::kStage;  // P~^T, key-major
  float* dst_s = pt_s + kTile * kPR;            // dS^T, key-major

  const int kt = gridDim.x - 1 - blockIdx.x;  // key tile 0 walks the most
  const int bh = blockIdx.y, k0 = kt * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const float* lse_bh = lse + static_cast<int64_t>(bh) * Tn;
  const float* drow_bh = drow + static_cast<int64_t>(bh) * Tn;
  const int qt0 = k0 / kBQ, n_qt = (Tn + kBQ - 1) / kBQ;

  auto load_stage = [&](int qt, int slot) {
    const uint32_t st = smem_addr(ring + slot * P::kStage);
    load_rows_f32<kBQ, D, kThreads>(st, q + base, qt * kBQ, Tn);
    load_rows_f32<kBQ, D, kThreads>(st + 4 * P::kQT, dout + base, qt * kBQ,
                                    Tn);
    load_floats<kBQ>(st + 8 * P::kQT, lse_bh, qt * kBQ, Tn);
    load_floats<kBQ>(st + 8 * P::kQT + 4 * kBQ, drow_bh, qt * kBQ, Tn);
  };
  load_rows_f32<kTile, D, kThreads>(smem_addr(k_s), k + base, k0, Tn);
  load_rows_f32<kTile, D, kThreads>(smem_addr(v_s), v + base, k0, Tn);
  cp_async_commit();
  if constexpr (P::kStages == 2) {
    load_stage(qt0, 0);
    cp_async_commit();
  }

  float dk_acc[4][kCW], dv_acc[4][kCW];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kCW; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ;
    const int slot = P::kStages == 2 ? (qt - qt0) & 1 : 0;
    if constexpr (P::kStages == 2) {
      if (qt + 1 < n_qt) load_stage(qt + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // K, V and this tile have landed
    } else {
      load_stage(qt, 0);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* q_s = ring + slot * P::kStage;
    const float* do_s = q_s + P::kQT;
    const float* lse_s = do_s + P::kQT;
    const float* drow_s = lse_s + kBQ;

    // S^T and dP^T: keys ty + 16a, queries tx + 16b.
    float s[4][kQB], dp[4][kQB];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < kQB; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float kx[4][4], qx[kQB][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        lds<4>(k_s + (ty + 16 * a) * kDR + d, kx[a]);
#pragma unroll
      for (int b = 0; b < kQB; ++b)
        lds<4>(q_s + (tx + 16 * b) * kDR + d, qx[b]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < kQB; ++b)
            s[a][b] = fmaf(kx[a][e], qx[b][e], s[a][b]);
    }
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float vx[4][4], ox[kQB][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        lds<4>(v_s + (ty + 16 * a) * kDR + d, vx[a]);
#pragma unroll
      for (int b = 0; b < kQB; ++b)
        lds<4>(do_s + (tx + 16 * b) * kDR + d, ox[b]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < kQB; ++b)
            dp[a][b] = fmaf(vx[a][e], ox[b][e], dp[a][b]);
    }
    // Made here, so its registers are free outside this phase.
    const Dropout dr = make_dropout(da, bh, H);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int jl = ty + 16 * a, j = k0 + jl;
#pragma unroll
      for (int b = 0; b < kQB; ++b) {
        const int il = tx + 16 * b, i = q0 + il;
        const bool valid = i < Tn && j <= i;
        const float p = valid ? expf(s[a][b] * sm_scale - lse_s[il]) : 0.f;
        float pv = p, dpv = dp[a][b];
        if (dr.on) {
          const bool keep = dr.keep(i, j);
          pv = keep ? p * dr.scale : 0.f;
          dpv = keep ? dpv * dr.scale : 0.f;
        }
        pt_s[jl * kPR + il] = pv;
        dst_s[jl * kPR + il] = p * (dpv - drow_s[il]);
      }
    }
    __syncthreads();  // P~^T and dS^T complete

    // dV += P~^T dO, dK += dS^T Q: keys ty + 16a, columns tx kCW + c.
#pragma unroll
    for (int i = 0; i < kBQ; i += 4) {
      float pt[4][4], dst[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        lds<4>(pt_s + (ty + 16 * a) * kPR + i, pt[a]);
        lds<4>(dst_s + (ty + 16 * a) * kPR + i, dst[a]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float ox[kCW], qx[kCW];
        lds<kCW>(do_s + (i + e) * kDR + tx * kCW, ox);
        lds<kCW>(q_s + (i + e) * kDR + tx * kCW, qx);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < kCW; ++c) {
            dv_acc[a][c] = fmaf(pt[a][e], ox[c], dv_acc[a][c]);
            dk_acc[a][c] = fmaf(dst[a][e], qx[c], dk_acc[a][c]);
          }
      }
    }
    if constexpr (kWithDq) {
      // dQ += dS K over this tile: queries ty kQB + a, columns tx kCW + c.
      float dqa[kQB][kCW];
#pragma unroll
      for (int a = 0; a < kQB; ++a)
#pragma unroll
        for (int c = 0; c < kCW; ++c) dqa[a][c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < kTile; ++j) {
        float ds[kQB], kx[kCW];
        lds<kQB>(dst_s + j * kPR + ty * kQB, ds);
        lds<kCW>(k_s + j * kDR + tx * kCW, kx);
#pragma unroll
        for (int a = 0; a < kQB; ++a)
#pragma unroll
          for (int c = 0; c < kCW; ++c) dqa[a][c] = fmaf(ds[a], kx[c],
                                                         dqa[a][c]);
      }
#pragma unroll
      for (int a = 0; a < kQB; ++a) {
        const int i = q0 + ty * kQB + a;
        if (i < Tn) {
          float* row = dq_acc + base + static_cast<int64_t>(i) * D + tx * kCW;
          if constexpr (kCW == 2) {
            atomicAdd(reinterpret_cast<float2*>(row),
                      make_float2(dqa[a][0], dqa[a][1]));
          } else {
#pragma unroll
            for (int c = 0; c < kCW; c += 4)
              atomicAdd(reinterpret_cast<float4*>(row + c),
                        make_float4(dqa[a][c], dqa[a][c + 1], dqa[a][c + 2],
                                    dqa[a][c + 3]));
          }
        }
      }
    }
    __syncthreads();  // this stage, P~^T and dS^T are free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
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
// K6 on CUDA cores (f32): the split backward's dQ pass. One block per
// (64-query tile, row*head), looping over the key tiles at or before the
// diagonal, the longest walks first. (bf16 runs flash_bwd_dq_mma_kernel.)
//
// Every product is an exact f32 fmaf. Q, dO, lse and the block's Drow stay
// resident, Q and dO in tiles of rows padded by 4 floats (16-byte cp.async,
// float4 reads); 64-key K/V tiles arrive by cp.async (see BwdDqF32 for the
// ring). Drow = rowsum(dO o) is computed once per row at the start, from
// the staged dO and o in device memory, as the Pallas kernel does. A
// 16 x 16 grid of threads: thread (ty, tx) owns queries ty + 16a and keys
// tx + 16b (a, b < 4) of S = Q K^T and dP = dO V^T, each read as float4
// four deep along D; P = exp(S sm_scale - lse), dropout's mask and rescale
// on dP, dS = P (dP - Drow) goes to shared memory once per tile,
// query-major; dQ += dS K gives the thread the same queries and the D/16
// columns from tx D/16, dS read as float4 along the keys. dQ stays in
// registers to one store, scaled by sm_scale: no atomics, so the split
// backward gives the same bits on every run.
// ---------------------------------------------------------------------------

// Two blocks share an SM at D <= 64 (128 registers a thread), with one K/V
// stage each: 12% faster than a two-stage ring at one block an SM. At
// D 128 one block fills the SM and the ring keeps the next tile in
// flight. 8 x 4 micro-tiles in 128-thread blocks (fewer shared loads per
// FMA, fewer warps) measured 1.5x slower (PERF.md, section 6).
template <int D>
struct BwdDqF32 {
  static constexpr int kThreadsT = 256;
  static constexpr int kTY = kThreadsT / 16;  // rows of the thread grid
  static constexpr int kQR = kTile / kTY;     // queries a thread
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;
  static constexpr int kStages = kMinBlocks == 1 ? 2 : 1;
  static constexpr int kDR = D + 4;       // padded row of Q, dO, K, V
  static constexpr int kSR = kTile + 16;  // padded row of dS: the two rows
                                          // of a warp fall 16 banks apart
  static constexpr int kQT = kTile * kDR;  // floats of one such tile
  // Q, dO, lse, Drow, kStages x (K, V), dS.
  static constexpr size_t kSmem =
      sizeof(float) * (2 * kQT + 2 * kTile + kStages * 2 * kQT + kTile * kSR);
};

template <int D>
__global__ void __launch_bounds__(BwdDqF32<D>::kThreadsT,
                                  BwdDqF32<D>::kMinBlocks)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dlse, float* __restrict__ dq,
                        int H, int Tn, float sm_scale, DropoutArgs da) {
  using P = BwdDqF32<D>;
  constexpr int kDR = P::kDR, kSR = P::kSR, kTY = P::kTY, kQR = P::kQR;
  constexpr int kThreadsT = P::kThreadsT;
  constexpr int kCW = D / 16;  // columns a thread in dQ
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + P::kQT;
  float* lse_s = do_s + P::kQT;
  float* drow_s = lse_s + kTile;
  float* ring = drow_s + kTile;  // stage s: K, then V
  float* ds_s = ring + P::kStages * 2 * P::kQT;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest walks first
  const int bh = blockIdx.y, q0 = qt * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const int n_kt = (min(q0 + kTile, Tn) + kTile - 1) / kTile;

  auto load_kv = [&](int kt, int slot) {
    const uint32_t st = smem_addr(ring + slot * 2 * P::kQT);
    load_rows_f32<kTile, D, kThreadsT>(st, k + base, kt * kTile, Tn);
    load_rows_f32<kTile, D, kThreadsT>(st + 4 * P::kQT, v + base, kt * kTile,
                                      Tn);
  };
  load_rows_f32<kTile, D, kThreadsT>(smem_addr(q_s), q + base, q0, Tn);
  load_rows_f32<kTile, D, kThreadsT>(smem_addr(do_s), dout + base, q0, Tn);
  load_floats<kTile>(smem_addr(lse_s), lse + static_cast<int64_t>(bh) * Tn,
                     q0, Tn);
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();  // Q, dO and lse have landed
  __syncthreads();

  // Drow of the tile's rows: kTPR threads a row, D / kTPR columns each
  // (zero past T). Read after the loop's first barrier.
  {
    constexpr int kTPR = kThreadsT / kTile, kW = D / kTPR;
    const int r = threadIdx.x / kTPR, c0 = (threadIdx.x % kTPR) * kW;
    float acc = 0.f;
    if (q0 + r < Tn) {
      const float* o_row = o + base + static_cast<int64_t>(q0 + r) * D + c0;
#pragma unroll
      for (int c = 0; c < kW; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(o_row + c);
        float b[4];
        lds<4>(do_s + r * kDR + c0 + c, b);
        acc = fmaf(a.x, b[0], acc);
        acc = fmaf(a.y, b[1], acc);
        acc = fmaf(a.z, b[2], acc);
        acc = fmaf(a.w, b[3], acc);
      }
    }
#pragma unroll
    for (int o = kTPR / 2; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    // The lse cotangent folds into the row term: ds = p (dp - (Drow - dlse)).
    if (dlse != nullptr && q0 + r < Tn)
      acc -= dlse[static_cast<int64_t>(bh) * Tn + q0 + r];
    if (threadIdx.x % kTPR == 0) drow_s[r] = acc;
  }

  float acc[kQR][kCW];
#pragma unroll
  for (int a = 0; a < kQR; ++a)
#pragma unroll
    for (int c = 0; c < kCW; ++c) acc[a][c] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    int slot = 0;
    if constexpr (P::kStages == 2) {
      slot = kt & 1;
      if (kt + 1 < n_kt) load_kv(kt + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile kt has landed
    } else {
      if (kt > 0) {
        load_kv(kt, 0);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_t = ring + slot * 2 * P::kQT;
    const float* v_t = k_t + P::kQT;

    // S and dP: queries ty + kTY a, keys tx + 16b.
    float s[kQR][4], dp[kQR][4];
#pragma unroll
    for (int a = 0; a < kQR; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = dp[a][b] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float qx[kQR][4], kx[4][4];
#pragma unroll
      for (int a = 0; a < kQR; ++a)
        lds<4>(q_s + (ty + kTY * a) * kDR + d, qx[a]);
#pragma unroll
      for (int b = 0; b < 4; ++b) lds<4>(k_t + (tx + 16 * b) * kDR + d, kx[b]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < kQR; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            s[a][b] = fmaf(qx[a][e], kx[b][e], s[a][b]);
    }
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float ox[kQR][4], vx[4][4];
#pragma unroll
      for (int a = 0; a < kQR; ++a)
        lds<4>(do_s + (ty + kTY * a) * kDR + d, ox[a]);
#pragma unroll
      for (int b = 0; b < 4; ++b) lds<4>(v_t + (tx + 16 * b) * kDR + d, vx[b]);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int a = 0; a < kQR; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            dp[a][b] = fmaf(ox[a][e], vx[b][e], dp[a][b]);
    }
    // Made here, so its registers are free outside this phase.
    const Dropout dr = make_dropout(da, bh, H);
    // Only a tile that crosses the diagonal or the tail compares positions.
    const bool masked = k0 + kTile - 1 > q0 || k0 + kTile > Tn;
#pragma unroll
    for (int a = 0; a < kQR; ++a) {
      const int il = ty + kTY * a, i = q0 + il;
      const float lse_i = lse_s[il], drow_i = drow_s[il];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jl = tx + 16 * b, j = k0 + jl;
        const bool valid = i < Tn && !(masked && j > i);
        const float p = valid ? expf(s[a][b] * sm_scale - lse_i) : 0.f;
        float dpv = dp[a][b];
        if (dr.on) dpv = dr.keep(i, j) ? dpv * dr.scale : 0.f;
        ds_s[il * kSR + jl] = p * (dpv - drow_i);
      }
    }
    __syncthreads();  // dS complete

    // dQ += dS K: queries ty + kTY a, columns tx kCW + c.
#pragma unroll
    for (int j = 0; j < kTile; j += 4) {
      float ds[kQR][4];
#pragma unroll
      for (int a = 0; a < kQR; ++a)
        lds<4>(ds_s + (ty + kTY * a) * kSR + j, ds[a]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kx[kCW];
        lds<kCW>(k_t + (j + e) * kDR + tx * kCW, kx);
#pragma unroll
        for (int a = 0; a < kQR; ++a)
#pragma unroll
          for (int c = 0; c < kCW; ++c)
            acc[a][c] = fmaf(ds[a][e], kx[c], acc[a][c]);
      }
    }
    __syncthreads();  // this stage and dS are free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int a = 0; a < kQR; ++a) {
    const int i = q0 + ty + kTY * a;
    if (i < Tn) {
      float* row = dq + base + static_cast<int64_t>(i) * D + tx * kCW;
#pragma unroll
      for (int c = 0; c < kCW; c += 2)
        *reinterpret_cast<float2*>(row + c) =
            make_float2(acc[a][c] * sm_scale, acc[a][c + 1] * sm_scale);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core kernels (bf16): K4, K5 and K7 on mma.sync.m16n8k16, from
// the building blocks of mma_common.cuh.
// ---------------------------------------------------------------------------

constexpr int kKeys = 64;  // keys per tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// K4 on the tensor cores. One block per (row*head, 16 * kWarps queries);
// the grid's y is the query tile, the longest walk first.
// ---------------------------------------------------------------------------

template <int D>
constexpr int fwd_warps() { return D == 128 ? 4 : 8; }

template <int D>
constexpr size_t fwd_mma_smem() {
  // Q, then two stages of (K, V).
  return sizeof(bf16) * D * (16 * fwd_warps<D>() + 4 * kKeys);
}

// Two blocks per SM: at most 128 registers a thread for 8 warps. Causal
// only: the non-causal bf16 K4 is flash_attention_sm90.cu's.
template <int D, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 2)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int H, int Tn, float sm_scale,
                     DropoutArgs da) {
  constexpr int kThreadsT = kWarps * 32, kBM = 16 * kWarps;
  constexpr int kKS = D / 16;      // k-steps of Q K^T
  constexpr int kNT = kKeys / 8;   // 8-key column slices of a score tile
  constexpr int kDT = D / 8;       // 8-wide column slices of o
  constexpr uint32_t kTileB = kKeys * D * sizeof(bf16);
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t q_s = smem_addr(smem_tc);
  const uint32_t kv_s = q_s + kBM * D * sizeof(bf16);  // stage s: K, then V

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const Dropout dr = make_dropout(da, bh, H);
  const int n_kt = (min(q0 + kBM, Tn) + kKeys - 1) / kKeys;

  load_rows<kBM, D, kThreadsT>(q_s, q + base, q0, Tn);
  cp_async_commit();
  load_rows<kKeys, D, kThreadsT>(kv_s, k + base, 0, Tn);
  load_rows<kKeys, D, kThreadsT>(kv_s + kTileB, v + base, 0, Tn);
  cp_async_commit();
  cp_async_wait<1>();  // Q has landed
  __syncthreads();

  const int r_lo = q0 + 16 * warp;  // the warp's first query
  const int i0 = r_lo + g, i1 = i0 + 8;
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

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kKeys;
    if (kt + 1 < n_kt) {
      const uint32_t st = kv_s + ((kt + 1) & 1) * 2 * kTileB;
      load_rows<kKeys, D, kThreadsT>(st, k + base, k0 + kKeys, Tn);
      load_rows<kKeys, D, kThreadsT>(st + kTileB, v + base, k0 + kKeys, Tn);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const uint32_t k_s = kv_s + (kt & 1) * 2 * kTileB, v_s = k_s + kTileB;
    // Warp-uniform: a tile whose keys all lie past the warp's rows, or a
    // warp whose rows all lie past T, adds nothing.
    if (k0 <= r_lo + 15 && r_lo < Tn) {
      float s[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
#pragma unroll
        for (int np = 0; np < kNT; np += 2) {
          uint32_t b[4];
          ldsm_x4(b, k_s + swz<D>(8 * np + (lane & 7) + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)));
          mma_bf16(s[np], qf[kk], b[0], b[1]);
          mma_bf16(s[np + 1], qf[kk], b[2], b[3]);
        }
      // Only a tile that crosses the warp's diagonal or the tail compares
      // positions.
      const bool masked = k0 + kKeys - 1 > r_lo || k0 + kKeys > Tn;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + 8 * nt + 2 * t + e;
          float x0 = s[nt][e] * scale2, x1 = s[nt][2 + e] * scale2;
          if (masked) {
            if (j > i0 || j >= Tn) x0 = kNegInf;
            if (j > i1 || j >= Tn) x1 = kNegInf;
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
      uint32_t pf[kNT / 2][4];
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        float p00 = exp2f(s[nt][0] - m0), p01 = exp2f(s[nt][1] - m0);
        float p10 = exp2f(s[nt][2] - m1), p11 = exp2f(s[nt][3] - m1);
        // l sums the unmasked p; dropout touches only the p.v sum.
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        if (dr.on) {
          const int j = k0 + 8 * nt + 2 * t;
          p00 = dr.keep(i0, j) ? p00 * dr.scale : 0.f;
          p01 = dr.keep(i0, j + 1) ? p01 * dr.scale : 0.f;
          p10 = dr.keep(i1, j) ? p10 * dr.scale : 0.f;
          p11 = dr.keep(i1, j + 1) ? p11 * dr.scale : 0.f;
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
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int dp = 0; dp < kDT; dp += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, v_s + swz<D>(16 * kk + (lane & 15), dp + (lane >> 4)));
          mma_bf16(acc[dp], pf[kk], b[0], b[1]);
          mma_bf16(acc[dp + 1], pf[kk], b[2], b[3]);
        }
    }
    __syncthreads();  // every warp is done with stage kt & 1
  }
  cp_async_wait<0>();

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = 8 * dt + 2 * t;
    if (i0 < Tn)
      *reinterpret_cast<uint32_t*>(o + base + static_cast<int64_t>(i0) * D +
                                   col) =
          pack_bf16(acc[dt][0] * inv0, acc[dt][1] * inv0);
    if (i1 < Tn)
      *reinterpret_cast<uint32_t*>(o + base + static_cast<int64_t>(i1) * D +
                                   col) =
          pack_bf16(acc[dt][2] * inv1, acc[dt][3] * inv1);
  }
  if (t == 0) {
    float* lse_bh = lse + static_cast<int64_t>(bh) * Tn;
    if (i0 < Tn) lse_bh[i0] = m0 * kLn2 + logf(l0);
    if (i1 < Tn) lse_bh[i1] = m1 * kLn2 + logf(l1);
  }
}

// ---------------------------------------------------------------------------
// K5 and K7 on the tensor cores: Drow's pre-pass, then one block per
// (row*head, 64-key tile); the grid's y is the key tile, key tile 0 (the
// longest walk) first. K7 is K5's kernel without its dQ half.
// ---------------------------------------------------------------------------

// drow[r] = sum_d dO[r, d] o[r, d] - dlse[r] in f32 over rows r < n_rows
// of (n_rows, D) (no dlse: none subtracted); D / 8 lanes per row in bf16
// (D / 4 in f32), 16 bytes of each tensor a lane. The pre-pass of the
// key-parallel K5 and K7, in both designs: the lse cotangent folds into
// the row term, ds = p (dp - (Drow - dlse)).
template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_drow_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      const float* __restrict__ dlse,
                      float* __restrict__ drow, int64_t n_rows) {
  constexpr int kVN = Vec<T>::kN, kL = D / kVN;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t row = idx / kL;
  const int part = threadIdx.x % kL;
  float acc = 0.f;
  if (row < n_rows) {
    float a[kVN], b[kVN];
    Vec<T>::load(o + row * D + part * kVN, a);
    Vec<T>::load(dout + row * D + part * kVN, b);
#pragma unroll
    for (int i = 0; i < kVN; ++i) acc = fmaf(a[i], b[i], acc);
  }
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < n_rows)
    drow[row] = dlse != nullptr ? acc - dlse[row] : acc;
}

template <int D, bool kWithDq>
struct BwdMma {
  static constexpr int kWarps = 4, kThreadsT = 128;
  // 32 queries per tile: the S^T and dP^T accumulators stay small enough
  // (about 170 registers a thread at D 64) for 3 blocks per SM.
  static constexpr int kBQ = 32;
  static constexpr uint32_t kKV = kKeys * D * sizeof(bf16);  // K or V
  static constexpr uint32_t kQB = kBQ * D * sizeof(bf16);    // Q or dO
  // One stage of the ring: Q, dO, lse, Drow.
  static constexpr uint32_t kStage = 2 * kQB + 2 * kBQ * sizeof(float);
  // + dS^T, for the dQ product only.
  static constexpr size_t kSmem =
      2 * kKV + 2 * kStage + (kWithDq ? kKeys * kBQ * sizeof(bf16) : 0);
};

// kWithDq: K5 (dQ summed by atomics into dq_acc); without it K7, which
// writes dK and dV alone, touches no memory two blocks share, and gives
// the same bits on every run. Causal only: the non-causal bf16 K5 and K7
// are flash_attention_sm90.cu's.
template <int D, bool kWithDq>
__global__ void __launch_bounds__(128)
flash_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ drow,
                     float* __restrict__ dq_acc, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Tn, float sm_scale,
                     DropoutArgs da) {
  using P = BwdMma<D, kWithDq>;
  constexpr int kBQ = P::kBQ, kThreadsT = P::kThreadsT;
  constexpr int kKS = D / 16;    // k-steps over D
  constexpr int kQT = kBQ / 8;   // 8-query column slices of S^T
  constexpr int kDT = D / 8;     // 8-wide column slices of dK, dV
  constexpr int kMT = kBQ / 16;  // 16-query row tiles of the dQ tile
  constexpr int kDW = kDT * kMT / P::kWarps;  // dQ column slices a warp
  static_assert(kDW % 2 == 0 && kQT % 2 == 0, "pairs of slices");
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t k_s = smem_addr(smem_tc), v_s = k_s + P::kKV;
  const uint32_t ring = v_s + P::kKV;
  unsigned char* ds_p = smem_tc + 2 * P::kKV + 2 * P::kStage;
  const uint32_t ds_s = smem_addr(ds_p);

  const int bh = blockIdx.x, k0 = blockIdx.y * kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const float* lse_bh = lse + static_cast<int64_t>(bh) * Tn;
  const float* drow_bh = drow + static_cast<int64_t>(bh) * Tn;
  const Dropout dr = make_dropout(da, bh, H);
  const int qt0 = k0 / kBQ, n_qt = (Tn + kBQ - 1) / kBQ;

  auto load_stage = [&](int qt, int slot) {
    const uint32_t st = ring + slot * P::kStage;
    load_rows<kBQ, D, kThreadsT>(st, q + base, qt * kBQ, Tn);
    load_rows<kBQ, D, kThreadsT>(st + P::kQB, dout + base, qt * kBQ, Tn);
    load_floats<kBQ>(st + 2 * P::kQB, lse_bh, qt * kBQ, Tn);
    load_floats<kBQ>(st + 2 * P::kQB + kBQ * sizeof(float), drow_bh,
                     qt * kBQ, Tn);
  };
  load_rows<kKeys, D, kThreadsT>(k_s, k + base, k0, Tn);
  load_rows<kKeys, D, kThreadsT>(v_s, v + base, k0, Tn);
  cp_async_commit();
  load_stage(qt0, 0);
  cp_async_commit();

  const int j_lo = k0 + 16 * warp;  // the warp's first key
  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  const float scale2 = sm_scale * kLog2e;

  for (int qt = qt0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ, slot = (qt - qt0) & 1;
    if (qt + 1 < n_qt) load_stage(qt + 1, slot ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this tile have landed
    __syncthreads();
    const uint32_t q_s = ring + slot * P::kStage, do_s = q_s + P::kQB;
    const float* lse_s = reinterpret_cast<const float*>(
        smem_tc + 2 * P::kKV + slot * P::kStage + 2 * P::kQB);
    const float* drow_s = lse_s + kBQ;

    // Warp-uniform: a query tile wholly before the warp's keys adds
    // nothing; its rows of dS^T are zero.
    if (j_lo <= q0 + kBQ - 1) {
      float st[kQT][4], dpt[kQT][4];  // S^T and dP^T: rows keys, cols queries
#pragma unroll
      for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t ka[4], va[4];
        const uint32_t a_off = swz<D>(16 * warp + (lane & 15),
                                      2 * kk + (lane >> 4));
        ldsm_x4(ka, k_s + a_off);
        ldsm_x4(va, v_s + a_off);
#pragma unroll
        for (int np = 0; np < kQT; np += 2) {
          const uint32_t b_off =
              swz<D>(8 * np + (lane & 7) + ((lane >> 4) << 3),
                     2 * kk + ((lane >> 3) & 1));
          uint32_t b[4];
          ldsm_x4(b, q_s + b_off);
          mma_bf16(st[np], ka, b[0], b[1]);
          mma_bf16(st[np + 1], ka, b[2], b[3]);
          ldsm_x4(b, do_s + b_off);
          mma_bf16(dpt[np], va, b[0], b[1]);
          mma_bf16(dpt[np + 1], va, b[2], b[3]);
        }
      }
      // Only a tile that crosses the warp's diagonal or the tail compares
      // positions.
      const bool masked = q0 < j_lo + 15 || q0 + kBQ > Tn;
      // P~^T and dS^T as A fragments (k-steps over queries).
      uint32_t pa[kQT / 2][4], dsa[kQT / 2][4];
#pragma unroll
      for (int nt = 0; nt < kQT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8: keys
          const int j = j_lo + g + 8 * h;
          float pv[2], ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * nt + 2 * t + e, i = q0 + c;
            float p = exp2f(st[nt][2 * h + e] * scale2 - lse_s[c] * kLog2e);
            if (masked && (i >= Tn || j > i)) p = 0.f;
            float dpv = dpt[nt][2 * h + e];
            pv[e] = p;
            if (dr.on) {
              const bool keep = dr.keep(i, j);
              pv[e] = keep ? p * dr.scale : 0.f;
              dpv = keep ? dpv * dr.scale : 0.f;
            }
            ds[e] = p * (dpv - drow_s[c]);
          }
          pa[nt >> 1][(nt & 1) * 2 + h] = pack_bf16(pv[0], pv[1]);
          dsa[nt >> 1][(nt & 1) * 2 + h] = pack_bf16(ds[0], ds[1]);
        }
      }
      // dV += P~^T dO, dK += dS^T Q.
#pragma unroll
      for (int kq = 0; kq < kQT / 2; ++kq)
#pragma unroll
        for (int dp = 0; dp < kDT; dp += 2) {
          const uint32_t off = swz<D>(16 * kq + (lane & 15), dp + (lane >> 4));
          uint32_t b[4];
          ldsm_x4_t(b, do_s + off);
          mma_bf16(dv_acc[dp], pa[kq], b[0], b[1]);
          mma_bf16(dv_acc[dp + 1], pa[kq], b[2], b[3]);
          ldsm_x4_t(b, q_s + off);
          mma_bf16(dk_acc[dp], dsa[kq], b[0], b[1]);
          mma_bf16(dk_acc[dp + 1], dsa[kq], b[2], b[3]);
        }
      // dS^T into shared memory, the warp's 16 key rows.
      if constexpr (kWithDq) {
#pragma unroll
        for (int nt = 0; nt < kQT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(
                ds_p + swz<kBQ>(16 * warp + g + 8 * h, nt) + 4 * t) =
                dsa[nt >> 1][(nt & 1) * 2 + h];
      }
    } else if constexpr (kWithDq) {
      for (int e = lane; e < 16 * kQT; e += 32)
        *reinterpret_cast<uint4*>(ds_p + swz<kBQ>(16 * warp + e / kQT,
                                                  e % kQT)) =
            make_uint4(0u, 0u, 0u, 0u);
    }
    if constexpr (kWithDq) __syncthreads();  // dS^T complete

    // dQ += dS K over this tile: the warp takes query rows 16 mt and kDW
    // column slices from dw0.
    const int mt = warp % kMT, dw0 = (warp / kMT) * kDW;
    if (kWithDq && q0 + 16 * mt < Tn) {
      float dqa[kDW][4];
#pragma unroll
      for (int dt = 0; dt < kDW; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dqa[dt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4_t(a, ds_s + swz<kBQ>(16 * kk + (lane & 7) + ((lane >> 4) << 3),
                                     2 * mt + ((lane >> 3) & 1)));
#pragma unroll
        for (int dp = 0; dp < kDW; dp += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, k_s + swz<D>(16 * kk + (lane & 15),
                                    dw0 + dp + (lane >> 4)));
          mma_bf16(dqa[dp], a, b[0], b[1]);
          mma_bf16(dqa[dp + 1], a, b[2], b[3]);
        }
      }
      // Lanes t and t ^ 1 trade halves: the even one then holds row g,
      // the odd one row g + 8, each over 4 consecutive columns.
      const bool odd = t & 1;
      const int row = q0 + 16 * mt + g + (odd ? 8 : 0);
#pragma unroll
      for (int dt = 0; dt < kDW; ++dt) {
        const float s0 = odd ? dqa[dt][0] : dqa[dt][2];
        const float s1 = odd ? dqa[dt][1] : dqa[dt][3];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float4 val = odd ? make_float4(r0, r1, dqa[dt][2], dqa[dt][3])
                               : make_float4(dqa[dt][0], dqa[dt][1], r0, r1);
        if (row < Tn)
          atomicAdd(reinterpret_cast<float4*>(
                        dq_acc + base + static_cast<int64_t>(row) * D +
                        8 * (dw0 + dt) + 2 * (t & ~1)),
                    val);
      }
    }
    __syncthreads();  // dS^T and this stage are free for the next tile
  }
  cp_async_wait<0>();

#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = j_lo + g + 8 * h;
      if (j < Tn) {
        const int64_t off = base + static_cast<int64_t>(j) * D + 8 * dt + 2 * t;
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack_bf16(dk_acc[dt][2 * h] * sm_scale,
                      dk_acc[dt][2 * h + 1] * sm_scale);
        *reinterpret_cast<uint32_t*>(dv + off) =
            pack_bf16(dv_acc[dt][2 * h], dv_acc[dt][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// K6 on the tensor cores: the split backward's dQ pass. One block per
// (row*head, 16 * kWarps queries); the grid's y is the query tile, the
// longest walk first. K4's walk with a second product: a warp owns 16
// query rows, 64-key K and V tiles stream through the cp.async ring;
// S = Q K^T and dP = dO V^T (V in K's place), P = exp(S sm_scale - lse),
// dS = P (dP - Drow) rounded to bf16 in registers, the A fragment of
// dQ += dS K (K by ldmatrix.trans, as V in K4's p.v). Drow = rowsum(dO o)
// is computed once per row at the start, from the staged dO and o in
// device memory. Every block writes only its own rows of dQ, so the
// split backward gives the same bits on every run.
// ---------------------------------------------------------------------------

template <int D>
struct BwdDqMma {
  static constexpr int kWarps = 4, kBM = 16 * kWarps;
  // Q and dO stay A fragments in registers at D <= 64; at D 128 they are
  // read from shared memory per key tile, so registers hold dQ and S, dP.
  static constexpr bool kRegs = D <= 64;
  static constexpr uint32_t kQB = kBM * D * sizeof(bf16);    // Q or dO
  static constexpr uint32_t kKV = kKeys * D * sizeof(bf16);  // K or V
  // Q, dO, two stages of (K, V), Drow.
  static constexpr size_t kSmem = 2 * kQB + 4 * kKV + kBM * sizeof(float);
};

// kDlse: dlse, the (B*H, T) f32 lse cotangent, is read (without it the
// pointer is unused). Causal only: the non-causal bf16 K6 is
// flash_attention_sm90.cu's.
template <int D, bool kDlse>
__global__ void __launch_bounds__(BwdDqMma<D>::kWarps * 32, 2)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dlse, bf16* __restrict__ dq,
                        int H, int Tn, float sm_scale, DropoutArgs da) {
  using P = BwdDqMma<D>;
  constexpr int kWarps = P::kWarps, kThreadsT = kWarps * 32, kBM = P::kBM;
  constexpr int kKS = D / 16;      // k-steps over D
  constexpr int kNT = kKeys / 8;   // 8-key column slices of S, dP
  constexpr int kDT = D / 8;       // 8-wide column slices of dQ
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const uint32_t q_s = smem_addr(smem_tc), do_s = q_s + P::kQB;
  const uint32_t kv_s = do_s + P::kQB;  // stage s: K, then V
  float* drow_s = reinterpret_cast<float*>(smem_tc + 2 * P::kQB + 4 * P::kKV);

  const int bh = blockIdx.x, q0 = (gridDim.y - 1 - blockIdx.y) * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const Dropout dr = make_dropout(da, bh, H);
  const int n_kt = (min(q0 + kBM, Tn) + kKeys - 1) / kKeys;

  load_rows<kBM, D, kThreadsT>(q_s, q + base, q0, Tn);
  load_rows<kBM, D, kThreadsT>(do_s, dout + base, q0, Tn);
  cp_async_commit();
  load_rows<kKeys, D, kThreadsT>(kv_s, k + base, 0, Tn);
  load_rows<kKeys, D, kThreadsT>(kv_s + P::kKV, v + base, 0, Tn);
  cp_async_commit();
  cp_async_wait<1>();  // Q and dO have landed
  __syncthreads();

  // Drow of the tile's rows: two threads a row, D / 2 columns each, from
  // the staged dO and o in device memory (zero past T).
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    float acc = 0.f;
    if (q0 + r < Tn) {
      const bf16* o_row = o + base + static_cast<int64_t>(q0 + r) * D;
#pragma unroll
      for (int cc = 0; cc < D / 16; ++cc) {
        const int c = half * (D / 16) + cc;
        float a[8], b[8];
        Vec<bf16>::load(o_row + 8 * c, a);
        Vec<bf16>::load(reinterpret_cast<const bf16*>(
                            smem_tc + P::kQB + swz<D>(r, c)), b);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(a[e], b[e], acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    // The lse cotangent folds into the row term: ds = p (dp - (Drow - dlse)).
    if constexpr (kDlse) {
      if (q0 + r < Tn) acc -= dlse[static_cast<int64_t>(bh) * Tn + q0 + r];
    }
    if (half == 0) drow_s[r] = acc;
  }

  const int r_lo = q0 + 16 * warp;  // the warp's first query
  const int i0 = r_lo + g, i1 = i0 + 8;
  uint32_t qf[P::kRegs ? kKS : 1][4], df[P::kRegs ? kKS : 1][4];
  if constexpr (P::kRegs) {
#pragma unroll
    for (int kk = 0; kk < kKS; ++kk) {
      const uint32_t off = swz<D>(16 * warp + (lane & 15),
                                  2 * kk + (lane >> 4));
      ldsm_x4(qf[kk], q_s + off);
      ldsm_x4(df[kk], do_s + off);
    }
  }
  __syncthreads();  // Drow written
  // Rows past T get lse = +inf, so their p (and dS) is 0.
  const float* lse_bh = lse + static_cast<int64_t>(bh) * Tn;
  const float inf = __int_as_float(0x7f800000);
  const float lse0 = i0 < Tn ? lse_bh[i0] * kLog2e : inf;
  const float lse1 = i1 < Tn ? lse_bh[i1] * kLog2e : inf;
  const float drow0 = drow_s[16 * warp + g], drow1 = drow_s[16 * warp + g + 8];

  float acc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  const float scale2 = sm_scale * kLog2e;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kKeys;
    if (kt + 1 < n_kt) {
      const uint32_t st = kv_s + ((kt + 1) & 1) * 2 * P::kKV;
      load_rows<kKeys, D, kThreadsT>(st, k + base, k0 + kKeys, Tn);
      load_rows<kKeys, D, kThreadsT>(st + P::kKV, v + base, k0 + kKeys, Tn);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile kt has landed
    __syncthreads();
    const uint32_t k_s = kv_s + (kt & 1) * 2 * P::kKV, v_s = k_s + P::kKV;
    // Warp-uniform: a tile whose keys all lie past the warp's rows, or a
    // warp whose rows all lie past T, adds nothing.
    if (k0 <= r_lo + 15 && r_lo < Tn) {
      float s[kNT][4], dp[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
        uint32_t qa[4], da4[4];
        if constexpr (P::kRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            qa[e] = qf[kk][e];
            da4[e] = df[kk][e];
          }
        } else {
          const uint32_t off = swz<D>(16 * warp + (lane & 15),
                                      2 * kk + (lane >> 4));
          ldsm_x4(qa, q_s + off);
          ldsm_x4(da4, do_s + off);
        }
#pragma unroll
        for (int np = 0; np < kNT; np += 2) {
          const uint32_t b_off =
              swz<D>(8 * np + (lane & 7) + ((lane >> 4) << 3),
                     2 * kk + ((lane >> 3) & 1));
          uint32_t b[4];
          ldsm_x4(b, k_s + b_off);
          mma_bf16(s[np], qa, b[0], b[1]);
          mma_bf16(s[np + 1], qa, b[2], b[3]);
          ldsm_x4(b, v_s + b_off);
          mma_bf16(dp[np], da4, b[0], b[1]);
          mma_bf16(dp[np + 1], da4, b[2], b[3]);
        }
      }
      // Only a tile that crosses the warp's diagonal or the tail compares
      // positions.
      const bool masked = k0 + kKeys - 1 > r_lo || k0 + kKeys > Tn;
      // dS as the A fragments of dS K: k-step kk takes slices 2kk, 2kk + 1.
      uint32_t dsf[kNT / 2][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8
          const int i = h ? i1 : i0;
          const float lse2 = h ? lse1 : lse0, drow_i = h ? drow1 : drow0;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = k0 + 8 * nt + 2 * t + e;
            float p = exp2f(s[nt][2 * h + e] * scale2 - lse2);
            if (masked && (j > i || j >= Tn)) p = 0.f;
            float dpv = dp[nt][2 * h + e];
            if (dr.on) dpv = dr.keep(i, j) ? dpv * dr.scale : 0.f;
            ds[e] = p * (dpv - drow_i);
          }
          dsf[nt >> 1][(nt & 1) * 2 + h] = pack_bf16(ds[0], ds[1]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
        for (int dp2 = 0; dp2 < kDT; dp2 += 2) {
          uint32_t b[4];
          ldsm_x4_t(b, k_s + swz<D>(16 * kk + (lane & 15), dp2 + (lane >> 4)));
          mma_bf16(acc[dp2], dsf[kk], b[0], b[1]);
          mma_bf16(acc[dp2 + 1], dsf[kk], b[2], b[3]);
        }
    }
    __syncthreads();  // every warp is done with stage kt & 1
  }
  cp_async_wait<0>();

#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = 8 * dt + 2 * t;
    if (i0 < Tn)
      *reinterpret_cast<uint32_t*>(dq + base + static_cast<int64_t>(i0) * D +
                                   col) =
          pack_bf16(acc[dt][0] * sm_scale, acc[dt][1] * sm_scale);
    if (i1 < Tn)
      *reinterpret_cast<uint32_t*>(dq + base + static_cast<int64_t>(i1) * D +
                                   col) =
          pack_bf16(acc[dt][2] * sm_scale, acc[dt][3] * sm_scale);
  }
}

// ---------------------------------------------------------------------------
// Launchers, dispatched on (dtype, head_dim, causal).
// ---------------------------------------------------------------------------

enum BwdMode { kFused = 0, kDq = 1, kDkv = 2 };

// Above 48 KB, dynamic shared memory has to be allowed per kernel.
template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

struct Call {
  const void *q, *k, *v, *o, *dout;
  const float* lse_in;
  const float* dlse;  // the lse cotangent (B*H, T) f32, or null
  float* lse_out;
  float* drow;  // K5's and K7's (B*H, T) Drow scratch
  void *dq, *dk, *dv, *out;
  int BH, H, T;
  float sm_scale;
  DropoutArgs dr;
  cudaStream_t stream;
};

// The causal fp32 K4 with kBQ-query blocks.
template <int D, int kBQ>
cudaError_t launch_fwd_f32(const Call& c) {
  using P = TilesF32<float, D, kBQ>;
  const dim3 grid(c.BH, (c.T + kBQ - 1) / kBQ);
  return launch(flash_fwd_f32_kernel<D, kBQ>, grid, P::kThreads,
                P::kSmem, c.stream, static_cast<const float*>(c.q),
                static_cast<const float*>(c.k),
                static_cast<const float*>(c.v), static_cast<float*>(c.out),
                c.lse_out, c.H, c.T, c.sm_scale, c.dr);
}

// The causal K4 (run sends the non-causal calls elsewhere).
template <typename T, int D>
cudaError_t run_fwd(const Call& c) {
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr int kW = fwd_warps<D>();
    const dim3 grid(c.BH, (c.T + 16 * kW - 1) / (16 * kW));
    return launch(flash_fwd_mma_kernel<D, kW>, grid, 32 * kW,
                  fwd_mma_smem<D>(), c.stream, static_cast<const bf16*>(c.q),
                  static_cast<const bf16*>(c.k),
                  static_cast<const bf16*>(c.v), static_cast<bf16*>(c.out),
                  c.lse_out, c.H, c.T, c.sm_scale, c.dr);
  } else {
    // The query tile of the fp32 paged prefill's rule (attend_f32.cuh).
    return wide_query_tiles(c.BH, c.T) ? launch_fwd_f32<D, 64>(c)
                                       : launch_fwd_f32<D, 32>(c);
  }
}

// The non-causal fp32 K4 (flash_ring_f32.cuh): 32-query blocks, the grid's
// x the query tile; the dropout instance where dropout is on.
template <int D>
cudaError_t run_fwd_ring(const Call& c) {
  using P = RingFwdF32<D>;
  const dim3 grid((c.T + P::kBQ - 1) / P::kBQ, c.BH);
  return launch(c.dr.on ? flash_fwd_ring_f32_kernel<D, true>
                        : flash_fwd_ring_f32_kernel<D, false>,
                grid, P::kThreads, P::kSmem, c.stream,
                static_cast<const float*>(c.q),
                static_cast<const float*>(c.k),
                static_cast<const float*>(c.v), static_cast<float*>(c.out),
                c.lse_out, c.H, c.T, c.sm_scale, c.dr);
}

// Whether the non-causal fp32 K5 and K7 take 64-key blocks and K6
// 64-query ones: once they fill every SM twice over (a wave of two an
// SM), else 32-key or 32-query ones, whose finer grid spreads a small
// call over every SM (at the ring's block, H 12, T 1024: 32 at B 1, 64
// from B 2 on; PERF.md section 6). Built with -DNSB_RING_TILE=32 or 64,
// every call takes that width instead (scripts/ring_f32_times.py --tile
// times one against the other).
inline bool ring_wide_tiles(int BH, int T) {
#ifdef NSB_RING_TILE
  static_assert(NSB_RING_TILE == 32 || NSB_RING_TILE == 64,
                "NSB_RING_TILE is 32 or 64");
  return NSB_RING_TILE == 64;
#else
  return static_cast<int64_t>(BH) * ((T + 63) / 64) >=
         2 * static_cast<int64_t>(sm_count());
#endif
}

// The non-causal fp32 K5 (kWithDq) or K7 (flash_ring_f32.cuh): kBK-key
// blocks, the grid's x the key tile; K5's dq is the f32 output, which the
// kernel scales.
template <int D, int kBK, bool kWithDq>
cudaError_t launch_bwd_ring(const Call& c) {
  using P = RingBwdF32<D, kBK>;
  const dim3 grid((c.T + kBK - 1) / kBK, c.BH);
  return launch(c.dr.on ? flash_bwd_ring_f32_kernel<D, kBK, kWithDq, true>
                        : flash_bwd_ring_f32_kernel<D, kBK, kWithDq, false>,
                grid, P::kThreads, P::kSmem, c.stream,
                static_cast<const float*>(c.q),
                static_cast<const float*>(c.k),
                static_cast<const float*>(c.v),
                static_cast<const float*>(c.dout), c.lse_in,
                static_cast<const float*>(c.drow), static_cast<float*>(c.dq),
                static_cast<float*>(c.dk), static_cast<float*>(c.dv), c.H,
                c.T, c.sm_scale, c.dr);
}

// The pre-pass (Drow less dlse; K5 also zeroes dq), then the main kernel.
template <int D, bool kWithDq>
cudaError_t run_bwd_ring(const Call& c) {
  const int64_t rows = static_cast<int64_t>(c.BH) * c.T;
  flash_bwd_ring_prep_kernel<D, kWithDq><<<static_cast<unsigned>(
                                               (rows * (D / 4) + 255) / 256),
                                           256, 0, c.stream>>>(
      static_cast<const float*>(c.o), static_cast<const float*>(c.dout),
      c.dlse, c.drow, static_cast<float*>(c.dq), rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return ring_wide_tiles(c.BH, c.T) ? launch_bwd_ring<D, 64, kWithDq>(c)
                                    : launch_bwd_ring<D, 32, kWithDq>(c);
}

// The non-causal fp32 K6 (flash_ring_f32.cuh): kBQ-query blocks, the
// grid's x the query tile, Drow computed in the kernel; one launch.
template <int D, int kBQ>
cudaError_t launch_bwd_dq_ring(const Call& c) {
  using P = RingDqF32<D, kBQ>;
  const dim3 grid((c.T + kBQ - 1) / kBQ, c.BH);
  return launch(c.dr.on ? flash_bwd_dq_ring_f32_kernel<D, kBQ, true>
                        : flash_bwd_dq_ring_f32_kernel<D, kBQ, false>,
                grid, P::kThreads, P::kSmem, c.stream,
                static_cast<const float*>(c.q),
                static_cast<const float*>(c.k),
                static_cast<const float*>(c.v),
                static_cast<const float*>(c.o),
                static_cast<const float*>(c.dout), c.lse_in, c.dlse,
                static_cast<float*>(c.dq), c.H, c.T, c.sm_scale, c.dr);
}

template <int D>
cudaError_t run_bwd_dq_ring(const Call& c) {
  return ring_wide_tiles(c.BH, c.T) ? launch_bwd_dq_ring<D, 64>(c)
                                    : launch_bwd_dq_ring<D, 32>(c);
}

// A kernel as ring_shape reports it: the function, its dynamic shared
// memory, threads a block and tile (the rows of T a block owns).
struct RingKernel {
  const void* fn;
  size_t smem;
  int threads, tile;
};

template <typename P, typename K>
RingKernel ring_kernel(K* fn, int tile) {
  return {reinterpret_cast<const void*>(fn), P::kSmem, P::kThreads, tile};
}

// {grid x, grid y, threads, blocks an SM, dynamic shared memory bytes,
// registers a thread} of the non-causal fp32 K4 (mode -1), K6 (kDq) or the
// main kernel of K5 (kFused) or K7 (kDkv) as run launches them, without
// dropout, at (BH, T).
template <int D>
cudaError_t ring_shape(int mode, int BH, int T, int* out) {
  const bool wide = ring_wide_tiles(BH, T);
  RingKernel k;
  if (mode == -1) {
    k = ring_kernel<RingFwdF32<D>>(flash_fwd_ring_f32_kernel<D, false>,
                                   RingFwdF32<D>::kBQ);
  } else if (mode == kDq) {
    k = wide ? ring_kernel<RingDqF32<D, 64>>(
                   flash_bwd_dq_ring_f32_kernel<D, 64, false>, 64)
             : ring_kernel<RingDqF32<D, 32>>(
                   flash_bwd_dq_ring_f32_kernel<D, 32, false>, 32);
  } else if (mode == kFused) {
    k = wide ? ring_kernel<RingBwdF32<D, 64>>(
                   flash_bwd_ring_f32_kernel<D, 64, true, false>, 64)
             : ring_kernel<RingBwdF32<D, 32>>(
                   flash_bwd_ring_f32_kernel<D, 32, true, false>, 32);
  } else if (mode == kDkv) {
    k = wide ? ring_kernel<RingBwdF32<D, 64>>(
                   flash_bwd_ring_f32_kernel<D, 64, false, false>, 64)
             : ring_kernel<RingBwdF32<D, 32>>(
                   flash_bwd_ring_f32_kernel<D, 32, false, false>, 32);
  } else {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(k.smem));
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, k.fn);
  if (e != cudaSuccess) return e;
  out[0] = (T + k.tile - 1) / k.tile;
  out[1] = BH;
  out[2] = k.threads;
  out[4] = static_cast<int>(k.smem);
  out[5] = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], k.fn,
                                                       k.threads, k.smem);
}

// Drow's pre-pass of K5 and K7, in either type, with dlse folded in.
template <typename T, int D>
cudaError_t run_drow(const Call& c) {
  const int64_t rows = static_cast<int64_t>(c.BH) * c.T;
  const int64_t lanes = rows * (D / Vec<T>::kN);
  flash_bwd_drow_kernel<T, D><<<static_cast<unsigned>((lanes + 255) / 256),
                                256, 0, c.stream>>>(
      static_cast<const T*>(c.o), static_cast<const T*>(c.dout), c.dlse,
      c.drow, rows);
  return cudaGetLastError();
}

// The causal K5 or K7: Drow's pre-pass, then the key-parallel kernel of
// the type's design (K7: no dQ, dq_acc unused).
template <typename T, int D, bool kWithDq>
cudaError_t run_bwd_kv(const Call& c) {
  const cudaError_t e = run_drow<T, D>(c);
  if (e != cudaSuccess) return e;
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid(c.BH, (c.T + kKeys - 1) / kKeys);
    using P = BwdMma<D, kWithDq>;
    return launch(flash_bwd_mma_kernel<D, kWithDq>, grid,
                  P::kThreadsT, P::kSmem, c.stream,
                  static_cast<const bf16*>(c.q),
                  static_cast<const bf16*>(c.k),
                  static_cast<const bf16*>(c.v),
                  static_cast<const bf16*>(c.dout), c.lse_in,
                  static_cast<const float*>(c.drow),
                  static_cast<float*>(c.dq), static_cast<bf16*>(c.dk),
                  static_cast<bf16*>(c.dv), c.H, c.T, c.sm_scale, c.dr);
  } else {
    const dim3 grid((c.T + kTile - 1) / kTile, c.BH);
    return launch(flash_bwd_kv_kernel<D, kWithDq>, grid, kThreads,
                  BwdF32<D>::kSmem, c.stream,
                  static_cast<const float*>(c.q),
                  static_cast<const float*>(c.k),
                  static_cast<const float*>(c.v),
                  static_cast<const float*>(c.dout), c.lse_in,
                  static_cast<const float*>(c.drow),
                  static_cast<float*>(c.dq), static_cast<float*>(c.dk),
                  static_cast<float*>(c.dv), c.H, c.T, c.sm_scale, c.dr);
  }
}

// The causal K6, the query-parallel dQ pass.
template <typename T, int D>
cudaError_t run_bwd_dq(const Call& c) {
  if constexpr (std::is_same<T, bf16>::value) {
    using P = BwdDqMma<D>;
    const dim3 grid(c.BH, (c.T + P::kBM - 1) / P::kBM);
    auto kernel = c.dlse != nullptr ? flash_bwd_dq_mma_kernel<D, true>
                                    : flash_bwd_dq_mma_kernel<D, false>;
    return launch(kernel, grid, P::kWarps * 32,
                  P::kSmem, c.stream, static_cast<const bf16*>(c.q),
                  static_cast<const bf16*>(c.k),
                  static_cast<const bf16*>(c.v),
                  static_cast<const bf16*>(c.o),
                  static_cast<const bf16*>(c.dout), c.lse_in, c.dlse,
                  static_cast<bf16*>(c.dq), c.H, c.T, c.sm_scale, c.dr);
  } else {
    const dim3 grid((c.T + kTile - 1) / kTile, c.BH);
    return launch(flash_bwd_dq_f32_kernel<D>, grid,
                  BwdDqF32<D>::kThreadsT, BwdDqF32<D>::kSmem, c.stream,
                  static_cast<const float*>(c.q),
                  static_cast<const float*>(c.k),
                  static_cast<const float*>(c.v),
                  static_cast<const float*>(c.o),
                  static_cast<const float*>(c.dout), c.lse_in, c.dlse,
                  static_cast<float*>(c.dq), c.H, c.T, c.sm_scale, c.dr);
  }
}

// mode < 0: the forward; else a BwdMode. Every non-causal bf16 call is
// flash_attention_sm90.cu's (nsb_flash_fwd_sm90, nsb_flash_bwd_sm90) and
// has no instance here; every non-causal fp32 call runs the kernels of
// flash_ring_f32.cuh.
template <typename T, int D, bool kCausal>
cudaError_t run(const Call& c, int mode) {
  if constexpr (std::is_same<T, bf16>::value && !kCausal) {
    return cudaErrorInvalidValue;
  } else if constexpr (!kCausal) {
    switch (mode) {
      case -1: return run_fwd_ring<D>(c);
      case kFused: return run_bwd_ring<D, true>(c);
      case kDkv: return run_bwd_ring<D, false>(c);
      case kDq: return run_bwd_dq_ring<D>(c);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (mode) {
      case -1: return run_fwd<T, D>(c);
      case kFused: return run_bwd_kv<T, D, true>(c);
      case kDkv: return run_bwd_kv<T, D, false>(c);
      case kDq: return run_bwd_dq<T, D>(c);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T, int D>
cudaError_t by_causal(bool causal, const Call& c, int mode) {
  return causal ? run<T, D, true>(c, mode) : run<T, D, false>(c, mode);
}

template <typename T>
cudaError_t by_head_dim(int D, bool causal, const Call& c, int mode) {
  switch (D) {
    case 32: return by_causal<T, 32>(causal, c, mode);
    case 64: return by_causal<T, 64>(causal, c, mode);
    case 128: return by_causal<T, 128>(causal, c, mode);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_call(int dtype, int D, bool causal, const Call& c,
                          int mode) {
  if (dtype == kF32) return by_head_dim<float>(D, causal, c, mode);
  if (dtype == kBF16) return by_head_dim<__nv_bfloat16>(D, causal, c, mode);
  return cudaErrorInvalidValue;
}

DropoutArgs dropout_args(const long long* seed, int on, unsigned threshold,
                         float keep_scale, unsigned hash_seq_len) {
  return DropoutArgs{seed, on, threshold, keep_scale, hash_seq_len};
}

}  // namespace

extern "C" {

// K4, causal or not (causal 0: every query sees every key, ring
// attention's off-diagonal blocks). Returns a cudaError_t: cudaSuccess (0)
// once the kernel is queued.
int nsb_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, const long long* seed, int BH, int H, int T,
                  int D, float sm_scale, int dtype, int dropout_on,
                  unsigned threshold, float keep_scale, unsigned hash_seq_len,
                  int causal, void* stream) {
  Call c{};
  c.q = q; c.k = k; c.v = v; c.out = o; c.lse_out = lse;
  c.BH = BH; c.H = H; c.T = T; c.sm_scale = sm_scale;
  c.dr = dropout_args(seed, dropout_on, threshold, keep_scale, hash_seq_len);
  c.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_call(dtype, D, causal != 0, c, -1));
}

// K5 (mode 0: dq is the zeroed f32 accumulator; non-causal fp32, the f32
// dq itself, which the kernels zero and scale), K6 (mode 1: dq only, in
// the input type; dk, dv unused) or K7 (mode 2: dk, dv; dq unused). K5 and
// K7 also need drow, a (B*H, T) f32 scratch for their Drow pre-pass. dlse,
// the lse output's (B*H, T) f32 cotangent, may be null (none).
int nsb_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, const float* dlse,
                  const long long* seed, float* drow, void* dq, void* dk,
                  void* dv, int BH, int H, int T, int D, float sm_scale,
                  int dtype, int dropout_on, unsigned threshold,
                  float keep_scale, unsigned hash_seq_len, int causal,
                  int mode, void* stream) {
  if (mode < 0 || ((mode == kFused || mode == kDkv) && drow == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Call c{};
  c.q = q; c.k = k; c.v = v; c.o = o; c.dout = dout; c.lse_in = lse;
  c.dlse = dlse;
  c.drow = drow; c.dq = dq; c.dk = dk; c.dv = dv;
  c.BH = BH; c.H = H; c.T = T; c.sm_scale = sm_scale;
  c.dr = dropout_args(seed, dropout_on, threshold, keep_scale, hash_seq_len);
  c.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_call(dtype, D, causal != 0, c, mode));
}

// The launch shape of the non-causal fp32 K4 (mode -1) or of the main
// kernel of K5 (mode 0), K6 (mode 1) or K7 (mode 2) at (BH, T, D):
// out[6] = {grid x, grid y, threads, blocks an SM, dynamic shared memory
// bytes, registers a thread}. Returns a cudaError_t.
int nsb_flash_ring_f32_shape(int mode, int BH, int T, int D, int* out) {
  switch (D) {
    case 32: return static_cast<int>(ring_shape<32>(mode, BH, T, out));
    case 64: return static_cast<int>(ring_shape<64>(mode, BH, T, out));
    case 128: return static_cast<int>(ring_shape<128>(mode, BH, T, out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
