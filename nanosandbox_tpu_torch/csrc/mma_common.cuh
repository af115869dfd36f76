// Building blocks shared by the kernels of flash_attention.cu,
// paged_attention.cu, flash_attention_sm90.cu and flash_decode.cu, for
// Hopper (sm_90a): the mma.sync kernels (the bf16 flash-attention forward
// and backward, the paged prefill under a bf16 query), the f32 CUDA-core
// kernels that stage tiles by cp.async (the fp32 backward, the paged
// prefill under an fp32 query or over an fp32 pool), and the mbarriers of
// the kernels that copy by TMA or bulk copies (the wgmma K4-K7, K3).
//
//   smem_addr               a shared-memory pointer as a 32-bit address;
//   cp_async16 / cp_async4  global -> shared copies that bypass registers,
//                           with commit / wait groups for a ring of tiles;
//   ldsm_x4(_t)             four 8 x 8 bf16 matrices by ldmatrix (.trans);
//   mma_bf16                mma.sync.m16n8k16, bf16 in, f32 accumulate;
//   pack_bf16               two f32 rounded to a bf16 pair;
//   quad_max / quad_sum     reductions over the four lanes of a row;
//   swz                     the XOR swizzle of a bf16 tile's 16-byte chunks;
//   load_rows / load_floats whole rows (f32 entries) into shared memory by
//                           cp.async, zero past the end;
//   load_rows_f32 / lds     f32 rows into tiles padded by 4 floats, by
//                           cp.async; n consecutive floats from shared
//                           (or device) memory by 16- (8-) byte loads;
//   row_max / row_sum       reductions over the 16 lanes (a half-warp)
//                           that share a row of a CUDA-core score tile;
//   mbar_*                  mbarriers in shared memory: init (and the
//                           fence that publishes it), arrive, arrive with
//                           an expected transaction count, wait on a phase;
//   bulk_copy               a contiguous byte range from global to shared
//                           memory by the copy engine (cp.async.bulk),
//                           completing on an mbarrier;
//   cp_async_arrive         an mbarrier arrival once this thread's
//                           cp.async copies have landed.
//
// In an m16n8k16 accumulator lane l holds rows l/4 and l/4 + 8 and columns
// 2(l%4) and 2(l%4) + 1 of each 8-column slice; every mask, scale and
// statistic lookup of the kernels follows that map.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nsb {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes from global to shared memory, asynchronously; src_bytes 0
// writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and r[i] holds matrix i's fragment (row l / 4,
// columns 2(l % 4), +1; with .trans, rows 2(l % 4), +1 of column l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a b for a 16 x 16 bf16 A fragment, a 16 x 8 B fragment, f32 d.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Reductions over the four lanes that hold one accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile of kCols
// bf16 per row: the chunk index is XORed with bits of the row so that the
// 8 rows one ldmatrix matrix reads at one chunk hit 8 distinct bank groups.
template <int kCols>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int kChunks = kCols / 8;
  static_assert(kChunks == 4 || kChunks == 8 || kChunks == 16,
                "rows of 64, 128 or 256 bytes");
  const int x = kChunks == 4 ? (r >> 1) & 3 : r & 7;
  return static_cast<uint32_t>((r * kChunks + (c ^ x)) * 16);
}

// Rows [r0, r0 + kRows) of an (n_rows, kCols) bf16 matrix into a swizzled
// tile at dst, by cp.async; rows at or past n_rows are zero.
template <int kRows, int kCols, int kThreadsT>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const bf16* __restrict__ src,
                                          int r0, int n_rows) {
  constexpr int kChunks = kCols / 8;
  static_assert((kRows * kChunks) % kThreadsT == 0, "whole chunks");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreadsT; ++i) {
    const int e = threadIdx.x + i * kThreadsT;
    const int r = e / kChunks, c = e % kChunks;
    const bool in = r0 + r < n_rows;
    const bf16* p = src + (in ? static_cast<int64_t>(r0 + r) * kCols + c * 8
                              : 0);
    cp_async16(dst + swz<kCols>(r, c), p, in ? 16 : 0);
  }
}

// Entries [r0, r0 + kRows) of an f32 vector of n_rows into dst; zero past.
template <int kRows>
__device__ __forceinline__ void load_floats(uint32_t dst,
                                            const float* __restrict__ src,
                                            int r0, int n_rows) {
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const bool in = r0 + r < n_rows;
    cp_async4(dst + 4 * r, src + (in ? r0 + r : 0), in ? 4 : 0);
  }
}

// Rows [r0, r0 + kRows) of an (n_rows, D) f32 matrix into a tile of rows
// padded to D + 4 floats, by cp.async: 16-byte copies stay aligned and a
// row's neighbour starts 4 banks over. Rows at or past n_rows are zero.
template <int kRows, int D, int kThreadsT>
__device__ __forceinline__ void load_rows_f32(uint32_t dst,
                                              const float* __restrict__ src,
                                              int r0, int n_rows) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < kRows * kChunks; e += kThreadsT) {
    const int r = e / kChunks, c = e % kChunks;
    const bool in = r0 + r < n_rows;
    cp_async16(dst + (r * (D + 4) + 4 * c) * 4,
               src + (in ? static_cast<int64_t>(r0 + r) * D + 4 * c : 0),
               in ? 16 : 0);
  }
}

// n consecutive floats by 16- (8-) byte loads, from shared memory or, the
// pointer being generic, device memory.
template <int kN>
__device__ __forceinline__ void lds(const float* p, float* o) {
  if constexpr (kN % 4 == 0) {
#pragma unroll
    for (int i = 0; i < kN; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      o[i] = x.x; o[i + 1] = x.y; o[i + 2] = x.z; o[i + 3] = x.w;
    }
  } else {
    static_assert(kN == 2, "2 or a multiple of 4 floats");
    const float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  }
}

// Reductions over the 16 lanes (one half-warp) that own a tile row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// mbarriers (the TMA rings of flash_attention_sm90.cu, K3's ring of
// contiguous rows in flash_decode.cu) and the 1D bulk copy
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to the copy engine and the other
// threads (before the __syncthreads that follows the init).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also tells the barrier to expect `bytes` of TMA writes.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits until the barrier's phase of this parity has completed (the spin
// is a PTX loop, so the warp leaves it converged for the wgmma that
// follows).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// memory to shared memory at dst, by the copy engine, completing `bytes`
// of bar's expected transactions.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// An arrival on bar once every cp.async this thread issued before it has
// landed; .noinc: bar's expected count includes this arrival.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

}  // namespace nsb
