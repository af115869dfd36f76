// Flash attention's non-causal bf16 kernels for Hopper (sm_90a): ring
// attention's off-diagonal blocks, each a (B*H, T, D) query chunk against
// a key chunk of the same length lying wholly in its past, at the ring
// block (B 1, H 12, T 1024, D 64) or the 8k config's batch 4.
//
//   flash_fwd_wgmma_kernel<D>         <- nanosandbox_tpu/ops/attention.py
//                                        _flash_fwd_kernel (K4)
//   flash_bwd_prep_kernel<D>,         <- _flash_bwd_tiles_kernel(
//   flash_bwd_wgmma_kernel<D, true>,     with_dq=True) (K5)
//   flash_bwd_dq_cast_kernel
//   flash_bwd_dq_wgmma_kernel<D>      <- _flash_bwd_dq_kernel (K6), the
//                                        split backward's dQ pass
//   flash_bwd_prep_kernel<D>,         <- _flash_bwd_tiles_kernel(
//   flash_bwd_wgmma_kernel<D, false>     with_dq=False) (K7), its dK/dV pass
//
// all causal=False, each backward with or without the lse cotangent. The
// causal instances and every fp32 instance stay in flash_attention.cu
// (mma.sync, or CUDA cores); ops/attention.py sends every bf16 non-causal
// call here and nothing else.
//
// What bounds them. A block of the ring does 4 D T^2 flops a (row, head)
// forward, 10 D T^2 fused backward, 6 and 8 D T^2 in K6 and K7: at the
// ring block 3.2, 8.1, 4.8 and 6.4 GFLOP, 3.3 to 8.1 us at the bf16
// tensor-core peak, against 6.3 to 11.3 MB (1.9 to 3.4 us at 3.35 TB/s).
// At D 64 a tile's exponentials (one per score, 16 a clock an SM) take as
// long as its products at the tensor cores' peak, and at B 1 the grid is
// only (T/64) x B*H = 192 blocks for 132 SMs. The mma.sync kernels they
// replace (8 warps and 128 queries a block forward: 96 blocks; 4 warps
// and 32-query tiles backward, dQ by scalar f32 atomics; K6 4 warps of 16
// queries each) ran at 9-11% of the bound.
//
// The design (TMA, mbarriers, wgmma):
//   - A block is one consumer warpgroup (warps 0-3, 64 rows: the M of a
//     wgmma) and one producer warp (warp 4), two blocks an SM (one for
//     the backward at D 128). One lane of
//     the producer brings every tile in by TMA (cp.async.bulk.tensor; 3-d
//     maps over (B*H, T, D), so rows past T arrive as zeros) into a ring of
//     stages, each guarded by a "full" mbarrier (TMA's transaction bytes)
//     and an "empty" one (the 128 consumer threads' arrivals).
//   - Tiles sit in shared memory as TMA writes them under a 128-byte
//     swizzle (64-byte at D 32): D split into panels of 64 (32) columns,
//     each panel row 128 (64) bytes, its 16-byte chunks XORed by the row
//     modulo 8. wgmma reads them through matrix descriptors of the same
//     swizzle mode: K-major (D contiguous: Q and K in S = Q K^T) with a
//     k-step 32 bytes along the row, or MN-major (V, dO and Q as the B of
//     P V, dP^T dO and dS^T Q: the contracted rows are the tile's rows)
//     with a k-step of 16 rows, two 8-row groups of 8 x kSw bytes.
//   - K4: a block owns 64 queries of one (row, head) and walks 64-key
//     tiles through a three-stage ring (two at D 128). S = Q K^T is a wgmma
//     from shared memory, O += P V one with P from registers (V MN-major).
//     The walk is software pipelined as FlashAttention-3's: tile t's S goes
//     out before tile t - 1's P V, and t's softmax runs, in place on S's
//     f32 accumulator, while P V is on the tensor cores; P is rounded to
//     bf16 fragments only after P V retires.
//   - K5: a block owns 64 keys of one (row, head) (K and V resident) and
//     walks every 64-query tile through a two-stage ring of Q, dO and the
//     tile's lse and Drow, starting at its own key tile's index so that the
//     blocks of a row add into different dQ tiles at any moment. S^T = K
//     Q^T and dP^T = V dO^T are wgmmas from shared memory; P~^T and dS^T =
//     P^T (dP^T - Drow) are made in registers and are the A operands of
//     dV += P~^T dO and dK += dS^T Q; dS^T also goes to shared memory
//     (swizzled by hand as TMA would) for dQ = dS K, dS read MN-major. At
//     D 128 the query tile is taken in two halves of 32 for S^T, dP^T, dV,
//     dK, so that they fit in registers with dK and dV. dQ is not summed
//     by atomics: the consumers write it into one of two staging buffers
//     (f32, under the 128-byte swizzle), and the producer warp adds each
//     into the f32 accumulator by TMA reduce-adds (cp.reduce.async.bulk
//     .tensor, reduced in L2) and frees the buffer once the reduce has read
//     it, so the consumers never wait on one. flash_bwd_prep_kernel, before
//     it, computes Drow = rowsum(dO o) - dlse, copies it and lse into a
//     scratch whose rows are padded to a multiple of 4 (so that one box of
//     a 3-d map brings a tile's lse and Drow), and zeroes the accumulator,
//     in one pass over the rows; flash_bwd_dq_cast_kernel, after it,
//     writes dq = bf16(dq_acc sm_scale). Three launches, where the mma.sync
//     path took a zeros fill, the pre-pass, the kernel and two elementwise
//     ops.
//   - K7: K5's kernel compiled without dQ (kWithDq false): no dS^T store,
//     no dQ product, no staging buffers, no reduce-adds and no dq_acc
//     map, so at D 64 its shared memory falls from about 91 KB to 51 KB.
//     It takes each query tile in two 32-query halves, as K5 does at D
//     128 (whole tiles spilled at D 64). The pre-pass makes the stats and
//     zeroes nothing: two launches. A
//     block writes only its own keys' dK and dV, so the split backward
//     gives the same bits on every run.
//   - K6: K4's skeleton, query-parallel. A block owns 64 queries of one
//     (row, head); Q and dO stay resident (TMA, once), 64-key K/V tiles
//     stream through a three-stage ring. S = Q K^T and dP = dO V^T are
//     wgmmas from shared memory (all K-major); P = exp2(S scale log2(e) -
//     lse log2(e)) and dS = P (dP~ - Drow) are made in place on S's
//     accumulator (dP~: dP under the keep-mask and 1 / (1 - rate)); dS,
//     rounded to bf16 fragments, is the A of dQ += dS K, K read MN-major
//     from the same tile that S read K-major (as K4's P V reads V). Tile
//     t's S and dP go out before tile t - 1's dQ product; dS is packed
//     only after that product retires. Drow = rowsum(dO o) - dlse and lse
//     of a thread's two rows are read with plain loads once per block, as
//     the JAX kernel computes Drow from o. dQ stays in registers and
//     leaves once as bf16(dQ sm_scale): one launch, no atomics, the same
//     bits on every run. Two blocks an SM (one at D 128, where dQ's two
//     panels beside S and dP would not fit in 168 registers).
//   - The element loops (softmax, P~ and dS) have no branch: the tail tile
//     and dropout select template instances outside them (a branch per
//     element exposed each exponential's latency, 2.2x the softmax's
//     time); exponentials are ex2.approx.ftz; the dropout keep-mask of a
//     tile is hashed into a bitmask while its scores are on the tensor
//     cores. Two blocks an SM leave a thread 168 registers (the 160 threads
//     are counted as 192): what the tile sizes are chosen to fit.
//
// Numerics are the mma.sync kernels': scores scaled in f32 after the
// product (exp2 of scores pre-multiplied by log2(e), lse stored in natural
// log); l sums the unmasked, unrounded p and dropout touches only the p.v
// sum; p is rounded to bf16 before p.v, ds before ds^T q and ds k; Drow in
// f32; dK and dQ scaled by sm_scale at the end. Non-causal, only the tail
// tile compares positions (keys, or queries, at or past T). The dropout
// keep-mask is dropout.cuh's, looked up by each accumulator element's
// global (query, key) position.
//
// Fragment layout. A wgmma accumulator of m64nN has, in thread t of the
// warpgroup (warp w = t / 32, lane l), rows 16 w + l / 4 and that + 8, and
// in each 8-column slice i columns 8 i + 2 (l % 4) and + 1: d[4 i + e] at
// the first row, d[4 i + 2 + e] at the second. The A operand from
// registers of an m64nNk16 is mma.sync's A fragment of the warp's 16 rows,
// so slices 2 kk and 2 kk + 1 of an accumulator, rounded to bf16 pairs,
// are k-step kk's A fragment as they stand.
//
// Layouts (row-major, contiguous): q, k, v, o, dO, dq, dk, dv (B*H, T, D)
// bf16; lse, dlse (B*H, T) f32; the stats scratch of K5 and K7 (2, B*H, T
// padded to a multiple of 4) f32; K5's dq_acc (B*H, T, D) f32. Every entry
// point returns a cudaError_t after its launches; the Python wrapper raises
// when it is not cudaSuccess. cuTensorMapEncodeTiled, a driver entry point,
// is looked up once in the process's libcuda.so.1.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

#include "decode_common.cuh"
#include "dropout.cuh"
#include "mma_common.cuh"

namespace nsb {
namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kConsumers = 128;  // one warpgroup
constexpr int kThreadsWg = kConsumers + 32;  // + the producer warp

// ---------------------------------------------------------------------------
// TMA loads and reduce-adds, bulk groups, named barriers (the mbarriers
// are mma_common.cuh's)
// ---------------------------------------------------------------------------

// A box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// A box of a tensor map += the shared-memory tile at src (reduced in L2;
// rows past the map's extent are dropped).
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map,
                                                  uint32_t src, int c0, int c1,
                                                  int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group "
      "[%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until at most N bulk groups still read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Shared-memory writes of the threads, made visible to the async proxy
// (wgmma's descriptor reads, the bulk copies).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// The consumer warpgroup alone (barrier 0 is __syncthreads).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// ---------------------------------------------------------------------------
// wgmma: m64nNk16, bf16 in, f32 accumulate; A and B from shared memory
// (ss, transposes tA / tB: 0 K-major, 1 MN-major) or A from registers
// (rs). scale_d 0 overwrites d.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Until at most N committed groups are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Registers an in-flight wgmma reads or writes: the compiler keeps them in
// place, and reads them only after this point (after the wait).
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int tA, int tB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(tA), "n"(tB));
}

template <int tB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(tB));
}

template <int tA, int tB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(tA), "n"(tB));
}

template <int tB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
        "n"(tB));
}
template <int P, int N>
__device__ __forceinline__ void hold(float (&r)[P][N]) {
#pragma unroll
  for (int p = 0; p < P; ++p) hold(r[p]);
}

// 2^x by one MUFU.EX2, results below 2^-126 flushed to 0 (exp2f adds a
// denormal fix-up around it; p feeds bf16 products, and the softmax's
// exponentials are as many as the tensor cores' k-steps take cycles at
// D 64).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}


// A shared-memory matrix descriptor: start address, leading byte offset 16
// (these swizzled layouts do not read it: a K-major k-step lies inside one
// swizzle row, an MN-major operand is one panel wide), stride byte offset
// `sbo` (from one 8-row group to the next) and the swizzle mode (1: 128
// bytes, 2: 64).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}

// A (rows x D) bf16 tile as TMA writes it: D in panels of kCols columns,
// each panel `rows` rows of kSw bytes, swizzled with a kSw-byte span; the
// tile starts on a 1024-byte boundary.
template <int D>
struct Tile {
  static constexpr int kSw = D >= 64 ? 128 : 64;  // bytes a panel row
  static constexpr int kCols = kSw / 2;           // bf16 a panel row
  static constexpr int kPanels = D / kCols;
  static constexpr uint64_t kMode = kSw == 128 ? 1 : 2;

  // K-major operand: 8-row groups from row r0 of a `rows`-row tile, the 16
  // columns (32 bytes) of k-step kk.
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows,
                                                    int r0, int kk) {
    const int col = 16 * kk;
    return smem_desc(tile + (col / kCols) * rows * kSw + r0 * kSw +
                         (col % kCols) * 2,
                     8 * kSw, kMode);
  }
  // MN-major operand: panel p's kCols columns, contracted over the 16 rows
  // from r0.
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows,
                                                     int p, int r0) {
    return smem_desc(tile + p * rows * kSw + r0 * kSw, 8 * kSw, kMode);
  }
};

// Rows [r0, r0 + rows) of (row*head) bh of a (B*H, T, D) map into a Tile,
// panel by panel (rows past T arrive as zeros).
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int rows, int r0,
                                          int bh) {
  using L = Tile<D>;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
    tma_load_3d(dst + p * rows * L::kSw, map, bar, p * L::kCols, r0, bh);
}

// d (64 x kN) = A B^T over D: A rows [0, 64) of an a_rows-row tile, B rows
// [b0, b0 + kN) of a b_rows-row tile, both K-major.
template <int D, int kN>
__device__ __forceinline__ void gemm_nt(float (&d)[kN / 2], uint32_t a,
                                        int a_rows, uint32_t b, int b_rows,
                                        int b0) {
  using L = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0, 0>(d, L::kmajor(a, a_rows, 0, kk),
                   L::kmajor(b, b_rows, b0, kk), kk);
}

// d += A B over kK contracted rows: A from registers (a[kk], k-step kk's
// fragment), B rows [b0, b0 + kK) of a b_rows-row tile read MN-major, a
// product per panel of D.
template <int D, int kK>
__device__ __forceinline__ void gemm_rn(
    float (&d)[Tile<D>::kPanels][Tile<D>::kCols / 2],
    const uint32_t (&a)[kK / 16][4], uint32_t b, int b_rows, int b0) {
  using L = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk)
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      wgmma_rs<1>(d[p], a[kk], L::mnmajor(b, b_rows, p, b0 + 16 * kk), 1);
}

// x, opaque to the compiler from here on: a tile address passed through it
// each step of a loop makes the compiler build each wgmma descriptor where
// it is used, instead of keeping all of them live across the loop.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// ---------------------------------------------------------------------------
// K4: one block per (64-query tile, row*head).
// ---------------------------------------------------------------------------

template <int D>
struct Fwd {
  // Queries a block, keys a tile. 128 keys (an m64n128 S product) halve
  // the walk's waits but spill at D 64: 128 scores, P's fragments and O
  // exceed the 168 registers a thread that two blocks an SM leave.
  static constexpr int kBM = 64, kBN = 64;
  // K/V ring depth: three stages leave a tile's load a whole iteration
  // ahead (three blocks an SM fit at D <= 64); at D 128 two, so that two
  // blocks fit.
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr uint32_t kQ = kBM * D * 2, kKV = kBN * D * 2;
  // + 1 KB to align the tiles to the swizzle's 1024-byte repeat.
  static constexpr size_t kSmem = 1024 + kQ + 2 * kStages * kKV;
};

// The dropout keep-mask of an accumulator tile of kN columns, a bit an
// element: bit 4 nt + 2 h + e for row r0 + 8 h and column j0 + 8 nt + 2 c +
// e (dropout.cuh's hash at those global positions for (row*head) bh of H
// heads; rows are queries and columns keys when kRowsQueries, else the
// other way around); 0 when dropout is off. The stream key is made here
// from the kernel's parameters each time, so that no register holds it
// across the walk, and the loop is unrolled only 8 deep, so that the
// hashes do not all hold registers at once; the kernels run this while
// the tile's scores are on the tensor cores.
template <int kN, bool kRowsQueries>
__device__ __forceinline__ uint64_t keep_bits(const DropoutArgs& da, int bh,
                                              int H, int r0, int j0, int c) {
  uint64_t bits = 0;
  if (!da.on) return bits;
  const Dropout dr = make_dropout(da, bh, H);
  // The hashed index (q_off + query) seq_len + k_off + key, as a row term
  // plus a column term; 8 hashes of the loop in flight at a time.
  uint32_t rt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t row = static_cast<uint32_t>(r0 + 8 * h);
    rt[h] = kRowsQueries ? (dr.q_off + row) * dr.seq_len : dr.k_off + row;
  }
#pragma unroll 8
  for (int x = 0; x < kN / 2; ++x) {
    const uint32_t col = static_cast<uint32_t>(j0 + 8 * (x >> 2) + 2 * c +
                                               (x & 1));
    const uint32_t idx = ((x >> 1) & 1 ? rt[1] : rt[0]) +
                         (kRowsQueries ? dr.k_off + col
                                       : (dr.q_off + col) * dr.seq_len);
    if (fmix32(idx ^ dr.mix) >= dr.threshold) bits |= uint64_t{1} << x;
  }
  return bits;
}

// One key tile's online softmax, in place on the raw scores s (the
// accumulator of S = Q K^T, retired): scaled to log2 units, keys at or
// past Tn masked (the tail tile only, kTail), the running max m and sum l
// of rows i0 and i0 + 8 updated, al the factors that bring O to the new
// max, and s left holding p with dropout applied. The loop runs this while
// a P V product is in flight; P's bf16 fragments are made only after it
// retires (pack_p), since ptxas serializes every wgmma of a kernel that
// defines a wgmma's input registers while a wgmma is in flight.
// kTail and kDrop are template arguments so that no branch splits the
// per-element loop (a branch there exposes each exponential's latency).
template <int kBN, bool kTail, bool kDrop>
__device__ __forceinline__ void softmax_tile(float (&s)[kBN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&al)[2], int k0, int c,
                                             int Tn, float scale2, float drop,
                                             uint64_t kept) {
  const int n_in = kTail ? Tn - k0 : kBN;  // the tile's keys below Tn
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (!kTail || 8 * nt + 2 * c + e < n_in)
          mx[h] = fmaxf(mx[h], s[4 * nt + 2 * h + e]);
  float sum[2] = {0.f, 0.f}, ms[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(m[h], quad_max(mx[h]) * scale2);
    al[h] = exp2_ftz(m[h] - mn);
    m[h] = mn;
    ms[h] = -mn;
  }
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 8 * nt + 2 * c + e;  // the tile's key column
        float& x = s[4 * nt + 2 * h + e];
        float p = exp2_ftz(fmaf(x, scale2, ms[h]));
        if (kTail && j >= n_in) p = 0.f;
        // l sums the unmasked p; dropout touches only the p.v sum.
        sum[h] += p;
        if (kDrop) p = (kept >> (4 * nt + 2 * h + e)) & 1 ? p * drop : 0.f;
        x = p;
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = al[h] * l[h] + sum[h];
}

// softmax_tile's instance for tile k0: the tail one where the tile holds
// keys at or past Tn, the dropout one where dropout is on (kept from
// keep_bits, drop its 1 / (1 - rate)).
template <int kBN>
__device__ __forceinline__ void softmax(float (&s)[kBN / 2], float (&m)[2],
                                        float (&l)[2], float (&al)[2], int k0,
                                        int c, int Tn, float scale2,
                                        const DropoutArgs& da, uint64_t kept) {
  if (k0 + kBN > Tn) {
    if (da.on)
      softmax_tile<kBN, true, true>(s, m, l, al, k0, c, Tn, scale2, da.scale,
                                    kept);
    else
      softmax_tile<kBN, true, false>(s, m, l, al, k0, c, Tn, scale2, 0.f, 0);
  } else if (da.on) {
    softmax_tile<kBN, false, true>(s, m, l, al, k0, c, Tn, scale2, da.scale,
                                   kept);
  } else {
    softmax_tile<kBN, false, false>(s, m, l, al, k0, c, Tn, scale2, 0.f, 0);
  }
}

// p (a score tile's accumulator layout) rounded to bf16 as the A fragments
// of P V: k-step kk takes 8-column slices 2 kk and 2 kk + 1.
template <int kBN>
__device__ __forceinline__ void pack_p(const float (&p)[kBN / 2],
                                       uint32_t (&pf)[kBN / 16][4]) {
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      pf[nt >> 1][(nt & 1) * 2 + h] =
          pack_bf16(p[4 * nt + 2 * h], p[4 * nt + 2 * h + 1]);
}

template <int D>
__global__ void __launch_bounds__(kThreadsWg, 2)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       bf16* __restrict__ o, float* __restrict__ lse, int H,
                       int Tn, float sm_scale, DropoutArgs da) {
  using P = Fwd<D>;
  using L = Tile<D>;
  constexpr int kBM = P::kBM, kBN = P::kBN, kS = P::kStages;
  constexpr int kPC = L::kCols / 8;  // 8-column slices of an O panel
  extern __shared__ unsigned char smem_raw[];
  // mbarriers: Q landed; stage s's K and V landed (full) and read (empty).
  __shared__ __align__(8) uint64_t bars[1 + 2 * kS];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t kv_s = q_s + P::kQ;  // stage s: K at kv_s + 2 s kKV, V next
  const uint32_t bar_q = smem_addr(&bars[0]), full0 = smem_addr(&bars[1]),
                 empty0 = smem_addr(&bars[1 + kS]);
  const int q0 = blockIdx.x * kBM, bh = blockIdx.y;
  const int n_kt = (Tn + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer warp: one lane issues every copy, a stage once the
    // consumers have released it.
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, P::kQ);
      load_tile<D>(q_s, &tq, bar_q, kBM, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kS;
        if (kt >= kS) mbar_wait(empty0 + 8 * s, (kt / kS - 1) & 1);
        const uint32_t k_s = kv_s + 2 * s * P::kKV, bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * P::kKV);
        load_tile<D>(k_s, &tk, bar, kBN, kt * kBN, bh);
        load_tile<D>(k_s + P::kKV, &tv, bar, kBN, kt * kBN, bh);
      }
    }
    return;
  }

  // The consumer warpgroup: rows i0 and i0 + 8 of the tile to a thread.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int i0 = q0 + 16 * warp + (lane >> 2);
  const float scale2 = sm_scale * kLog2e;
  float acc[L::kPanels][L::kCols / 2];
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int e = 0; e < L::kCols / 2; ++e) acc[p][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, al[2];
  uint32_t pf[kBN / 16][4];

  mbar_wait(bar_q, 0);
  {
    float s[kBN / 2];
    mbar_wait(full0, 0);
    wg_fence();
    gemm_nt<D, kBN>(s, q_s, kBM, kv_s, kBN, 0);
    wg_commit();
    const uint64_t kept = keep_bits<kBN, true>(da, bh, H, i0, 0, c);
    wg_wait<0>();
    hold(s);
    softmax<kBN>(s, m, l, al, 0, c, Tn, scale2, da, kept);
    pack_p<kBN>(s, pf);
  }
  // Tile kt's S product goes out before tile kt - 1's P V; kt's softmax
  // runs while P V is on the tensor cores.
  for (int kt = 1; kt < n_kt; ++kt) {
    const int sn = kt % kS, sp = (kt - 1) % kS;
    float s[kBN / 2];
    mbar_wait(full0 + 8 * sn, (kt / kS) & 1);
    wg_fence();
    gemm_nt<D, kBN>(s, opaque(q_s), kBM, kv_s + 2 * sn * P::kKV, kBN, 0);
    wg_commit();
    hold(acc);
    hold(pf);
    wg_fence();
    gemm_rn<D, kBN>(acc, pf, kv_s + (2 * sp + 1) * P::kKV, kBN, 0);
    wg_commit();
    const uint64_t kept = keep_bits<kBN, true>(da, bh, H, i0, kt * kBN, c);
    wg_wait<1>();  // S has landed
    hold(s);
    softmax<kBN>(s, m, l, al, kt * kBN, c, Tn, scale2, da, kept);
    wg_wait<0>();  // P V has landed
    hold(acc);
    hold(pf);
    mbar_arrive(empty0 + 8 * sp);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int e = 0; e < L::kCols / 2; ++e) acc[p][e] *= al[(e >> 1) & 1];
    pack_p<kBN>(s, pf);
  }
  hold(acc);
  hold(pf);
  wg_fence();
  gemm_rn<D, kBN>(acc, pf, kv_s + (2 * ((n_kt - 1) % kS) + 1) * P::kKV, kBN,
                  0);
  wg_commit();
  wg_wait<0>();
  hold(acc);
  hold(pf);

  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] = quad_sum(l[h]);
    inv[h] = 1.f / l[h];
  }
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int cc = 0; cc < kPC; ++cc)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 8 * h;
        if (i < Tn)
          *reinterpret_cast<uint32_t*>(o + base + static_cast<int64_t>(i) * D +
                                       p * L::kCols + 8 * cc + 2 * c) =
              pack_bf16(acc[p][4 * cc + 2 * h] * inv[h],
                        acc[p][4 * cc + 2 * h + 1] * inv[h]);
      }
  if (c == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = i0 + 8 * h;
      if (i < Tn)
        lse[static_cast<int64_t>(bh) * Tn + i] = m[h] * kLn2 + logf(l[h]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5 and K7: the pre-pass, one block per (64-key tile, row*head), K5's dQ
// cast.
// ---------------------------------------------------------------------------

// acc + the f32 dot product of 8 bf16 of o and of dO (16 bytes each).
__device__ __forceinline__ float dot8(const bf16* o, const bf16* dout,
                                      float acc) {
  const uint4 a = *reinterpret_cast<const uint4*>(o);
  const uint4 b = *reinterpret_cast<const uint4*>(dout);
  const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 fa = __bfloat1622float2(ha[i]);
    const float2 fb = __bfloat1622float2(hb[i]);
    acc = fmaf(fa.x, fb.x, acc);
    acc = fmaf(fa.y, fb.y, acc);
  }
  return acc;
}

// Over the rows r = (bh, t) of (B*H, T, D): the row statistics the
// key-parallel kernel stages, stats (2, B*H, Tp) f32 with T padded to Tp
// (a multiple of 4, so that TMA can address each (row, head)'s vector):
// stats[0, bh, t] = lse[r] log2(e) and stats[1, bh, t] = Drow =
// sum_d dO[r, d] o[r, d] - dlse[r] in f32 (no dlse: none subtracted); and,
// for K5 (dq_acc not null), row r of the f32 dQ accumulator zeroed. D / 8
// lanes a row, 8 bf16 of each a lane (the f32 sum in flash_attention.cu's
// pre-pass order).
template <int D>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dlse,
                      float* __restrict__ stats, float* __restrict__ dq_acc,
                      int64_t n_rows, int T, int Tp) {
  constexpr int kL = D / 8;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  const int64_t row = idx / kL;
  const int part = threadIdx.x % kL;
  float acc = 0.f;
  if (row < n_rows) {
    acc = dot8(o + row * D + part * 8, dout + row * D + part * 8, acc);
    if (dq_acc != nullptr) {
      float4* z = reinterpret_cast<float4*>(dq_acc + row * D + part * 8);
      z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
#pragma unroll
  for (int off = kL / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0 && row < n_rows) {
    const int64_t at = row / T * Tp + row % T;
    stats[at] = lse[row] * kLog2e;
    stats[n_rows / T * Tp + at] = dlse != nullptr ? acc - dlse[row] : acc;
  }
}

// dq = bf16(dq_acc * sm_scale), 8 entries a thread.
__global__ void __launch_bounds__(256)
flash_bwd_dq_cast_kernel(const float* __restrict__ dq_acc,
                         bf16* __restrict__ dq, int64_t n8, float sm_scale) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * 256 + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(dq_acc)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(dq_acc)[2 * i + 1];
  reinterpret_cast<uint4*>(dq)[i] = make_uint4(
      pack_bf16(a.x * sm_scale, a.y * sm_scale),
      pack_bf16(a.z * sm_scale, a.w * sm_scale),
      pack_bf16(b.x * sm_scale, b.y * sm_scale),
      pack_bf16(b.z * sm_scale, b.w * sm_scale));
}

// P~^T and dS^T = P^T (dP^T - Drow) of one S^T, dP^T product (rows: keys
// k0 + r0 and + 8; columns: queries q0 + col0 + the accumulator's) as the
// A fragments pa, dsa of dV += P~^T dO and dK += dS^T Q; dS^T also into
// the dS^T tile ds_p ([64 keys][64 queries] bf16, swizzled as a 128-byte
// TMA tile) for dQ when kStore (K5; K7 has no dQ). lse2_s and drow_s: the
// query tile's lse in log2 units and Drow. kMasked: a tail tile, where
// keys or queries at or past Tn get p = 0; kDrop: dropout on (template
// arguments, as in softmax_tile).
template <int kN, bool kStore, bool kMasked, bool kDrop>
__device__ __forceinline__ void bwd_probs(
    const float (&st)[kN / 2], const float (&dpt)[kN / 2],
    uint32_t (&pa)[kN / 16][4], uint32_t (&dsa)[kN / 16][4],
    unsigned char* ds_p, const float* lse2_s, const float* drow_s, int q0,
    int k0, int r0, int c, int col0, int Tn, float scale2, float drop,
    uint64_t kept) {
#pragma unroll
  for (int nt = 0; nt < kN / 8; ++nt) {
    const int qc = col0 + 8 * nt + 2 * c;  // query column
    const float2 lse2 = *reinterpret_cast<const float2*>(lse2_s + qc);
    const float2 drw = *reinterpret_cast<const float2*>(drow_s + qc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = k0 + r0 + 8 * hh;
      float pv[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = q0 + qc + e;
        float p = exp2_ftz(fmaf(st[4 * nt + 2 * hh + e], scale2,
                                e ? -lse2.y : -lse2.x));
        if (kMasked && (i >= Tn || j >= Tn)) p = 0.f;
        float dpv = dpt[4 * nt + 2 * hh + e];
        pv[e] = p;
        if (kDrop) {
          const bool keep = (kept >> (4 * nt + 2 * hh + e)) & 1;
          pv[e] = keep ? p * drop : 0.f;
          dpv = keep ? dpv * drop : 0.f;
        }
        ds[e] = p * (dpv - (e ? drw.y : drw.x));
      }
      pa[nt >> 1][(nt & 1) * 2 + hh] = pack_bf16(pv[0], pv[1]);
      dsa[nt >> 1][(nt & 1) * 2 + hh] = pack_bf16(ds[0], ds[1]);
      if (kStore) {
        const int kr = r0 + 8 * hh;
        *reinterpret_cast<uint32_t*>(ds_p + kr * 128 +
                                     (((qc >> 3) ^ (kr & 7)) << 4) +
                                     (qc & 7) * 2) =
            dsa[nt >> 1][(nt & 1) * 2 + hh];
      }
    }
  }
}

// bwd_probs's instance for this tile: masked or not, dropout or not (kept
// from keep_bits).
template <int kN, bool kStore>
__device__ __forceinline__ void bwd_probs_any(
    const float (&st)[kN / 2], const float (&dpt)[kN / 2],
    uint32_t (&pa)[kN / 16][4], uint32_t (&dsa)[kN / 16][4],
    unsigned char* ds_p, const float* lse2_s, const float* drow_s, int q0,
    int k0, int r0, int c, int col0, int Tn, float scale2,
    const DropoutArgs& da, uint64_t kept, bool masked) {
  if (masked) {
    if (da.on)
      bwd_probs<kN, kStore, true, true>(st, dpt, pa, dsa, ds_p, lse2_s,
                                        drow_s, q0, k0, r0, c, col0, Tn,
                                        scale2, da.scale, kept);
    else
      bwd_probs<kN, kStore, true, false>(st, dpt, pa, dsa, ds_p, lse2_s,
                                         drow_s, q0, k0, r0, c, col0, Tn,
                                         scale2, 0.f, 0);
  } else if (da.on) {
    bwd_probs<kN, kStore, false, true>(st, dpt, pa, dsa, ds_p, lse2_s,
                                       drow_s, q0, k0, r0, c, col0, Tn,
                                       scale2, da.scale, kept);
  } else {
    bwd_probs<kN, kStore, false, false>(st, dpt, pa, dsa, ds_p, lse2_s,
                                        drow_s, q0, k0, r0, c, col0, Tn,
                                        scale2, 0.f, 0);
  }
}

// kWithDq: K5; without it K7, which has no dS^T tile and no dQ staging.
template <int D, bool kWithDq>
struct Bwd {
  static constexpr int kBN = 64;  // keys a block: the warpgroup's 64 rows
  static constexpr int kBM = 64;  // queries a tile: the M of dQ = dS K
  // Queries of one S^T, dP^T product: at D 128 half a tile, so that dK and
  // dV (two panels each) and S^T, dP^T fit in registers together; in K7
  // half a tile too (whole tiles spilled 4 bytes at D 64 under the 168
  // registers of two blocks an SM; halves take 148).
  static constexpr int kBMh = D == 128 || !kWithDq ? 32 : 64;
  static constexpr int kStages = 2;
  static constexpr uint32_t kKV = kBN * D * 2, kQ = kBM * D * 2;
  static constexpr uint32_t kVec = kBM * 4;  // lse or Drow of a tile
  // A stage: Q, dO, then lse and Drow (one box of the stats map) in a 1 KB
  // slot (the next stage's Q starts on a swizzle repeat).
  static constexpr uint32_t kStage = 2 * kQ + 1024;
  static constexpr uint32_t kDs = kBN * kBM * 2;  // dS^T, 128-byte rows
  // A dQ staging buffer: f32 panels of 32 columns, each 64 rows of 128
  // bytes under the 128-byte swizzle, as the dq_acc map's reduce reads it
  // (a warp's float2 writes then fall in distinct banks).
  static constexpr int kDqPanels = D / 32;
  static constexpr uint32_t kDq = kBM * D * 4;
  static constexpr size_t kSmem =
      1024 + 2 * kKV + kStages * kStage + (kWithDq ? kDs + 2 * kDq : 0);
};

// Blocks an SM K5's and K7's kernel is built for (a constant of D alone,
// so that __launch_bounds__ gets no template argument list with a comma).
template <int D>
constexpr int kBwdMinBlocks = D == 128 ? 1 : 2;

// K7's place for K5's dq_acc map: no map at all.
struct NoMap {};
template <bool kWithDq>
using DqMap = typename std::conditional<kWithDq, CUtensorMap, NoMap>::type;

template <int D, bool kWithDq>
__global__ void __launch_bounds__(kThreadsWg, kBwdMinBlocks<D>)
flash_bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tstats,
                       const __grid_constant__ DqMap<kWithDq> tdq,
                       bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int Tn, float sm_scale,
                       DropoutArgs da) {
  using P = Bwd<D, kWithDq>;
  using L = Tile<D>;
  constexpr int kBN = P::kBN, kBM = P::kBM, kBMh = P::kBMh, kS = P::kStages;
  constexpr int kPC = L::kCols / 8;  // 8-column slices of a panel
  extern __shared__ unsigned char smem_raw[];
  // mbarriers: K and V landed; stage s landed (full) and read (empty);
  // K5's dQ staging buffer b written (dq_full) and read by its reduce
  // (dq_empty).
  __shared__ __align__(8) uint64_t bars[1 + 2 * kS + 4];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u, v_s = k_s + P::kKV;
  const uint32_t ring = v_s + P::kKV, ds_s = ring + kS * P::kStage;
  const uint32_t dq_s = ds_s + P::kDs;  // two buffers (K5)
  unsigned char* const base = smem_raw + (k_s - raw);
  unsigned char* const ds_p = base + (ds_s - k_s);
  const uint32_t bar_kv = smem_addr(&bars[0]), full0 = smem_addr(&bars[1]),
                 empty0 = smem_addr(&bars[1 + kS]),
                 dq_full0 = smem_addr(&bars[1 + 2 * kS]),
                 dq_empty0 = dq_full0 + 16;
  const int k0 = blockIdx.x * kBN, bh = blockIdx.y;
  const int n_qt = (Tn + kBM - 1) / kBM;
  // K5: the blocks of a (row, head) start their walks at different query
  // tiles, so that at any moment they add into different dQ tiles.
  const int qt0 = kWithDq ? blockIdx.x % n_qt : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    for (int b = 0; b < (kWithDq ? 2 : 0); ++b) {
      mbar_init(dq_full0 + 8 * b, kConsumers);
      mbar_init(dq_empty0 + 8 * b, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer warp: one lane brings every tile in and (K5) sends
    // every dQ tile out. Its step it loads query tile it once the
    // consumers have released its stage, then adds tile it - 1's dQ
    // (staged by the consumers) into dq_acc, so that the consumers never
    // wait on a reduce.
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_kv, 2 * P::kKV);
      load_tile<D>(k_s, &tk, bar_kv, kBN, k0, bh);
      load_tile<D>(v_s, &tv, bar_kv, kBN, k0, bh);
      // Generic, so that K7 (no map) never instantiates its body.
      auto add_dq = [&](const auto& map, int t) {
        const int b = t & 1;
        mbar_wait(dq_full0 + 8 * b, (t >> 1) & 1);
        const uint32_t buf = dq_s + b * P::kDq;
        for (int p = 0; p < P::kDqPanels; ++p)
          tma_reduce_add_3d(&map, buf + p * kBM * 128, 32 * p,
                            (qt0 + t) % n_qt * kBM, bh);
        bulk_commit();
        bulk_wait_read<0>();
        mbar_arrive(dq_empty0 + 8 * b);
      };
      for (int it = 0; it < n_qt; ++it) {
        const int s = it % kS, q0 = (qt0 + it) % n_qt * kBM;
        if (it >= kS) mbar_wait(empty0 + 8 * s, (it / kS - 1) & 1);
        const uint32_t st = ring + s * P::kStage, bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * P::kQ + 2 * P::kVec);
        load_tile<D>(st, &tq, bar, kBM, q0, bh);
        load_tile<D>(st + P::kQ, &tdo, bar, kBM, q0, bh);
        tma_load_3d(st + 2 * P::kQ, &tstats, bar, q0, bh, 0);  // lse, Drow
        if constexpr (kWithDq) {
          if (it > 0) add_dq(tdq, it - 1);
        }
      }
      if constexpr (kWithDq) {
        add_dq(tdq, n_qt - 1);
        bulk_wait_all();
      }
    }
    return;
  }

  // The consumer warpgroup: key rows r0 and r0 + 8 of the tile to a thread
  // in S^T, dP^T, dK, dV; query rows r0 and r0 + 8 in K5's dQ.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & 3, r0 = 16 * warp + (lane >> 2);
  const float scale2 = sm_scale * kLog2e;
  float dk_acc[L::kPanels][L::kCols / 2], dv_acc[L::kPanels][L::kCols / 2];
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int e = 0; e < L::kCols / 2; ++e) dk_acc[p][e] = dv_acc[p][e] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int it = 0; it < n_qt; ++it) {
    const int s = it % kS, q0 = (qt0 + it) % n_qt * kBM;
    const uint32_t q_st = ring + s * P::kStage, do_st = q_st + P::kQ;
    const uint32_t kt_s = opaque(k_s), vt_s = opaque(v_s);
    const float* lse2_s =
        reinterpret_cast<const float*>(base + (q_st - k_s) + 2 * P::kQ);
    const float* drow_s = lse2_s + kBM;
    // Only a tile at the tail of the queries or of the keys compares
    // positions.
    const bool masked = q0 + kBM > Tn || k0 + kBN > Tn;
    mbar_wait(full0 + 8 * s, (it / kS) & 1);
#pragma unroll
    for (int h = 0; h < kBM / kBMh; ++h) {
      float st[kBMh / 2], dpt[kBMh / 2];  // rows keys, columns queries
      wg_fence();
      gemm_nt<D, kBMh>(st, kt_s, kBN, q_st, kBM, h * kBMh);
      gemm_nt<D, kBMh>(dpt, vt_s, kBN, do_st, kBM, h * kBMh);
      wg_commit();
      const uint64_t kept =
          keep_bits<kBMh, false>(da, bh, H, k0 + r0, q0 + h * kBMh, c);
      wg_wait<0>();
      hold(st);
      hold(dpt);
      uint32_t pa[kBMh / 16][4], dsa[kBMh / 16][4];
      bwd_probs_any<kBMh, kWithDq>(st, dpt, pa, dsa, ds_p, lse2_s, drow_s,
                                   q0, k0, r0, c, h * kBMh, Tn, scale2, da,
                                   kept, masked);
      // dV += P~^T dO, dK += dS^T Q (dO and Q MN-major); the fragments
      // and accumulators are final before the fence.
      hold(pa);
      hold(dsa);
      hold(dv_acc);
      hold(dk_acc);
      wg_fence();
      gemm_rn<D, kBMh>(dv_acc, pa, do_st, kBM, h * kBMh);
      gemm_rn<D, kBMh>(dk_acc, dsa, q_st, kBM, h * kBMh);
      wg_commit();
      wg_wait<0>();
      hold(dv_acc);
      hold(dk_acc);
      hold(pa);
      hold(dsa);
    }
    mbar_arrive(empty0 + 8 * s);  // Q, dO, lse and Drow are read
    if constexpr (kWithDq) {
      fence_async_smem();  // dS^T, for the wgmma's reads
      consumers_sync();

      // dQ = dS K over the tile's 64 keys: dS^T read MN-major as A, K as
      // B.
      float dqa[L::kPanels][L::kCols / 2];
      const uint32_t dst_s = opaque(ds_s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p)
          wgmma_ss<1, 1>(dqa[p], Tile<64>::mnmajor(dst_s, kBN, 0, 16 * kk),
                         L::mnmajor(kt_s, kBN, p, 16 * kk), kk);
      wg_commit();
      wg_wait<0>();
      hold(dqa);

      // Into staging buffer it & 1, once the reduce that last read it is
      // done; the producer adds it into dq_acc (a TMA reduce-add a panel).
      const int b = it & 1;
      unsigned char* const buf_p = base + (dq_s + b * P::kDq - k_s);
      if (it >= 2) mbar_wait(dq_empty0 + 8 * b, ((it >> 1) - 1) & 1);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
        for (int cc = 0; cc < kPC; ++cc)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int col = p * L::kCols + 8 * cc + 2 * c, row = r0 + 8 * hh;
            *reinterpret_cast<float2*>(
                buf_p + (col / 32) * kBM * 128 + row * 128 +
                ((((col % 32) / 4) ^ (row & 7)) << 4) + (col % 4) * 4) =
                make_float2(dqa[p][4 * cc + 2 * hh],
                            dqa[p][4 * cc + 2 * hh + 1]);
          }
      fence_async_smem();
      mbar_arrive(dq_full0 + 8 * b);
    }
  }

  const int64_t base_g = static_cast<int64_t>(bh) * Tn * D;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int cc = 0; cc < kPC; ++cc)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int j = k0 + r0 + 8 * hh;
        if (j < Tn) {
          const int64_t off = base_g + static_cast<int64_t>(j) * D +
                              p * L::kCols + 8 * cc + 2 * c;
          *reinterpret_cast<uint32_t*>(dk + off) =
              pack_bf16(dk_acc[p][4 * cc + 2 * hh] * sm_scale,
                        dk_acc[p][4 * cc + 2 * hh + 1] * sm_scale);
          *reinterpret_cast<uint32_t*>(dv + off) = pack_bf16(
              dv_acc[p][4 * cc + 2 * hh], dv_acc[p][4 * cc + 2 * hh + 1]);
        }
      }
}

// ---------------------------------------------------------------------------
// K6: one block per (64-query tile, row*head), dQ of the split backward.
// ---------------------------------------------------------------------------

template <int D>
struct BwdDq {
  static constexpr int kBM = 64, kBN = 64;  // queries a block, keys a tile
  // K/V ring depth: three stages leave a tile's load a whole iteration
  // ahead, and two blocks an SM still fit at D <= 64 (one at D 128).
  static constexpr int kStages = 3;
  static constexpr uint32_t kQ = kBM * D * 2, kKV = kBN * D * 2;
  // + 1 KB to align the tiles to the swizzle's 1024-byte repeat: Q, dO,
  // then the ring's (K, V) stages.
  static constexpr size_t kSmem = 1024 + 2 * kQ + 2 * kStages * kKV;
  // At D 128 dQ's two panels, S and dP (128 f32 registers a thread) leave
  // too little of the 168 registers that two blocks an SM allow.
  static constexpr int kMinBlocks = D == 128 ? 1 : 2;
};

// dS = P (dP~ - Drow) of one key tile, in place on the raw scores s (the
// accumulator of S = Q K^T, retired; rows queries i0 and i0 + 8, columns
// keys k0 + the accumulator's): P = exp2(s scale2 - lse2), keys at or past
// Tn masked (the tail tile only, kTail), dP~ = dP under the keep-mask and
// its 1 / (1 - rate) (kDrop; kept from keep_bits). lse2 and drow: the
// thread's two rows' lse in log2 units (+inf past T, so their P is 0) and
// Drow. Template flags, as in softmax_tile, keep the loop free of
// branches.
template <int kBN, bool kTail, bool kDrop>
__device__ __forceinline__ void dq_tile(float (&s)[kBN / 2],
                                        const float (&dp)[kBN / 2],
                                        const float (&lse2)[2],
                                        const float (&drow)[2], int k0, int c,
                                        int Tn, float scale2, float drop,
                                        uint64_t kept) {
  const int n_in = kTail ? Tn - k0 : kBN;  // the tile's keys below Tn
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * nt + 2 * h + e;
        float p = exp2_ftz(fmaf(s[x], scale2, -lse2[h]));
        if (kTail && 8 * nt + 2 * c + e >= n_in) p = 0.f;
        float dpv = dp[x];
        if (kDrop) dpv = (kept >> x) & 1 ? dpv * drop : 0.f;
        s[x] = p * (dpv - drow[h]);
      }
}

// dq_tile's instance for tile k0: the tail one where the tile holds keys
// at or past Tn, the dropout one where dropout is on.
template <int kBN>
__device__ __forceinline__ void dq_scores(float (&s)[kBN / 2],
                                          const float (&dp)[kBN / 2],
                                          const float (&lse2)[2],
                                          const float (&drow)[2], int k0,
                                          int c, int Tn, float scale2,
                                          const DropoutArgs& da,
                                          uint64_t kept) {
  if (k0 + kBN > Tn) {
    if (da.on)
      dq_tile<kBN, true, true>(s, dp, lse2, drow, k0, c, Tn, scale2,
                               da.scale, kept);
    else
      dq_tile<kBN, true, false>(s, dp, lse2, drow, k0, c, Tn, scale2, 0.f,
                                0);
  } else if (da.on) {
    dq_tile<kBN, false, true>(s, dp, lse2, drow, k0, c, Tn, scale2, da.scale,
                              kept);
  } else {
    dq_tile<kBN, false, false>(s, dp, lse2, drow, k0, c, Tn, scale2, 0.f, 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsWg, BwdDq<D>::kMinBlocks)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const bf16* __restrict__ o,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dlse,
                          bf16* __restrict__ dq, int H, int Tn,
                          float sm_scale, DropoutArgs da) {
  using P = BwdDq<D>;
  using L = Tile<D>;
  constexpr int kBM = P::kBM, kBN = P::kBN, kS = P::kStages;
  constexpr int kPC = L::kCols / 8;  // 8-column slices of a dQ panel
  extern __shared__ unsigned char smem_raw[];
  // mbarriers: Q and dO landed; stage s's K and V landed (full) and read
  // (empty).
  __shared__ __align__(8) uint64_t bars[1 + 2 * kS];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + P::kQ;
  const uint32_t kv_s = do_s + P::kQ;  // stage s: K at kv_s + 2 s kKV, V next
  const uint32_t bar_q = smem_addr(&bars[0]), full0 = smem_addr(&bars[1]),
                 empty0 = smem_addr(&bars[1 + kS]);
  const int q0 = blockIdx.x * kBM, bh = blockIdx.y;
  const int n_kt = (Tn + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // The producer warp: one lane issues every copy, a stage once the
    // consumers have released it.
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(bar_q, 2 * P::kQ);
      load_tile<D>(q_s, &tq, bar_q, kBM, q0, bh);
      load_tile<D>(do_s, &tdo, bar_q, kBM, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kS;
        if (kt >= kS) mbar_wait(empty0 + 8 * s, (kt / kS - 1) & 1);
        const uint32_t k_s = kv_s + 2 * s * P::kKV, bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * P::kKV);
        load_tile<D>(k_s, &tk, bar, kBN, kt * kBN, bh);
        load_tile<D>(k_s + P::kKV, &tv, bar, kBN, kt * kBN, bh);
      }
    }
    return;
  }

  // The consumer warpgroup: query rows i0 and i0 + 8 of the tile to a
  // thread.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int i0 = q0 + 16 * warp + (lane >> 2);
  const float scale2 = sm_scale * kLog2e;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  // The rows' lse (log2 units) and Drow = rowsum(dO o) - dlse, while Q, dO
  // and the first tiles land: the four lanes of a row take every fourth
  // 8-column chunk.
  float lse2[2], drow[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 8 * h;
    float acc = 0.f;
    if (i < Tn) {
      const int64_t row = base + static_cast<int64_t>(i) * D;
#pragma unroll
      for (int ch = c; ch < D / 8; ch += 4)
        acc = dot8(o + row + 8 * ch, dout + row + 8 * ch, acc);
    }
    acc = quad_sum(acc);
    lse2[h] = __int_as_float(0x7f800000);  // +inf: a row past T
    if (i < Tn) {
      const int64_t r = static_cast<int64_t>(bh) * Tn + i;
      lse2[h] = lse[r] * kLog2e;
      if (dlse != nullptr) acc -= dlse[r];
    }
    drow[h] = acc;
  }
  float acc[L::kPanels][L::kCols / 2];
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int e = 0; e < L::kCols / 2; ++e) acc[p][e] = 0.f;
  uint32_t dsf[kBN / 16][4];

  mbar_wait(bar_q, 0);
  {
    float s[kBN / 2], dp[kBN / 2];
    mbar_wait(full0, 0);
    wg_fence();
    gemm_nt<D, kBN>(s, q_s, kBM, kv_s, kBN, 0);
    gemm_nt<D, kBN>(dp, do_s, kBM, kv_s + P::kKV, kBN, 0);
    wg_commit();
    const uint64_t kept = keep_bits<kBN, true>(da, bh, H, i0, 0, c);
    wg_wait<0>();
    hold(s);
    hold(dp);
    dq_scores<kBN>(s, dp, lse2, drow, 0, c, Tn, scale2, da, kept);
    pack_p<kBN>(s, dsf);
  }
  // Tile kt's S and dP go out before tile kt - 1's dQ += dS K (K of stage
  // kt - 1 read MN-major); kt's dS is made while that product is on the
  // tensor cores, and packed once it retires.
  for (int kt = 1; kt < n_kt; ++kt) {
    const int sn = kt % kS, sp = (kt - 1) % kS;
    const uint32_t k_n = kv_s + 2 * sn * P::kKV;
    float s[kBN / 2], dp[kBN / 2];
    mbar_wait(full0 + 8 * sn, (kt / kS) & 1);
    wg_fence();
    gemm_nt<D, kBN>(s, opaque(q_s), kBM, k_n, kBN, 0);
    gemm_nt<D, kBN>(dp, opaque(do_s), kBM, k_n + P::kKV, kBN, 0);
    wg_commit();
    hold(acc);
    hold(dsf);
    wg_fence();
    gemm_rn<D, kBN>(acc, dsf, kv_s + 2 * sp * P::kKV, kBN, 0);
    wg_commit();
    const uint64_t kept = keep_bits<kBN, true>(da, bh, H, i0, kt * kBN, c);
    wg_wait<1>();  // S and dP have landed
    hold(s);
    hold(dp);
    dq_scores<kBN>(s, dp, lse2, drow, kt * kBN, c, Tn, scale2, da, kept);
    wg_wait<0>();  // dQ += dS K has landed
    hold(acc);
    hold(dsf);
    mbar_arrive(empty0 + 8 * sp);
    pack_p<kBN>(s, dsf);
  }
  hold(acc);
  hold(dsf);
  wg_fence();
  gemm_rn<D, kBN>(acc, dsf, kv_s + 2 * ((n_kt - 1) % kS) * P::kKV, kBN, 0);
  wg_commit();
  wg_wait<0>();
  hold(acc);
  hold(dsf);

#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int cc = 0; cc < kPC; ++cc)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = i0 + 8 * h;
        if (i < Tn)
          *reinterpret_cast<uint32_t*>(dq + base + static_cast<int64_t>(i) * D +
                                       p * L::kCols + 8 * cc + 2 * c) =
              pack_bf16(acc[p][4 * cc + 2 * h] * sm_scale,
                        acc[p][4 * cc + 2 * h + 1] * sm_scale);
      }
}

// ---------------------------------------------------------------------------
// Host side: tensor maps, launchers, the C entry points.
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process already runs on.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A (B*H, T, D) bf16 tensor, in boxes of `rows` rows by one Tile<D> panel,
// swizzled as Tile<D> lays it out; reads past T give zeros.
template <int D>
bool rows_map(CUtensorMap* map, const void* p, int BH, int T, int rows) {
  using L = Tile<D>;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {D * sizeof(bf16),
                                 static_cast<cuuint64_t>(T) * D * sizeof(bf16)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(L::kCols),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (2, B*H, Tp) f32 row statistics in boxes of `len` entries of both
// vectors of one (row, head); reads past T give zeros.
bool stats_map(CUtensorMap* map, const float* p, int BH, int T, int Tp,
               int len) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH), 2};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(Tp) * sizeof(float),
      static_cast<cuuint64_t>(Tp) * BH * sizeof(float)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(len), 1, 2};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(
             map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The (B*H, T, D) f32 dQ accumulator, in boxes of 64 rows by 32 columns
// under the 128-byte swizzle (K5's dQ staging buffer).
bool dq_map(CUtensorMap* map, float* p, int BH, int T, int D) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {
      D * sizeof(float), static_cast<cuuint64_t>(T) * D * sizeof(float)};
  const cuuint32_t box[3] = {32, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(
             map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, p, dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// T padded to a multiple of 4: the stats' row stride is then a multiple of
// 16 bytes, as a tensor map needs.
constexpr int padded_rows(int T) { return (T + 3) & ~3; }

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
  const float *lse_in, *dlse;
  float *lse_out, *stats, *dq_acc;
  void *out, *dq, *dk, *dv;
  int BH, H, T;
  float sm_scale;
  DropoutArgs dr;
  cudaStream_t stream;
};

template <int D>
cudaError_t run_fwd(const Call& c) {
  using P = Fwd<D>;
  CUtensorMap mq, mk, mv;
  if (!rows_map<D>(&mq, c.q, c.BH, c.T, P::kBM) ||
      !rows_map<D>(&mk, c.k, c.BH, c.T, P::kBN) ||
      !rows_map<D>(&mv, c.v, c.BH, c.T, P::kBN))
    return cudaErrorInvalidValue;
  const dim3 grid((c.T + P::kBM - 1) / P::kBM, c.BH);
  return launch(flash_fwd_wgmma_kernel<D>, grid, kThreadsWg, P::kSmem,
                c.stream, mq, mk, mv, static_cast<bf16*>(c.out), c.lse_out,
                c.H, c.T, c.sm_scale, c.dr);
}

// K5 (kWithDq): the pre-pass, the key-parallel kernel, the dQ cast, three
// launches; K7: the pre-pass (no accumulator to zero) and the kernel, two.
template <int D, bool kWithDq>
cudaError_t run_bwd(const Call& c) {
  using P = Bwd<D, kWithDq>;
  const int64_t rows = static_cast<int64_t>(c.BH) * c.T;
  const int Tp = padded_rows(c.T);
  CUtensorMap mq, mk, mv, mdo, mstats;
  DqMap<kWithDq> mdq{};
  if (!rows_map<D>(&mq, c.q, c.BH, c.T, P::kBM) ||
      !rows_map<D>(&mdo, c.dout, c.BH, c.T, P::kBM) ||
      !rows_map<D>(&mk, c.k, c.BH, c.T, P::kBN) ||
      !rows_map<D>(&mv, c.v, c.BH, c.T, P::kBN) ||
      !stats_map(&mstats, c.stats, c.BH, c.T, Tp, P::kBM))
    return cudaErrorInvalidValue;
  if constexpr (kWithDq) {
    if (!dq_map(&mdq, c.dq_acc, c.BH, c.T, D)) return cudaErrorInvalidValue;
  }
  flash_bwd_prep_kernel<D>
      <<<static_cast<unsigned>((rows * (D / 8) + 255) / 256), 256, 0,
         c.stream>>>(static_cast<const bf16*>(c.o),
                     static_cast<const bf16*>(c.dout), c.lse_in, c.dlse,
                     c.stats, kWithDq ? c.dq_acc : nullptr, rows, c.T, Tp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const dim3 grid((c.T + P::kBN - 1) / P::kBN, c.BH);
  e = launch(flash_bwd_wgmma_kernel<D, kWithDq>, grid, kThreadsWg, P::kSmem,
             c.stream, mq, mk, mv, mdo, mstats, mdq,
             static_cast<bf16*>(c.dk), static_cast<bf16*>(c.dv), c.H, c.T,
             c.sm_scale, c.dr);
  if (e != cudaSuccess || !kWithDq) return e;
  const int64_t n8 = rows * D / 8;
  flash_bwd_dq_cast_kernel<<<static_cast<unsigned>((n8 + 255) / 256), 256, 0,
                             c.stream>>>(c.dq_acc, static_cast<bf16*>(c.dq),
                                         n8, c.sm_scale);
  return cudaGetLastError();
}

// K6: the query-parallel kernel alone, one launch.
template <int D>
cudaError_t run_bwd_dq(const Call& c) {
  using P = BwdDq<D>;
  CUtensorMap mq, mk, mv, mdo;
  if (!rows_map<D>(&mq, c.q, c.BH, c.T, P::kBM) ||
      !rows_map<D>(&mdo, c.dout, c.BH, c.T, P::kBM) ||
      !rows_map<D>(&mk, c.k, c.BH, c.T, P::kBN) ||
      !rows_map<D>(&mv, c.v, c.BH, c.T, P::kBN))
    return cudaErrorInvalidValue;
  const dim3 grid((c.T + P::kBM - 1) / P::kBM, c.BH);
  return launch(flash_bwd_dq_wgmma_kernel<D>, grid, kThreadsWg, P::kSmem,
                c.stream, mq, mk, mv, mdo, static_cast<const bf16*>(c.o),
                static_cast<const bf16*>(c.dout), c.lse_in, c.dlse,
                static_cast<bf16*>(c.dq), c.H, c.T, c.sm_scale, c.dr);
}

// The modes of the C entry points, as flash_attention.cu numbers them: a
// backward mode, or -1 for the forward.
enum BwdMode { kFused = 0, kDq = 1, kDkv = 2 };

// {grid x, grid y, threads, blocks an SM} of the main kernel of `mode` at
// (BH, T).
template <int D>
cudaError_t shape(int mode, int BH, int T, int* out) {
  const void* fn;
  size_t smem;
  switch (mode) {
    case -1:
      fn = reinterpret_cast<const void*>(flash_fwd_wgmma_kernel<D>);
      smem = Fwd<D>::kSmem;
      break;
    case kFused:
      fn = reinterpret_cast<const void*>(flash_bwd_wgmma_kernel<D, true>);
      smem = Bwd<D, true>::kSmem;
      break;
    case kDq:
      fn = reinterpret_cast<const void*>(flash_bwd_dq_wgmma_kernel<D>);
      smem = BwdDq<D>::kSmem;
      break;
    case kDkv:
      fn = reinterpret_cast<const void*>(flash_bwd_wgmma_kernel<D, false>);
      smem = Bwd<D, false>::kSmem;
      break;
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  out[0] = (T + 63) / 64;  // the 64 queries or keys of every kernel's block
  out[1] = BH;
  out[2] = kThreadsWg;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], fn,
                                                       kThreadsWg, smem);
}

template <typename F>
cudaError_t by_head_dim(int D, F f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace nsb

extern "C" {

// K4, non-causal, bf16. Returns a cudaError_t: cudaSuccess (0) once the
// kernel is queued.
int nsb_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                       float* lse, const long long* seed, int BH, int H, int T,
                       int D, float sm_scale, int dropout_on,
                       unsigned threshold, float keep_scale,
                       unsigned hash_seq_len, void* stream) {
  using namespace nsb;
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  Call c{};
  c.q = q; c.k = k; c.v = v; c.out = o; c.lse_out = lse;
  c.BH = BH; c.H = H; c.T = T; c.sm_scale = sm_scale;
  c.dr = DropoutArgs{seed, dropout_on, threshold, keep_scale, hash_seq_len};
  c.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      by_head_dim(D, [&](auto d) { return run_fwd<decltype(d)::value>(c); }));
}

// The non-causal bf16 backward of `mode`: 0 K5 (fused: dq, dk, dv), 1 K6
// (dq), 2 K7 (dk, dv); the other outputs are unused. stats (2, B*H, T
// rounded up to a multiple of 4) f32 is K5's and K7's scratch, dq_acc
// (B*H, T, D) f32 K5's (the pre-pass fills both); K6 takes neither. dlse,
// the lse output's (B*H, T) f32 cotangent, may be null (none).
int nsb_flash_bwd_sm90(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       const float* dlse, const long long* seed, float* stats,
                       float* dq_acc, void* dq, void* dk, void* dv, int BH,
                       int H, int T, int D, float sm_scale, int dropout_on,
                       unsigned threshold, float keep_scale,
                       unsigned hash_seq_len, int mode, void* stream) {
  using namespace nsb;
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  if ((mode != kDq && stats == nullptr) ||
      (mode == kFused && dq_acc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Call c{};
  c.q = q; c.k = k; c.v = v; c.o = o; c.dout = dout; c.lse_in = lse;
  c.dlse = dlse; c.stats = stats; c.dq_acc = dq_acc;
  c.dq = dq; c.dk = dk; c.dv = dv;
  c.BH = BH; c.H = H; c.T = T; c.sm_scale = sm_scale;
  c.dr = DropoutArgs{seed, dropout_on, threshold, keep_scale, hash_seq_len};
  c.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    switch (mode) {
      case kFused: return run_bwd<kD, true>(c);
      case kDq: return run_bwd_dq<kD>(c);
      case kDkv: return run_bwd<kD, false>(c);
      default: return cudaErrorInvalidValue;
    }
  }));
}

// out = {grid x, grid y, threads a block, blocks an SM} of K4's kernel
// (mode -1) or of the main kernel of backward mode 0-2 (K5's key-parallel
// kernel, K6's, K7's) at (BH, T, D).
int nsb_flash_sm90_shape(int mode, int BH, int T, int D, int* out) {
  using namespace nsb;
  return static_cast<int>(by_head_dim(
      D, [&](auto d) { return shape<decltype(d)::value>(mode, BH, T, out); }));
}

}  // extern "C"
