// Causal flash attention for training, forward and backward, for Hopper
// (sm_90a).
//
// Four kernels, each the CUDA counterpart of a Pallas kernel in
// nanosandbox_tpu/ops/attention.py:
//
//   flash_fwd_kernel            <- _flash_fwd_kernel (K4)
//       o and the per-row logsumexp; optional hash dropout on p.v.
//   flash_bwd_kv_kernel<true>   <- _flash_bwd_tiles_kernel(with_dq=True)
//       (K5) the fused backward: dK, dV per key tile, dQ added into an f32
//       buffer with atomicAdd.
//   flash_bwd_dq_kernel         <- _flash_bwd_dq_kernel (K6)
//       the split backward's dQ pass, parallel over query tiles.
//   flash_bwd_kv_kernel<false>  <- _flash_bwd_tiles_kernel(with_dq=False)
//       (K7) the split backward's dK/dV pass: K5 without dQ.
//
// What bounds them. Per (row, head) the forward does 4*D*T(T+1)/2 flops and
// moves q, k, v and o once; the backward does 2.5x (fused) to 3.5x (split)
// those flops over about twice the bytes. At GPT-2 124M's training shape
// (B 16, H 12, T 1024, D 64, bf16) the forward's 25.8 GFLOP take 0.026 ms
// at the bf16 tensor-core peak and its ~101 MB 0.030 ms at 3.35 TB/s: the
// work sits at the ridge point, so a good kernel is bound by operations
// on the tensor cores. This first version runs every product on CUDA
// cores in f32 from shared memory (the f32 peak is 67 TFLOP/s, and a
// shared-memory-fed loop reaches a fraction of it), so it runs far above
// that bound. A tensor-core design (mma.sync or wgmma on bf16 tiles,
// K/V fed by TMA through a ring of shared-memory stages) is later work.
//
// Design. The Pallas kernels walk a sequential grid axis and keep state
// in VMEM across it (the forward's online softmax, K5's resident dQ). CUDA
// blocks run in no order, so:
//   - K4 and K6 give one block a (row*head, 64-query tile) and loop over
//     the key tiles at or before the diagonal inside the block;
//   - K5 and K7 give one block a (row*head, 64-key tile) and loop over
//     the query tiles at or after the diagonal; K5's dQ, summed over key
//     tiles that run on different SMs, goes through f32 atomicAdd into a
//     buffer the wrapper zeroes (its summation order changes from run to
//     run; K6 + K7 give a deterministic backward instead).
// Tiles are 64 x 64 with 256 threads; thread (ty, tx) of a 16 x 16 grid
// owns rows ty + 16a and columns tx + 16b of a tile, so a row's 16 owners
// are one half-warp and the softmax reductions are shuffles. Tiles are
// staged in shared memory as f32, rows padded to D + 1 floats so the
// column walks are free of bank conflicts. Any T is taken: rows and
// columns past T are zero on load and masked; only tiles that cross the
// diagonal or the tail compare positions.
//
// Numerics follow the Pallas kernels: scores are scaled in f32 after the
// product; the forward's l sums the UNMASKED p, and dropout touches only
// the p.v sum; p is rounded to v's type before p.v, ds to q's type before
// ds^T q and ds k (the MXU's bf16 inputs); the row term
// Drow = rowsum(dO o) is recomputed in the backward; dK and dQ are scaled
// by sm_scale at the end.
//
// Dropout keep-mask: murmur3's fmix32 over q_pos * hash_seq_len + k_pos
// (uint32), XORed with a per-(batch*head) stream key from the (5,) seed
// words [seed, b_off, h_off, q_off, k_off]; kept where the hash is at or
// above round(rate * 2^32) -- bit for bit the Pallas kernels' mask
// (attention.py _dropout_tile_seed / _dropout_keep).
//
// Layouts (row-major, contiguous): q, k, v, o, dO, dK, dV (B*H, T, D) in
// float or bf16 (all one type); lse (B*H, T) f32; the fused dQ buffer
// (B*H, T, D) f32; seed (5,) int64 words holding uint32 values. Every
// entry point returns cudaGetLastError() after its launch; the Python
// wrapper raises when it is not cudaSuccess.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernels' NEG_INF
constexpr int kTile = 64;          // queries and keys per tile
constexpr int kThreads = 256;      // a 16 x 16 grid of threads
constexpr int kWarps = kThreads / 32;
constexpr int kSP = kTile + 1;     // padded row of a score tile
constexpr uint32_t kGolden = 0x9E3779B9u;

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

// x rounded to T and back: the cast the MXU's inputs get in the Pallas
// kernels (round to nearest even, as XLA's convert).
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Reductions over the 16 threads (one half-warp) that own a tile row.
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
// Dropout keep-mask (attention.py:85-137)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

struct DropoutArgs {
  const long long* seed;  // (5,) words; read only when on
  int on;
  uint32_t threshold;     // keep where fmix32(...) >= threshold
  float scale;            // 1 / (1 - rate), rounded to f32 by the caller
  uint32_t seq_len;       // hash_seq_len
};

struct Dropout {
  bool on;
  uint32_t mix, q_off, k_off, seq_len, threshold;
  float scale;

  // Whether score element (query i, key j) of this (row, head) is kept.
  __device__ __forceinline__ bool keep(int i, int j) const {
    const uint32_t idx =
        (q_off + static_cast<uint32_t>(i)) * seq_len +
        (k_off + static_cast<uint32_t>(j));
    return fmix32(idx ^ mix) >= threshold;
  }
};

// The per-(call, batch*head) stream key of _dropout_tile_seed; the stream
// id is linearised over this call's H heads (the JAX kernels' hash_heads
// when heads are not sharded).
__device__ __forceinline__ Dropout make_dropout(const DropoutArgs& a, int bh,
                                                int H) {
  Dropout d{};
  d.on = a.on != 0;
  if (!d.on) return d;
  const uint32_t s0 = static_cast<uint32_t>(a.seed[0]);
  const uint32_t b =
      static_cast<uint32_t>(bh) / static_cast<uint32_t>(H) +
      static_cast<uint32_t>(a.seed[1]);
  const uint32_t h =
      static_cast<uint32_t>(bh) % static_cast<uint32_t>(H) +
      static_cast<uint32_t>(a.seed[2]);
  d.mix = fmix32(s0 ^ ((b * static_cast<uint32_t>(H) + h) * kGolden));
  d.q_off = static_cast<uint32_t>(a.seed[3]);
  d.k_off = static_cast<uint32_t>(a.seed[4]);
  d.seq_len = a.seq_len;
  d.threshold = a.threshold;
  d.scale = a.scale;
  return d;
}

// ---------------------------------------------------------------------------
// Tile helpers. A "D-tile" is kTile x (D + 1) floats, an "S-tile"
// kTile x kSP floats.
// ---------------------------------------------------------------------------

// Rows [r0, r0 + kTile) of a (n_rows, D) matrix into a D-tile; rows at or
// past n_rows are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int r0,
                                          int n_rows, float* __restrict__ dst) {
  constexpr int kVN = Vec<T>::kN, kNV = D / kVN, kDP = D + 1;
  for (int e = threadIdx.x; e < kTile * kNV; e += kThreads) {
    const int r = e / kNV, d0 = (e % kNV) * kVN;
    float x[kVN];
    if (r0 + r < n_rows) {
      Vec<T>::load(src + static_cast<int64_t>(r0 + r) * D + d0, x);
    } else {
#pragma unroll
      for (int i = 0; i < kVN; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVN; ++i) dst[r * kDP + d0 + i] = x[i];
  }
}

// s[a][b] = A[ty + 16a] . B[tx + 16b] over D, for two D-tiles.
template <int D>
__device__ __forceinline__ void tile_dot(const float* __restrict__ A,
                                         const float* __restrict__ B,
                                         float (&s)[4][4]) {
  constexpr int kDP = D + 1;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) x[a] = A[(ty + 16 * a) * kDP + d];
#pragma unroll
    for (int b = 0; b < 4; ++b) y[b] = B[(tx + 16 * b) * kDP + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = fmaf(x[a], y[b], s[a][b]);
  }
}

// acc[a][c] += sum_j P[ty + 16a][j] * X[j][tx + 16c]: an S-tile times a
// D-tile, rows of P.
template <int D>
__device__ __forceinline__ void tile_pv(const float* __restrict__ P,
                                        const float* __restrict__ X,
                                        float (&acc)[4][D / 16]) {
  constexpr int kDP = D + 1, kDC = D / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    float p[4], x[kDC];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = P[(ty + 16 * a) * kSP + j];
#pragma unroll
    for (int c = 0; c < kDC; ++c) x[c] = X[j * kDP + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[a][c] = fmaf(p[a], x[c], acc[a][c]);
  }
}

// acc[a][c] += sum_i P[i][ty + 16a] * X[i][tx + 16c]: the transposed
// S-tile times a D-tile (dV = P^T dO, dK = dS^T Q), columns of P.
template <int D>
__device__ __forceinline__ void tile_ptx(const float* __restrict__ P,
                                         const float* __restrict__ X,
                                         float (&acc)[4][D / 16]) {
  constexpr int kDP = D + 1, kDC = D / 16;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
  for (int i = 0; i < kTile; ++i) {
    float p[4], x[kDC];
#pragma unroll
    for (int a = 0; a < 4; ++a) p[a] = P[i * kSP + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < kDC; ++c) x[c] = X[i * kDP + tx + 16 * c];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[a][c] = fmaf(p[a], x[c], acc[a][c]);
  }
}

// The backward's per-row stats for query rows [q0, q0 + kTile):
// Drow = rowsum(dO o) in f32 (from the staged dO tile and o in device
// memory) and the forward's lse; zero past T. One warp per row.
template <typename T, int D>
__device__ __forceinline__ void load_row_stats(const float* __restrict__ do_s,
                                               const T* __restrict__ o,
                                               const float* __restrict__ lse,
                                               int q0, int Tn,
                                               float* __restrict__ drow_s,
                                               float* __restrict__ lse_s) {
  constexpr int kDP = D + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < kTile; r += kWarps) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Tn) {
      for (int d = lane; d < D; d += 32)
        acc += do_s[r * kDP + d] * to_f(o[static_cast<int64_t>(row) * D + d]);
    }
    acc = warp_sum(acc);
    if (lane == 0) {
      drow_s[r] = acc;
      lse_s[r] = row < Tn ? lse[row] : 0.f;
    }
  }
}

// The backward's tile math for queries [q0, q0 + kTile) x keys
// [k0, k0 + kTile): p = exp(s - lse) (0 where masked), dp = dO v^T, with
// the dropout mask and rescale on dp and on the p that multiplies dO.
// Writes ds = p (dp - Drow) rounded to T into ds_s and, when p_s is not
// null, the (dropped) p rounded to T into p_s.
template <typename T, int D>
__device__ __forceinline__ void bwd_tile(
    const float* __restrict__ q_s, const float* __restrict__ k_s,
    const float* __restrict__ v_s, const float* __restrict__ do_s,
    const float* __restrict__ lse_s, const float* __restrict__ drow_s,
    int q0, int k0, int Tn, float sm_scale, const Dropout& dr,
    float* __restrict__ p_s, float* __restrict__ ds_s) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float s[4][4], dp[4][4];
  tile_dot<D>(q_s, k_s, s);
  tile_dot<D>(do_s, v_s, dp);
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int il = ty + 16 * a, i = q0 + il;
    const float lse_i = lse_s[il], drow_i = drow_s[il];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int jl = tx + 16 * b, j = k0 + jl;
      const bool valid = i < Tn && j <= i;
      const float p = valid ? expf(s[a][b] * sm_scale - lse_i) : 0.f;
      float pv = p, dpv = dp[a][b];
      if (dr.on) {
        const bool keep = dr.keep(i, j);
        pv = keep ? p * dr.scale : 0.f;
        dpv = keep ? dpv * dr.scale : 0.f;
      }
      if (p_s != nullptr) p_s[il * kSP + jl] = round_to<T>(pv);
      ds_s[il * kSP + jl] = round_to<T>(p * (dpv - drow_i));
    }
  }
}

// ---------------------------------------------------------------------------
// K4: forward. One block per (64-query tile, row*head).
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tn, float sm_scale,
                 DropoutArgs da) {
  constexpr int kDP = D + 1, kDC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kTile * kDP;
  float* v_s = k_s + kTile * kDP;
  float* p_s = v_s + kTile * kDP;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest walks first
  const int bh = blockIdx.y, q0 = qt * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const Dropout dr = make_dropout(da, bh, H);

  load_tile<T, D>(q + base, q0, Tn, q_s);
  float m[4], l[4], acc[4][kDC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = kNegInf;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[a][c] = 0.f;
  }
  // Keys any query of the tile can see: [0, min(q0 + kTile, T)).
  const int n_kt = (min(q0 + kTile, Tn) + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers of k_s, v_s, p_s are done
    load_tile<T, D>(k + base, k0, Tn, k_s);
    load_tile<T, D>(v + base, k0, Tn, v_s);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(q_s, k_s, s);
    // Only a tile that crosses the diagonal or the tail compares positions.
    const bool masked = k0 + kTile - 1 > q0 || k0 + kTile > Tn;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int il = ty + 16 * a, i = q0 + il;
      float mx = kNegInf;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = k0 + tx + 16 * b;
        float x = s[a][b] * sm_scale;
        if (masked && (j > i || j >= Tn)) x = kNegInf;
        s[a][b] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[a], row_max(mx));
      const float alpha = expf(m[a] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int jl = tx + 16 * b;
        const float p = expf(s[a][b] - m_new);
        sum += p;
        // l sums the unmasked p; dropout touches only the p.v sum.
        float pv = p;
        if (dr.on) pv = dr.keep(i, k0 + jl) ? p * dr.scale : 0.f;
        p_s[il * kSP + jl] = round_to<T>(pv);
      }
      l[a] = alpha * l[a] + row_sum(sum);
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();
    tile_pv<D>(p_s, v_s, acc);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i < Tn) {
#pragma unroll
      for (int c = 0; c < kDC; ++c)
        o[base + static_cast<int64_t>(i) * D + tx + 16 * c] =
            from_f<T>(acc[a][c] / l[a]);
      if (tx == 0)
        lse[static_cast<int64_t>(bh) * Tn + i] = m[a] + logf(l[a]);
    }
  }
}

// ---------------------------------------------------------------------------
// K5 (kWithDq) and K7: the key-parallel backward. One block per (64-key
// tile, row*head), looping over the query tiles at or after the diagonal.
// ---------------------------------------------------------------------------

template <typename T, int D, bool kWithDq>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    float* __restrict__ dq_acc, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int Tn, float sm_scale,
                    DropoutArgs da) {
  constexpr int kDP = D + 1, kDC = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTile * kDP;
  float* q_s = v_s + kTile * kDP;
  float* do_s = q_s + kTile * kDP;
  float* p_s = do_s + kTile * kDP;
  float* ds_s = p_s + kTile * kSP;
  float* lse_s = ds_s + kTile * kSP;
  float* drow_s = lse_s + kTile;

  const int kt = gridDim.x - 1 - blockIdx.x;  // key tile 0 walks the most
  const int bh = blockIdx.y, k0 = kt * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const float* lse_bh = lse + static_cast<int64_t>(bh) * Tn;
  const Dropout dr = make_dropout(da, bh, H);

  load_tile<T, D>(k + base, k0, Tn, k_s);
  load_tile<T, D>(v + base, k0, Tn, v_s);
  float dk_acc[4][kDC], dv_acc[4][kDC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kDC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const int n_qt = (Tn + kTile - 1) / kTile;
  for (int qt = kt; qt < n_qt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the last tile's readers are done
    load_tile<T, D>(q + base, q0, Tn, q_s);
    load_tile<T, D>(dout + base, q0, Tn, do_s);
    __syncthreads();
    load_row_stats<T, D>(do_s, o + base, lse_bh, q0, Tn, drow_s, lse_s);
    __syncthreads();
    bwd_tile<T, D>(q_s, k_s, v_s, do_s, lse_s, drow_s, q0, k0, Tn, sm_scale,
                   dr, p_s, ds_s);
    __syncthreads();
    tile_ptx<D>(p_s, do_s, dv_acc);   // dV += P~^T dO
    tile_ptx<D>(ds_s, q_s, dk_acc);   // dK += dS^T Q
    if constexpr (kWithDq) {
      float dq_part[4][kDC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < kDC; ++c) dq_part[a][c] = 0.f;
      tile_pv<D>(ds_s, k_s, dq_part);  // dQ += dS K, summed across blocks
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = q0 + ty + 16 * a;
        if (i < Tn) {
#pragma unroll
          for (int c = 0; c < kDC; ++c)
            atomicAdd(dq_acc + base + static_cast<int64_t>(i) * D + tx + 16 * c,
                      dq_part[a][c]);
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = k0 + ty + 16 * a;
    if (j < Tn) {
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        const int64_t off = base + static_cast<int64_t>(j) * D + tx + 16 * c;
        dk[off] = from_f<T>(dk_acc[a][c] * sm_scale);
        dv[off] = from_f<T>(dv_acc[a][c]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K6: the split backward's dQ pass. One block per (64-query tile,
// row*head), looping over the key tiles at or before the diagonal.
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, int H, int Tn, float sm_scale,
                    DropoutArgs da) {
  constexpr int kDP = D + 1, kDC = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTile * kDP;
  float* k_s = do_s + kTile * kDP;
  float* v_s = k_s + kTile * kDP;
  float* ds_s = v_s + kTile * kDP;
  float* lse_s = ds_s + kTile * kSP;
  float* drow_s = lse_s + kTile;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, q0 = qt * kTile;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int64_t base = static_cast<int64_t>(bh) * Tn * D;
  const Dropout dr = make_dropout(da, bh, H);

  load_tile<T, D>(q + base, q0, Tn, q_s);
  load_tile<T, D>(dout + base, q0, Tn, do_s);
  __syncthreads();
  load_row_stats<T, D>(do_s, o + base, lse + static_cast<int64_t>(bh) * Tn,
                       q0, Tn, drow_s, lse_s);
  float acc[4][kDC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[a][c] = 0.f;
  const int n_kt = (min(q0 + kTile, Tn) + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // row stats written; the last tile's readers done
    load_tile<T, D>(k + base, k0, Tn, k_s);
    load_tile<T, D>(v + base, k0, Tn, v_s);
    __syncthreads();
    bwd_tile<T, D>(q_s, k_s, v_s, do_s, lse_s, drow_s, q0, k0, Tn, sm_scale,
                   dr, nullptr, ds_s);
    __syncthreads();
    tile_pv<D>(ds_s, k_s, acc);  // dQ += dS K
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i < Tn) {
#pragma unroll
      for (int c = 0; c < kDC; ++c)
        dq[base + static_cast<int64_t>(i) * D + tx + 16 * c] =
            from_f<T>(acc[a][c] * sm_scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers, dispatched on (dtype, head_dim).
// ---------------------------------------------------------------------------

enum DType { kF32 = 0, kBF16 = 1 };
enum BwdMode { kFused = 0, kDq = 1, kDkv = 2 };

constexpr size_t d_tile_bytes(int D) {
  return sizeof(float) * kTile * (D + 1);
}
constexpr size_t s_tile_bytes() { return sizeof(float) * kTile * kSP; }

// Above 48 KB, dynamic shared memory has to be allowed per kernel.
template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t stream,
                   Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

struct Call {
  const void *q, *k, *v, *o, *dout;
  const float* lse_in;
  float* lse_out;
  void *dq, *dk, *dv, *out;
  int BH, H, T;
  float sm_scale;
  DropoutArgs dr;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t run_fwd(const Call& c) {
  const dim3 grid((c.T + kTile - 1) / kTile, c.BH);
  return launch(flash_fwd_kernel<T, D>, grid,
                3 * d_tile_bytes(D) + s_tile_bytes(), c.stream,
                static_cast<const T*>(c.q), static_cast<const T*>(c.k),
                static_cast<const T*>(c.v), static_cast<T*>(c.out), c.lse_out,
                c.H, c.T, c.sm_scale, c.dr);
}

template <typename T, int D>
cudaError_t run_bwd(const Call& c, int mode) {
  const dim3 grid((c.T + kTile - 1) / kTile, c.BH);
  const T *q = static_cast<const T*>(c.q), *k = static_cast<const T*>(c.k),
          *v = static_cast<const T*>(c.v), *o = static_cast<const T*>(c.o),
          *dout = static_cast<const T*>(c.dout);
  const size_t stats = 2 * kTile * sizeof(float);
  switch (mode) {
    case kFused:
      return launch(flash_bwd_kv_kernel<T, D, true>, grid,
                    4 * d_tile_bytes(D) + 2 * s_tile_bytes() + stats, c.stream,
                    q, k, v, o, dout, c.lse_in, static_cast<float*>(c.dq),
                    static_cast<T*>(c.dk), static_cast<T*>(c.dv), c.H, c.T,
                    c.sm_scale, c.dr);
    case kDkv:
      return launch(flash_bwd_kv_kernel<T, D, false>, grid,
                    4 * d_tile_bytes(D) + 2 * s_tile_bytes() + stats, c.stream,
                    q, k, v, o, dout, c.lse_in, static_cast<float*>(nullptr),
                    static_cast<T*>(c.dk), static_cast<T*>(c.dv), c.H, c.T,
                    c.sm_scale, c.dr);
    case kDq:
      return launch(flash_bwd_dq_kernel<T, D>, grid,
                    4 * d_tile_bytes(D) + s_tile_bytes() + stats, c.stream, q,
                    k, v, o, dout, c.lse_in, static_cast<T*>(c.dq), c.H, c.T,
                    c.sm_scale, c.dr);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_head_dim(int D, const Call& c, int mode) {
  switch (D) {
    case 32: return mode < 0 ? run_fwd<T, 32>(c) : run_bwd<T, 32>(c, mode);
    case 64: return mode < 0 ? run_fwd<T, 64>(c) : run_bwd<T, 64>(c, mode);
    case 128: return mode < 0 ? run_fwd<T, 128>(c) : run_bwd<T, 128>(c, mode);
    default: return cudaErrorInvalidValue;
  }
}

// mode < 0: the forward; else a BwdMode.
cudaError_t dispatch(int dtype, int D, const Call& c, int mode) {
  if (dtype == kF32) return by_head_dim<float>(D, c, mode);
  if (dtype == kBF16) return by_head_dim<__nv_bfloat16>(D, c, mode);
  return cudaErrorInvalidValue;
}

DropoutArgs dropout_args(const long long* seed, int on, unsigned threshold,
                         float keep_scale, unsigned hash_seq_len) {
  return DropoutArgs{seed, on, threshold, keep_scale, hash_seq_len};
}

}  // namespace

extern "C" {

// K4. Returns a cudaError_t: cudaSuccess (0) once the kernel is queued.
int nsb_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  float* lse, const long long* seed, int BH, int H, int T,
                  int D, float sm_scale, int dtype, int dropout_on,
                  unsigned threshold, float keep_scale, unsigned hash_seq_len,
                  void* stream) {
  Call c{};
  c.q = q; c.k = k; c.v = v; c.out = o; c.lse_out = lse;
  c.BH = BH; c.H = H; c.T = T; c.sm_scale = sm_scale;
  c.dr = dropout_args(seed, dropout_on, threshold, keep_scale, hash_seq_len);
  c.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, c, -1));
}

// K5 (mode 0: dq is the zeroed f32 accumulator), K6 (mode 1: dq only, in
// the input type; dk, dv unused) or K7 (mode 2: dk, dv; dq unused).
int nsb_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, const long long* seed,
                  void* dq, void* dk, void* dv, int BH, int H, int T, int D,
                  float sm_scale, int dtype, int dropout_on,
                  unsigned threshold, float keep_scale, unsigned hash_seq_len,
                  int mode, void* stream) {
  if (mode < 0) return static_cast<int>(cudaErrorInvalidValue);
  Call c{};
  c.q = q; c.k = k; c.v = v; c.o = o; c.dout = dout; c.lse_in = lse;
  c.dq = dq; c.dk = dk; c.dv = dv;
  c.BH = BH; c.H = H; c.T = T; c.sm_scale = sm_scale;
  c.dr = dropout_args(seed, dropout_on, threshold, keep_scale, hash_seq_len);
  c.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, D, c, mode));
}

}  // extern "C"
