// Single-query flash decode over contiguous slot rows, for Hopper
// (sm_90a).
//
//   flash_decode_kernel <- _flash_decode_kernel (nanosandbox_tpu/ops/
//       flash_decode.py flash_decode): one query per (row, head) over the
//       row's positions [0, min(lengths[b], L)) of a (B, H, L, D) pool,
//       in every kv mode (fp32, bf16, int8 and packed int4 with
//       per-position f32 scales folded into the scores and
//       probabilities). The dense engine's decode step (--paged=off) and
//       the offline sampler's decode steps run it.
//
// Bound by bytes: each visited position is read once (K, V and,
// quantized, two f32 scales) for 4*D flops. At the shapes the port runs
// (a few rows of up to 1024 positions) the bytes take a few microseconds
// at the card's rate, so what sets the time is latency and the rate of
// one SM: the longest row's walk, a first DRAM round for the length, and
// the merge of a split row (a fence, a ticket atomic and the states'
// reads). One SM's copies stream a row at 17-62 GB/s on an H100 (PERF.md
// section 6, scripts/k3_probe.py), so a long row goes faster over several
// SMs. The design:
//
// 1. A grid (H, B, S) of split slots, S from the host
//    (ops/flash_decode.py dense_decode_splits: from B, H, L and the SM
//    count, never from the lengths). A row of len positions uses only
//    n = min(S, ceil(len / P)) slots, P (SplitAt) the positions one block
//    walks before a split pays for its merge (measured per pool mode,
//    PERF.md section 6); its positions go over those n blocks in whole
//    64-position chunks. Slots past them return before any K/V load, and
//    a row that uses one block writes its output directly: no scratch,
//    fence or ticket.
// 2. A split's K (and V) is one contiguous byte range of the pool. A
//    producer warp brings it, stage by stage, into a ring of kStages
//    shared-memory stages by bulk copies (cp.async.bulk, one "full"
//    mbarrier a stage armed with the stage's bytes). Only
//    [lo, min(hi, len)) is copied. The scales of a quantized pool come by
//    4-byte cp.async copies of the producer's lanes into the same stage
//    (their start is 16-byte aligned only when L is a multiple of 4),
//    arriving on the same mbarrier. The ring's 128 KB leave one block an
//    SM: at two an SM, two working blocks of a launch could share an SM
//    (and its rate) while other SMs held only slots that return at once.
// 3. Eight consumer warps widen a stage's rows from shared memory as K2's
//    lanes do (decode_common.cuh Lane16, 16 bytes a lane in every mode),
//    kGroups row groups a warp a stage with one max and one rescale, and
//    release the stage on its "empty" mbarrier; they end through
//    decode_common.cuh's finish_split, whose split-order merge gives equal
//    bits on every call.
//
// The scores are s = (q.k) * k_scale * sm_scale in f32, JAX's order; l
// sums the unscaled p; p * v_scale is rounded to bf16 where kRoundP says.
// Positions at or past the row's frontier are never read, so a slot row's
// stale tail (an earlier occupant's K/V) costs nothing. A row with
// lengths <= 0 returns 0, as the paged kernel does.
//
// Layouts (row-major, contiguous): q (B, H, D); k, v (B, H, L, D), or
// (B, H, L, D/2) bytes for packed int4; k_scale, v_scale (B, H, L) f32
// for int8/int4 (unused otherwise); lengths (B,) int32; out like q; part
// a (B*H, S, D + 2) f32 scratch when S > 1; tickets (B*H,) int32, zero,
// left zero (shared with the paged decode).
//
// The entry point returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not cudaSuccess.

#include "decode_common.cuh"
#include "mma_common.cuh"

namespace nsb {
namespace {

// Stages of the ring, and the row groups a consumer warp takes from each:
// a stage holds 8 warps x kGroups x kRPW positions, 8 kGroups x 512 bytes
// of K and as many of V in every mode and head_dim.
constexpr int kStages = 4;
constexpr int kGroups = 4;
constexpr int kK3Threads = kDecThreads + 32;  // + the producer warp
// A split holds whole chunks of this many positions (ops/flash_decode.py
// DENSE_CHUNK).
constexpr int kChunk = 64;

// P: the positions one block walks before a row splits over two.
template <typename TKV>
struct SplitAt;
#ifdef NSB_K3_SPLIT
// scripts/k3_times.py's sweep sets one P for every mode.
template <typename TKV>
struct SplitAt {
  static constexpr int kPos = NSB_K3_SPLIT;
};
#else
template <>
struct SplitAt<float> {
  static constexpr int kPos = 512;
};
template <>
struct SplitAt<__nv_bfloat16> {
  static constexpr int kPos = 512;
};
template <>
struct SplitAt<int8_t> {
  static constexpr int kPos = 1024;
};
template <>
struct SplitAt<Int4> {
  static constexpr int kPos = 1024;
};
#endif

// The ring's geometry for a pool mode and head_dim.
template <typename TKV, int D>
struct Ring {
  using L = KV<TKV>;
  static constexpr int kN = Lane16<TKV>::kN;  // dims a lane load
  static constexpr int kLPR = D / kN;         // lanes a row
  static constexpr int kRPW = 32 / kLPR;      // rows a warp load
  static constexpr int kRowBytes =
      D * static_cast<int>(sizeof(typename L::S)) / L::kDiv;
  static constexpr int kSP = kDecWarps * kGroups * kRPW;  // positions
  static constexpr int kKV = kSP * kRowBytes;  // K (or V) bytes a stage
  // K, V, then the k and v scales of a quantized pool.
  static constexpr int kStage = 2 * kKV + (L::kQuant ? 8 * kSP : 0);
  static constexpr int kSmem = kStages * kStage;
  static_assert(kLPR >= 1 && kLPR <= 32 && 32 % kLPR == 0,
                "head_dim vs the 16-byte lane load");
  static_assert(kKV % 16 == 0, "a stage's bulk copies are 16-byte units");
};

// One block an SM (its ring's shared memory), which leaves ptxas the
// registers of the int4 instances (capped at 96 without the 1, they
// spilled).
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kK3Threads, 1)
flash_decode_kernel(const TQ* __restrict__ q,
                    const typename KV<TKV>::S* __restrict__ k,
                    const typename KV<TKV>::S* __restrict__ v,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int H, int L, float sm_scale) {
  using R = Ring<TKV, D>;
  using W = Lane16<TKV>;
  constexpr bool kQuant = KV<TKV>::kQuant;
  // JAX's dot dtype is q's for a quantized pool and the wider of (q, pool)
  // otherwise (flash_decode.py _flash_decode_kernel): bf16 exactly when a
  // bf16 query meets a pool that is not fp32.
  constexpr bool kRoundP = std::is_same<TQ, __nv_bfloat16>::value &&
                           !std::is_same<TKV, float>::value;
  constexpr int kN = R::kN, kLPR = R::kLPR, kRPW = R::kRPW;
  constexpr int P = SplitAt<TKV>::kPos;
  extern __shared__ __align__(128) unsigned char ring[];
  // Stage i's K, V (and scales) landed (full) and were read (empty).
  __shared__ __align__(8) uint64_t bars[2 * kStages];
  const uint32_t full0 = smem_addr(&bars[0]),
                 empty0 = smem_addr(&bars[kStages]);
  const int h = blockIdx.x, b = blockIdx.y, s = blockIdx.z, S = gridDim.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t row = (int64_t)b * H + h;

  if (t == 0) {
    for (int i = 0; i < kStages; ++i) {
      // The producer lane's arrival with the bytes, and with the scales
      // every producer lane's cp.async arrival.
      mbar_init(full0 + 8 * i, kQuant ? 33 : 1);
      mbar_init(empty0 + 8 * i, kDecWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();  // the barriers are ready; no thread waits for another
                    // from here to the consumers' finish

  const int len = max(min(lengths[b], L), 0);
  // The row's split: n of the S slots, each a whole number of chunks.
  const int n = min(S, (len + P - 1) / P);
  const int width =
      kChunk * max(1, ((len + kChunk - 1) / kChunk + n - 1) / max(n, 1));
  const int n_act = (len + width - 1) / width;  // splits with keys
  if (s > 0 && s >= n_act) return;  // past the frontier: no K/V load
  const int lo = s * width, hi = min(lo + width, len);
  const int n_st = (hi - lo + R::kSP - 1) / R::kSP;
  const int64_t first = row * L + lo;  // the pool row of position lo

  if (warp == kDecWarps) {
    // The producer warp: lane 0 copies each stage's K and V rows, every
    // lane a share of its scales, once the consumers have released it.
    const unsigned char* kg = reinterpret_cast<const unsigned char*>(k) +
                              first * R::kRowBytes;
    const unsigned char* vg = reinterpret_cast<const unsigned char*>(v) +
                              first * R::kRowBytes;
    for (int st = 0; st < n_st; ++st) {
      const int i = st % kStages, p0 = st * R::kSP;
      const int nv = min(R::kSP, hi - lo - p0);
      if (st >= kStages) mbar_wait(empty0 + 8 * i, (st / kStages - 1) & 1);
      const uint32_t dst = smem_addr(ring) + i * R::kStage,
                     bar = full0 + 8 * i, bytes = nv * R::kRowBytes;
      if (lane == 0) {
        mbar_expect_tx(bar, 2 * bytes);
        bulk_copy(dst, kg + (int64_t)p0 * R::kRowBytes, bytes, bar);
        bulk_copy(dst + R::kKV, vg + (int64_t)p0 * R::kRowBytes, bytes, bar);
      }
      if constexpr (kQuant) {
        for (int j = lane; j < nv; j += 32) {
          cp_async4(dst + 2 * R::kKV + 4 * j, ks + first + p0 + j, 4);
          cp_async4(dst + 2 * R::kKV + 4 * (R::kSP + j), vs + first + p0 + j,
                    4);
        }
        cp_async_arrive(bar);
      }
    }
    if constexpr (kQuant) cp_async_wait<0>();  // no copy outlives its lane
    return;
  }

  // A consumer warp: positions (warp kGroups + u) kRPW + sub of each
  // stage, u < kGroups. Its query dims load while the first stage lands.
  const int sub = lane / kLPR, piece = lane % kLPR, d0 = piece * kN;
  float qv[kN], acc[kN];
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    qv[j] = to_f(q[row * D + d0 + j]);
    acc[j] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  for (int st = 0; st < n_st; ++st) {
    const int i = st % kStages;
    const int nv = min(R::kSP, hi - lo - st * R::kSP);
    const unsigned char* kst = ring + i * R::kStage;
    const unsigned char* vst = kst + R::kKV;
    const float* kss = reinterpret_cast<const float*>(kst + 2 * R::kKV);
    mbar_wait(full0 + 8 * i, (st / kStages) & 1);
    // Scores of the kGroups rows, one max over them. A row past nv holds
    // an older stage's bytes (or none): its score is masked, its V unread.
    float sc[kGroups];
    float mx = m;
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int p = (warp * kGroups + u) * kRPW + sub;
      float kx[kN];
      W::widen(*reinterpret_cast<const uint4*>(kst + p * R::kRowBytes +
                                                16 * piece),
               kx);
      float d = 0.f;
#pragma unroll
      for (int j = 0; j < kN; ++j) d = fmaf(qv[j], kx[j], d);
#pragma unroll
      for (int o = kLPR / 2; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if constexpr (kQuant) d *= kss[p];
      d *= sm_scale;
      sc[u] = p < nv ? d : kNegInf;
      mx = fmaxf(mx, sc[u]);
    }
    const float alpha = expf(m - mx);
    float psum = 0.f, pv[kGroups];
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int p = (warp * kGroups + u) * kRPW + sub;
      const float e = p < nv ? expf(sc[u] - mx) : 0.f;
      psum += e;  // l sums the unscaled p; the v scale folds in here
      pv[u] = e;
      if constexpr (kQuant) pv[u] = p < nv ? e * kss[R::kSP + p] : 0.f;
      if constexpr (kRoundP) pv[u] = __bfloat162float(__float2bfloat16(pv[u]));
    }
    l = l * alpha + psum;
#pragma unroll
    for (int j = 0; j < kN; ++j) acc[j] *= alpha;
#pragma unroll
    for (int u = 0; u < kGroups; ++u) {
      const int p = (warp * kGroups + u) * kRPW + sub;
      if (p < nv) {
        float vx[kN];
        W::widen(*reinterpret_cast<const uint4*>(vst + p * R::kRowBytes +
                                                  16 * piece),
                 vx);
#pragma unroll
        for (int j = 0; j < kN; ++j) acc[j] = fmaf(pv[u], vx[j], acc[j]);
      }
    }
    m = mx;
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * i);
  }
  finish_split<TQ, D, kN>(m, l, acc, n_act, out, part, tickets, row, s, S);
}

struct LaunchFlashDecode {
  template <typename TQ, typename TKV, int D>
  static void run(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* lengths,
                  void* out, float* part, int* tickets, int B, int H, int L,
                  int S, float sm_scale, cudaStream_t stream) {
    using S_ = typename KV<TKV>::S;
    constexpr int smem = Ring<TKV, D>::kSmem;
    // A refusal here makes the launch fail, which the entry point returns.
    cudaFuncSetAttribute(flash_decode_kernel<TQ, TKV, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    flash_decode_kernel<TQ, TKV, D><<<dim3(H, B, S), kK3Threads, smem,
                                      stream>>>(
        static_cast<const TQ*>(q), static_cast<const S_*>(k),
        static_cast<const S_*>(v), ks, vs, lengths, static_cast<TQ*>(out),
        part, tickets, H, L, sm_scale);
  }
};

// The launch shape of an instance: out[6] = {threads, dynamic shared
// memory bytes, static shared memory bytes, registers a thread, blocks an
// SM, P (the positions a block walks before a row splits)}.
struct ShapeFlashDecode {
  template <typename TQ, typename TKV, int D>
  static void run(int* out, cudaError_t* err) {
    const auto fn = flash_decode_kernel<TQ, TKV, D>;
    constexpr int smem = Ring<TKV, D>::kSmem;
    cudaFuncAttributes attr;
    *err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (*err == cudaSuccess) *err = cudaFuncGetAttributes(&attr, fn);
    if (*err != cudaSuccess) return;
    out[0] = kK3Threads;
    out[1] = smem;
    out[2] = static_cast<int>(attr.sharedSizeBytes);
    out[3] = attr.numRegs;
    out[5] = SplitAt<TKV>::kPos;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[4], fn,
                                                         kK3Threads, smem);
  }
};

}  // namespace
}  // namespace nsb

extern "C" {

// Returns a cudaError_t: cudaSuccess (0) once the kernel is queued. D is
// the logical head_dim (twice the stored bytes of a packed int4 row). S
// split slots a (row, head) (ops/flash_decode.py dense_decode_splits); part
// a (B*H, S, D + 2) f32 scratch when S > 1; tickets (B*H,) int32, zero,
// left zero.
int nsb_flash_decode(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int* lengths, void* out, float* part,
                     int* tickets, int B, int H, int D, int L, int S,
                     float sm_scale, int q_dtype, int kv_dtype,
                     void* stream) {
  if (S < 1 || tickets == nullptr || (S > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!nsb::dispatch<nsb::LaunchFlashDecode>(
          q_dtype, kv_dtype, D, q, k, v, k_scale, v_scale, lengths, out,
          part, tickets, B, H, L, S, sm_scale,
          static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The launch shape of the (q dtype, kv dtype, D) instance into out[6]
// (ShapeFlashDecode). Returns a cudaError_t.
int nsb_flash_decode_shape(int q_dtype, int kv_dtype, int D, int* out) {
  cudaError_t err = cudaErrorInvalidValue;
  nsb::dispatch<nsb::ShapeFlashDecode>(q_dtype, kv_dtype, D, out, &err);
  return static_cast<int>(err);
}

}  // extern "C"
