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
// Its walk is decode_common.cuh's decode_row over contiguous rows: one
// block a (row, head), warps take 64-position chunks of the row in turn,
// kLPR lanes share one K/V row with ~8 dims each, and the online-softmax
// states merge by shuffles and then through shared memory. Bound by bytes: each visited position
// is read once (K, V and, quantized, two f32 scales) for 4*D flops.
// Positions at or past the row's frontier are never read, so a slot
// row's stale tail (an earlier occupant's K/V) costs nothing. A row with
// lengths <= 0 returns 0, as the paged kernel does.
//
// Layouts (row-major, contiguous): q (B, H, D); k, v (B, H, L, D), or
// (B, H, L, D/2) bytes for packed int4; k_scale, v_scale (B, H, L) f32
// for int8/int4 (unused otherwise); lengths (B,) int32; out like q.
//
// The entry point returns cudaGetLastError() after its launch; the
// Python wrapper raises when it is not cudaSuccess.

#include "decode_common.cuh"

namespace nsb {
namespace {

template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_kernel(const TQ* __restrict__ q,
                    const typename KV<TKV>::S* __restrict__ k,
                    const typename KV<TKV>::S* __restrict__ v,
                    const float* __restrict__ ks,
                    const float* __restrict__ vs,
                    const int* __restrict__ lengths, TQ* __restrict__ out,
                    int H, int L, float sm_scale) {
  const int h = blockIdx.x, b = blockIdx.y;
  decode_row<TQ, TKV, D>(q, k, v, ks, vs, DenseRows{L, H}, lengths[b], out,
                         b, h, H, sm_scale);
}

struct LaunchFlashDecode {
  template <typename TQ, typename TKV, int D>
  static void run(const void* q, const void* k, const void* v,
                  const float* ks, const float* vs, const int* lengths,
                  void* out, int B, int H, int L, float sm_scale,
                  cudaStream_t stream) {
    using S = typename KV<TKV>::S;
    flash_decode_kernel<TQ, TKV, D><<<dim3(H, B), kDecThreads, 0, stream>>>(
        static_cast<const TQ*>(q), static_cast<const S*>(k),
        static_cast<const S*>(v), ks, vs, lengths, static_cast<TQ*>(out), H,
        L, sm_scale);
  }
};

}  // namespace
}  // namespace nsb

extern "C" {

// Returns a cudaError_t: cudaSuccess (0) once the kernel is queued. D is
// the logical head_dim (twice the stored bytes of a packed int4 row).
int nsb_flash_decode(const void* q, const void* k, const void* v,
                     const float* k_scale, const float* v_scale,
                     const int* lengths, void* out, int B, int H, int D,
                     int L, float sm_scale, int q_dtype, int kv_dtype,
                     void* stream) {
  if (!nsb::dispatch<nsb::LaunchFlashDecode>(
          q_dtype, kv_dtype, D, q, k, v, k_scale, v_scale, lengths, out, B,
          H, L, sm_scale, static_cast<cudaStream_t>(stream)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
