// K10 score_planes: the two [P, N] raw score planes of the per-pod
// normalisation stages, stored as bf16 (round to nearest even).
//
//   traw[p, n]  = # PreferNoSchedule taints on node n that pod p does not
//                 tolerate: the JAX package's ops/scores.py:229
//                 taint_prefer_counts, a [P, T] x [N, T] counting product
//                 in f32, here popcounts of 32-bit words;
//   naraw[p, n] = summed weights of pod p's preferred node-affinity terms
//                 that node n matches: ops/assign.py:153
//                 _preferred_node_affinity_raw, a [P, S] weight scatter-add
//                 (a term listed twice adds twice; -1 slots add nothing)
//                 times the [S, N] term match, here a loop over the pod's
//                 few slots.
// Both are integer-valued f32 sums (exact below 2^24 in any order), so the
// direct loops give the products' values; __float2bfloat16_rn rounds as
// torch's .to(torch.bfloat16) and XLA's convert do.
//
// Three small kernels (feasible.cuh term_match_kernel and pack_bits_kernel,
// then one thread per (pod, node) writing both planes).  Bound on an H100:
// the output, 4 bytes per (pod, node) (at P = 512, N = 256: 0.5 MB,
// >= 0.16 us at 3.35 TB/s); the inputs are KBs.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "feasible.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) score_planes_kernel(
    const uint32_t* __restrict__ taint_w,   // [N, TW] PreferNoSchedule taints
    const uint32_t* __restrict__ tol_w,     // [P, TW] tolerated taints
    const int32_t* __restrict__ pref_terms,  // [P, PW]
    const float* __restrict__ pref_weights,  // [P, PW]
    const uint8_t* __restrict__ tm,          // [S, N]
    int P, int N, int TW, int PW,
    __nv_bfloat16* __restrict__ traw,   // [P, N]
    __nv_bfloat16* __restrict__ naraw) {  // [P, N]
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    int count = 0;
    for (int w = 0; w < TW; ++w) count += __popc(taint_w[(int64_t)n * TW + w] & ~tol_w[(int64_t)p * TW + w]);
    float na = 0.0f;
    for (int k = 0; k < PW; ++k) {
      const int s = pref_terms[(int64_t)p * PW + k];
      if (s >= 0 && tm[(int64_t)s * N + n]) na += pref_weights[(int64_t)p * PW + k];
    }
    traw[(int64_t)p * N + n] = __float2bfloat16_rn((float)count);
    naraw[(int64_t)p * N + n] = __float2bfloat16_rn(na);
  }
}

}  // namespace

extern "C" int ktt_score_planes(const void* node_taint_pref, const void* pod_tol_pref, const void* pref_terms,
                                const void* pref_weights, const void* sel_mask, const void* sel_kind,
                                const void* node_labels, void* tm, void* taint_w, void* tol_w, void* traw,
                                void* naraw, int P, int N, int T, int PW, int S, int E, int L, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (P <= 0 || N <= 0) return (int)cudaGetLastError();
  const int TW = T > 32 ? (T + 31) / 32 : 1;
  term_match_kernel<<<blocks_for((int64_t)S * N, THREADS), THREADS, 0, st>>>(
      static_cast<const uint8_t*>(sel_mask), static_cast<const int32_t*>(sel_kind),
      static_cast<const uint8_t*>(node_labels), S, E, L, N, static_cast<uint8_t*>(tm), nullptr);
  pack_bits_kernel<<<blocks_for((int64_t)N * TW, THREADS), THREADS, 0, st>>>(
      static_cast<const uint8_t*>(node_taint_pref), N, T, TW, static_cast<uint32_t*>(taint_w), nullptr);
  pack_bits_kernel<<<blocks_for((int64_t)P * TW, THREADS), THREADS, 0, st>>>(
      static_cast<const uint8_t*>(pod_tol_pref), P, T, TW, static_cast<uint32_t*>(tol_w), nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_for(N, THREADS), P < 65535 ? P : 65535);
  score_planes_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const uint32_t*>(taint_w), static_cast<const uint32_t*>(tol_w),
      static_cast<const int32_t*>(pref_terms), static_cast<const float*>(pref_weights),
      static_cast<const uint8_t*>(tm), P, N, TW, PW, static_cast<__nv_bfloat16*>(traw),
      static_cast<__nv_bfloat16*>(naraw));
  return (int)cudaGetLastError();
}
