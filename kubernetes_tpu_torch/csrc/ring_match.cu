// K16 ktt_ring_match: one hop of the ring matcher -- selector terms x a
// block of label rows.
//
// Replaces the JAX package's parallel/ring.py:35 _eval_block, the body of
// every hop of ring_match (:47): for a shard's resident selector rows
// sel[S_l, E, L] with their expression kinds kind[S_l, E] and the label
// block lab[B, L] the shard holds in this hop, out[s, b] = AND over e of
//   PAD (kind 0): true, ANY (1): count > 0, NONE (2): count == 0, else false,
// count = the number of labels l with sel[s, e, l] and lab[b, l] set.  The
// inputs are f32 0/1 masks, as in JAX; JAX takes the count as an f32
// einsum at Precision.HIGHEST, exact below 2^24 labels, and this kernel
// counts in integers, which is the same number.  The tile is written at
// column `col0` of an output of row stride `ld` (the block's origin in the
// shard's [S_l, P] match rows), so a hop writes no temporary.
//
// One thread per (term, label row): the term's E x L mask sits in shared
// memory when it fits (48 KB), else it is read from global memory; the
// label row streams from global memory (L1) once per expression.  A simple
// kernel: 2 * S_l * E * L * B operations, the bound at 67 TFLOP/s f32 (the
// bytes, (S_l * E + B) * L * 4, are fewer at every shape the port runs).
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int SHARED_FLOATS = 12 * 1024;  // 48 KB of the term's mask
constexpr int MAX_GRID_Y = 65535;

__global__ void __launch_bounds__(NT) ring_match_kernel(const float* __restrict__ sel,  // [Sl, E, L]
                                                        const int32_t* __restrict__ kind,  // [Sl, E]
                                                        const float* __restrict__ lab,     // [B, L]
                                                        int Sl, int E, int L, int B, int64_t ld, int64_t col0,
                                                        uint8_t* __restrict__ out) {  // [Sl, ld]
  __shared__ float sh[SHARED_FLOATS];
  const bool in_shared = (int64_t)E * L <= SHARED_FLOATS;
  const int b = blockIdx.x * NT + threadIdx.x;
  for (int s = blockIdx.y; s < Sl; s += gridDim.y) {
    const float* ts = sel + (int64_t)s * E * L;
    if (in_shared) {
      __syncthreads();
      for (int i = threadIdx.x; i < E * L; i += NT) sh[i] = ts[i];
      __syncthreads();
      ts = sh;
    }
    if (b >= B) continue;
    const float* row = lab + (int64_t)b * L;
    bool ok = true;
    for (int e = 0; e < E && ok; ++e) {
      const int k = kind[(int64_t)s * E + e];
      if (k == 0) continue;  // PAD: always satisfied
      int count = 0;
      const float* te = ts + (int64_t)e * L;
      for (int l = 0; l < L; ++l) count += (te[l] != 0.0f) & (row[l] != 0.0f);
      ok = k == 1 ? count > 0 : (k == 2 ? count == 0 : false);
    }
    out[(int64_t)s * ld + col0 + b] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int ktt_ring_match(const void* sel, const void* kind, const void* lab, void* out, int Sl, int E,
                              int L, int B, long long ld, long long col0, void* stream) {
  if (Sl <= 0 || B <= 0) return (int)cudaGetLastError();
  dim3 grid((B + NT - 1) / NT, Sl < MAX_GRID_Y ? Sl : MAX_GRID_Y);
  ring_match_kernel<<<grid, NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sel), static_cast<const int32_t*>(kind), static_cast<const float*>(lab), Sl, E,
      L, B, ld, col0, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
