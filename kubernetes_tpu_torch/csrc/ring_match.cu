// K16 ktt_ring_match: one hop of the ring matcher -- selector terms x a
// block of label rows.
//
// Replaces the JAX package's parallel/ring.py:35 _eval_block, the body of
// every hop of ring_match (:47): for a shard's resident selector rows
// sel[S_l, E, L] with their expression kinds kind[S_l, E] and the label
// block lab[B, L] the shard holds in this hop, out[s, b] = AND over e of
//   PAD (kind 0): true, ANY (1): count > 0, NONE (2): count == 0, else false,
// count = the number of labels l with sel[s, e, l] and lab[b, l] set (!= 0).
// The inputs are f32 0/1 masks, as in JAX; JAX takes the count as an f32
// einsum at Precision.HIGHEST, exact below 2^24 labels; here it is the same
// test on packed words.  The tile is written at column `col0` of an output
// of row stride `ld` (the block's origin in the shard's [S_l, P] match
// rows), so a hop writes no temporary.
//
// One launch, feasible.cuh match_tiles (no thread walks a row): a block
// packs the S_l x E masks into words in shared memory once, in the same
// pass of 16-byte loads as its first tile (when they fit; else a warp
// ballots each mask word as it needs it), per tile of 32 label rows
// (contiguous f32 rows) packs the rows into words, and each warp takes
// terms s = warp, warp + warps, ... (a block has a warp a term, up to 8:
// at one term, one warp a block): lane r holds row r, its answer is the
// word test, stored at out[s, col0 + b] along b (a warp's 32 bytes
// contiguous).  A row's words past the 227 KB a block holds take the tile
// a few rows at a time.  Bound: the bytes, (S_l * E + B) * L * 4 in and
// S_l * B out, at every shape the port runs; at those shapes a hop is a
// launch and one round trip of loads.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "feasible.cuh"

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) ring_match_kernel(const float* __restrict__ sel,  // [Sl, E, L]
                                                        const int32_t* __restrict__ kind,  // [Sl, E]
                                                        const float* __restrict__ lab,     // [B, L]
                                                        int Sl, int E, int L, int B, int64_t ld, int64_t col0,
                                                        MatchPlan plan, uint8_t* __restrict__ out) {  // [Sl, ld]
  extern __shared__ uint32_t match_sm[];
  const int lane = threadIdx.x & 31;
  match_tiles<float>(lab, B, sel, kind, Sl, E, L, plan, match_sm, blockIdx.x, gridDim.x,
                     [&](int s, int tile, int r0, int rows, bool ok) {
                       if (lane < rows) out[(int64_t)s * ld + col0 + 32 * tile + r0 + lane] = ok ? 1 : 0;
                     });
}

}  // namespace

extern "C" int ktt_ring_match(const void* sel, const void* kind, const void* lab, void* out, int Sl, int E,
                              int L, int B, long long ld, long long col0, void* stream) {
  static ktt::Occupancy occ;
  static size_t allowed[ktt::MAX_DEVICES] = {};
  if (Sl <= 0 || B <= 0) return (int)cudaGetLastError();
  const MatchPlan plan = match_plan(Sl, E, L);
  if (plan.smem == 0) return (int)cudaErrorInvalidValue;  // one label row's words exceed shared memory
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err = ktt::device_sms(&dev, &nsm);
  if (err != cudaSuccess) return (int)err;
  const int nt = Sl < NT / 32 ? 32 * Sl : NT;  // a warp a term, up to NT / 32 warps
  err = allow_smem(ring_match_kernel, dev, plan.smem, allowed);
  if (err == cudaSuccess) err = ktt::blocks_per_sm(occ, ring_match_kernel, dev, nt, plan.smem, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = (B + 31) / 32, cap = (int64_t)nsm * per_sm;
  ring_match_kernel<<<(unsigned)(tiles < cap ? tiles : cap), nt, plan.smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sel), static_cast<const int32_t*>(kind), static_cast<const float*>(lab), Sl, E, L, B,
      ld, col0, plan, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
