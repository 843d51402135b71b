// Capacity-independent filter pieces shared by static_feasible.cu and
// class_hoist.cu: the interned selector terms matched against node labels
// (terms.cuh term_ok over [S, N]) and bool rows packed into 32-bit words
// (taints, tolerations), so the taint filter (ops/filters.py:62
// taints_ok) is an AND-NOT per word.  Each
// kernel takes a `done` word (or NULL) and returns at entry once it is set:
// the gang fixpoint's queued iterations (ops/gang.py) stop that way.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "terms.cuh"

namespace {

__global__ void term_match_kernel(const uint8_t* __restrict__ sel_mask,  // [S, E, L]
                                  const int32_t* __restrict__ sel_kind,  // [S, E]
                                  const uint8_t* __restrict__ node_labels,  // [N, L]
                                  int S, int E, int L, int N,
                                  uint8_t* __restrict__ tm,  // [S, N]
                                  const int32_t* __restrict__ done) {
  if (done != nullptr && *done) return;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)S * N) return;
  tm[i] = term_ok(sel_mask, sel_kind, node_labels, (int)(i / N), (int)(i % N), E, L) ? 1 : 0;
}

__global__ void pack_bits_kernel(const uint8_t* __restrict__ in,  // [rows, T]
                                 int64_t rows, int T, int TW,
                                 uint32_t* __restrict__ out,  // [rows, TW]
                                 const int32_t* __restrict__ done) {
  if (done != nullptr && *done) return;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * TW) return;
  const int64_t r = i / TW;
  const int w = (int)(i % TW);
  const uint8_t* src = in + r * T + 32 * w;
  const int lim = min(32, T - 32 * w);
  uint32_t bits = 0;
  for (int b = 0; b < lim; ++b) bits |= (uint32_t)(src[b] != 0) << b;
  out[i] = bits;
}

unsigned blocks_for(int64_t work, int threads) { return (unsigned)((work + threads - 1) / threads); }

}  // namespace
