// Capacity-independent filter pieces shared by static_feasible.cu and
// class_hoist.cu: the interned selector terms matched against node labels
// (the JAX package's ops/filters.py:28 term_match, as integer literal counts)
// and bool rows packed into 32-bit words (taints, tolerations), so the
// taint filter (ops/filters.py:62 taints_ok) is an AND-NOT per word.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_PAD = 0;
constexpr int KIND_ANY = 1;
constexpr int KIND_NONE = 2;

__global__ void term_match_kernel(const uint8_t* __restrict__ sel_mask,  // [S, E, L]
                                  const int32_t* __restrict__ sel_kind,  // [S, E]
                                  const uint8_t* __restrict__ node_labels,  // [N, L]
                                  int S, int E, int L, int N,
                                  uint8_t* __restrict__ tm) {  // [S, N]
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)S * N) return;
  int s = (int)(i / N);
  int n = (int)(i % N);
  const uint8_t* lab = node_labels + (int64_t)n * L;
  bool ok = true;
  for (int e = 0; e < E && ok; ++e) {
    int kind = sel_kind[s * E + e];
    if (kind == KIND_PAD) continue;
    if (kind != KIND_ANY && kind != KIND_NONE) {
      ok = false;
      break;
    }
    const uint8_t* m = sel_mask + ((int64_t)s * E + e) * L;
    int cnt = 0;
    for (int l = 0; l < L; ++l) cnt += (m[l] & lab[l]);
    ok = (kind == KIND_ANY) ? (cnt > 0) : (cnt == 0);
  }
  tm[i] = ok ? 1 : 0;
}

__global__ void pack_bits_kernel(const uint8_t* __restrict__ in,  // [rows, T]
                                 int64_t rows, int T, int TW,
                                 uint32_t* __restrict__ out) {  // [rows, TW]
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
