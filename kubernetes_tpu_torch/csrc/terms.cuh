// Interned selector terms on the card.
//
// term_ok: does a node's label row satisfy term s (the JAX package's
// ops/filters.py:28 term_match for one (term, node) pair, as integer
// literal counts)?  feasible.cuh builds its [S, N] match on it.
//
// NamedTerms: the terms a block's rows name, for kernels that match only
// those (explain.cu, score_planes.cu).  The block marks each named term in
// a bitmap over S, then one warp lists them in ascending order and keeps,
// per 32-term word, the count of named terms below it, so a term's slot
// (its rank among the named ones) is one popc.  The block evaluates
// term_ok once per (listed term, node of its tile).  For S above
// NAMED_S_MAX, or more named terms than the kernel stages, the kernel
// calls term_ok per pair instead (`direct`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_PAD = 0;
constexpr int KIND_ANY = 1;
constexpr int KIND_NONE = 2;

// does node n's label row satisfy interned selector term s?
__device__ __forceinline__ bool term_ok(const uint8_t* __restrict__ sel_mask, const int32_t* __restrict__ sel_kind,
                                        const uint8_t* __restrict__ node_labels, int s, int n, int E, int L) {
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
  return ok;
}

constexpr int NAMED_S_MAX = 8192;  // terms the bitmap covers
constexpr int NAMED_W = NAMED_S_MAX / 32;

struct NamedTerms {
  uint32_t bits[NAMED_W];  // bit s: some row of the block names term s
  uint16_t below[NAMED_W];  // named terms in the words before word w
  int count;                // named terms in all
};

// zero the bitmap's first ceil(S / 32) words; the caller syncs after it
__device__ __forceinline__ void named_clear(NamedTerms& nt, int S) {
  const int sw = (S + 31) / 32;
  for (int w = threadIdx.x; w < sw; w += blockDim.x) nt.bits[w] = 0u;
}

__device__ __forceinline__ void named_mark(NamedTerms& nt, int s, int S) {
  if (s >= 0 && s < S) atomicOr(&nt.bits[s >> 5], 1u << (s & 31));
}

// warp 0: `below` per word, the named terms in ascending order into
// list[0, list_max), and the count (which may exceed list_max); the caller
// syncs after it
__device__ __forceinline__ void named_list(NamedTerms& nt, int S, int* __restrict__ list, int list_max) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int sw = (S + 31) / 32;
  int running = 0;
  for (int base = 0; base < sw; base += 32) {
    const int w = base + lane;
    const uint32_t bits = w < sw ? nt.bits[w] : 0u;
    const int c = __popc(bits);
    int incl = c;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    int at = running + incl - c;
    if (w < sw) nt.below[w] = (uint16_t)at;
    for (uint32_t b = bits; b; b &= b - 1) {
      if (at < list_max) list[at] = w * 32 + __ffs(b) - 1;
      ++at;
    }
    running += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) nt.count = running;
}

// the slot of a named term s: the named terms below it
__device__ __forceinline__ int named_slot(const NamedTerms& nt, int s) {
  return nt.below[s >> 5] + __popc(nt.bits[s >> 5] & ((1u << (s & 31)) - 1u));
}

}  // namespace
