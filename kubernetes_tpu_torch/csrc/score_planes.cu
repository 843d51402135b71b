// K10 score_planes: the two [P, N] raw score planes of the per-pod
// normalisation stages, stored as bf16 (round to nearest even), or as f32
// under KTPU_SCORE_DTYPE=f32 (ktt_score_planes_f32: the same kernel with
// f32 stores, 16 bytes a plane a lane; the JAX package's
// ops/bitplane.py:209-236 storage knob).
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
//                 few slots in slot order.
// Both are integer-valued f32 sums (exact below 2^24 in any order), so the
// direct loops give the products' values; __float2bfloat16_rn rounds as
// torch's .to(torch.bfloat16) and XLA's convert do.
//
// Design: one launch, no scratch.  Block (x, y) owns the node tile [TN x,
// TN (x + 1)) and the pod slab [PB y, PB (y + 1)) (PB chosen by the C
// entry so that the grid is about TARGET_BLOCKS blocks).  It packs the
// tile's PreferNoSchedule words from the node_taint_pref bytes (a thread a
// (node, word)) and evaluates term_ok once per (term, node of the tile), a
// bit per pair (a warp ballot a 32-node word), into shared memory: for
// every term where S <= ALL_S (term s is slot s), else for the terms its
// pods name (terms.cuh NamedTerms).  Every load that needs nothing staged
// (the tile's words, all terms' bits, the first chunk of pod rows) is
// issued before the first barrier.  Then it
// walks its pods in chunks of CH rows: the whole block stages a chunk's
// slot weights, slots (a term's named slot) and toleration words (packed
// from the bytes) in shared memory with coalesced loads, and a warp takes
// one row at a time, lane l writing nodes TN x + 4 l .. + 3 of both planes,
// 8 bytes a plane where the row is 8-byte aligned.  A row then reads only
// shared memory: no global load sits between two rows' stores (rows that
// loaded their own slots from global memory waited on them: 0.199 against
// 0.146 ms at [10240, 6144], bench/score_explain.py).  Fallbacks, inside the same
// kernel: more than TW_STAGE * 32 taints -> a lane packs its nodes' words
// from the bytes per pod row; S > NAMED_S_MAX or more than NS_MAX named
// terms -> term_ok per (slot, node); a row wider than ROWBUF / 8 bytes
// (8 PW + 4 TW) -> the rows are read from global memory by their warps.
//
// Bound on an H100: the output, 4 bytes per (pod, node) (at P = 512, N =
// 256: 0.5 MB, >= 0.16 us at 3.35 TB/s; at P = 10240, N = 6144: 252 MB,
// 75 us), 8 bytes in f32 (150 us there); the inputs are KBs.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "terms.cuh"

namespace {

constexpr int NT = 256;          // threads a block: 8 warps, a pod row each
constexpr int TN = 128;          // nodes a block: 4 a lane
constexpr int TNW = TN / 32;     // 32-node words of the tile
constexpr int TW_STAGE = 16;     // taint words staged (512 taints)
constexpr int ALL_S = 32;        // up to this many terms, every term gets its bits (no named-term stage)
constexpr int NS_MAX = 512;      // named terms staged
constexpr int TARGET_BLOCKS = 528;  // 4 a streaming multiprocessor of an H100
constexpr int ROWBUF = 16384;    // bytes of staged pod rows
constexpr unsigned FULL = 0xffffffffu;

struct PlaneArgs {
  const uint8_t* node_taint_pref;  // [N, T]
  const uint8_t* pod_tol_pref;     // [P, T]
  const int32_t* pref_terms;       // [P, PW]
  const float* pref_weights;       // [P, PW]
  const uint8_t* sel_mask;         // [S, E, L]
  const int32_t* sel_kind;         // [S, E]
  const uint8_t* node_labels;      // [N, L]
  void* traw;                      // [P, N] bf16, or f32 (OutT)
  void* naraw;                     // [P, N]
  int P, N, T, PW, S, E, L, TW, PB, CH;
};

__device__ __forceinline__ uint32_t pack_word(const uint8_t* __restrict__ row, int T, int w) {
  const int lim = min(32, T - 32 * w);
  uint32_t bits = 0;
  for (int b = 0; b < lim; ++b) bits |= (uint32_t)(row[32 * w + b] != 0) << b;
  return bits;
}

// x then y, each rounded to the nearest even bf16, as one 32-bit word (x low)
__device__ __forceinline__ uint32_t bf16_pair(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four consecutive values of a plane at x: bf16 (8 bytes, rounded to the
// nearest even) or f32 (16 bytes), one store where x is aligned to it
__device__ __forceinline__ void store4(__nv_bfloat16* x, const float v[4], int lim) {
  if (lim == 4 && (reinterpret_cast<uintptr_t>(x) & 7) == 0) {
    *reinterpret_cast<uint2*>(x) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
  } else {
    for (int i = 0; i < lim; ++i) x[i] = __float2bfloat16_rn(v[i]);
  }
}

__device__ __forceinline__ void store4(float* x, const float v[4], int lim) {
  if (lim == 4 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    *reinterpret_cast<float4*>(x) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int i = 0; i < lim; ++i) x[i] = v[i];
  }
}

// lane `lane` of a warp writes pod row p's planes at nodes n0 .. n0 + 3;
// tol(w): the row's toleration word w; slot(k, s, wt): slot k's term (its
// named slot where terms are staged; < 0: none) and weight
template <class OutT, class Tol, class Slot>
__device__ __forceinline__ void plane_row(const PlaneArgs& a, const uint32_t* __restrict__ taintw,
                                          const uint32_t* __restrict__ tmw, bool direct_taint, bool direct_terms,
                                          int p, int lane, Tol tol, Slot slot) {
  const int n0 = blockIdx.x * TN + 4 * lane;
  const int q = lane >> 3, sh = (lane & 7) * 4;  // the lane's term word and first bit there
  int c[4] = {0, 0, 0, 0};
  for (int w = 0; w < a.TW; ++w) {
    const uint32_t tl = tol(w);
    uint32_t tw[4];
    if (!direct_taint) {
      const uint4 v = *reinterpret_cast<const uint4*>(&taintw[w * TN + 4 * lane]);
      tw[0] = v.x;
      tw[1] = v.y;
      tw[2] = v.z;
      tw[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        tw[i] = n0 + i < a.N ? pack_word(a.node_taint_pref + (int64_t)(n0 + i) * a.T, a.T, w) : 0u;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += __popc(tw[i] & ~tl);
  }
  float na[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < a.PW; ++k) {
    int s;
    float wt;
    slot(k, s, wt);
    if (s < 0) continue;
    uint32_t m = 0;  // bit i: node n0 + i matches the term
    if (!direct_terms) {
      m = (tmw[s * TNW + q] >> sh) & 0xfu;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (n0 + i < a.N && term_ok(a.sel_mask, a.sel_kind, a.node_labels, s, n0 + i, a.E, a.L)) m |= 1u << i;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (m >> i & 1u) na[i] += wt;
  }
  if (n0 >= a.N) return;
  const int64_t o = (int64_t)p * a.N + n0;
  const int lim = min(4, a.N - n0);
  const float cf[4] = {(float)c[0], (float)c[1], (float)c[2], (float)c[3]};
  store4(static_cast<OutT*>(a.traw) + o, cf, lim);
  store4(static_cast<OutT*>(a.naraw) + o, na, lim);
}

template <bool STAGED, class OutT>
__global__ void __launch_bounds__(NT) score_planes_kernel(const PlaneArgs a) {
  __shared__ __align__(16) uint32_t taintw[TW_STAGE * TN];  // [word][node], read 4 nodes at a time
  __shared__ uint32_t tmw[NS_MAX * TNW];                    // [slot][32-node word]
  __shared__ int named[NS_MAX];
  __shared__ NamedTerms nt;
  __shared__ __align__(16) unsigned char rowbuf[ROWBUF];  // STAGED: a chunk of CH pod rows

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int base = blockIdx.x * TN;
  const int p0 = blockIdx.y * a.PB;
  const int p1 = min(a.P, p0 + a.PB);
  const bool direct_taint = a.TW > TW_STAGE;
  const bool all_terms = a.S <= ALL_S;  // every term gets its bits, term s is slot s
  const bool use_named = !all_terms && a.S <= NAMED_S_MAX;
  float* swt = reinterpret_cast<float*>(rowbuf);
  int* sslot = reinterpret_cast<int*>(rowbuf + sizeof(float) * a.CH * a.PW);
  uint32_t* stol = reinterpret_cast<uint32_t*>(rowbuf + 2 * sizeof(float) * a.CH * a.PW);
  // STAGED: pod rows [c0, c0 + rows) into the stage, the slots as terms (raw) or as named slots
  auto stage = [&](int c0, int rows, bool raw) {
    for (int i = t; i < rows * a.PW; i += NT) {
      const int64_t g = (int64_t)c0 * a.PW + i;
      const int s = a.pref_terms[g];
      sslot[i] = s < 0 || raw ? s : named_slot(nt, s);
      swt[i] = a.pref_weights[g];
    }
    for (int i = t; i < rows * a.TW; i += NT)
      stol[i] = pack_word(a.pod_tol_pref + (int64_t)(c0 + i / a.TW) * a.T, a.T, i % a.TW);
  };

  // the loads that need nothing staged go first, so their latencies overlap: the tile's
  // PreferNoSchedule words (a thread a (node, word)), every term's bits where there are few
  // (a warp ballot a 32-node word), the first chunk of pod rows
  if (use_named) named_clear(nt, a.S);
  if (!direct_taint)
    for (int i = t; i < TN * a.TW; i += NT) {
      const int gn = base + i % TN;
      taintw[i] = gn < a.N ? pack_word(a.node_taint_pref + (int64_t)gn * a.T, a.T, i / TN) : 0u;
    }
  if (all_terms)
    for (int i = warp; i < a.S * TNW; i += NT / 32) {
      const int gn = base + 32 * (i % TNW) + lane;
      const uint32_t word =
          __ballot_sync(FULL, gn < a.N && term_ok(a.sel_mask, a.sel_kind, a.node_labels, i / TNW, gn, a.E, a.L));
      if (lane == 0) tmw[i] = word;
    }
  const int rows0 = STAGED ? min(a.CH, p1 - p0) : 0;
  if (STAGED) stage(p0, rows0, true);
  __syncthreads();

  // where there are more terms: only those the slab's pods name
  bool direct_terms = !all_terms && !use_named;
  if (use_named) {
    const int64_t marks = (int64_t)(p1 - p0) * a.PW;
    for (int64_t e = t; e < marks; e += NT) named_mark(nt, a.pref_terms[(int64_t)p0 * a.PW + e], a.S);
    __syncthreads();
    named_list(nt, a.S, named, NS_MAX);
    __syncthreads();
    direct_terms = nt.count > NS_MAX;
    if (!direct_terms) {
      for (int i = warp; i < nt.count * TNW; i += NT / 32) {
        const int gn = base + 32 * (i % TNW) + lane;
        const uint32_t word = __ballot_sync(
            FULL, gn < a.N && term_ok(a.sel_mask, a.sel_kind, a.node_labels, named[i / TNW], gn, a.E, a.L));
        if (lane == 0) tmw[i] = word;
      }
      if (STAGED)
        for (int i = t; i < rows0 * a.PW; i += NT)
          if (sslot[i] >= 0) sslot[i] = named_slot(nt, sslot[i]);
    }
    __syncthreads();
  }
  const bool raw = all_terms || direct_terms;  // a slot is its term

  if (STAGED) {
    // chunks of CH pod rows staged by the whole block (coalesced), then a warp a row
    for (int c0 = p0; c0 < p1; c0 += a.CH) {
      const int rows = min(a.CH, p1 - c0);
      if (c0 > p0) {
        __syncthreads();  // the last chunk's rows are read
        stage(c0, rows, raw);
        __syncthreads();
      }
      for (int r = warp; r < rows; r += NT / 32)
        plane_row<OutT>(a, taintw, tmw, direct_taint, direct_terms, c0 + r, lane,
                  [&](int w) { return stol[r * a.TW + w]; },
                  [&](int k, int& s, float& wt) {
                    s = sslot[r * a.PW + k];
                    wt = swt[r * a.PW + k];
                  });
    }
  } else {
    // rows too wide to stage: a warp a row, straight from global memory
    for (int p = p0 + warp; p < p1; p += NT / 32)
      plane_row<OutT>(a, taintw, tmw, direct_taint, direct_terms, p, lane,
                [&](int w) {
                  const int b = 32 * w + lane;
                  return __ballot_sync(FULL, b < a.T && a.pod_tol_pref[(int64_t)p * a.T + b]);
                },
                [&](int k, int& s, float& wt) {
                  s = a.pref_terms[(int64_t)p * a.PW + k];
                  wt = a.pref_weights[(int64_t)p * a.PW + k];
                  if (s >= 0 && !raw) s = named_slot(nt, s);
                });
  }
}

template <class OutT>
int launch(const void* node_taint_pref, const void* pod_tol_pref, const void* pref_terms, const void* pref_weights,
           const void* sel_mask, const void* sel_kind, const void* node_labels, void* traw, void* naraw, int P, int N,
           int T, int PW, int S, int E, int L, void* stream) {
  if (P < 0 || N < 0 || T < 0 || PW < 0 || S < 0) return (int)cudaErrorInvalidValue;
  if (P == 0 || N == 0) return (int)cudaGetLastError();
  PlaneArgs a;
  a.node_taint_pref = static_cast<const uint8_t*>(node_taint_pref);
  a.pod_tol_pref = static_cast<const uint8_t*>(pod_tol_pref);
  a.pref_terms = static_cast<const int32_t*>(pref_terms);
  a.pref_weights = static_cast<const float*>(pref_weights);
  a.sel_mask = static_cast<const uint8_t*>(sel_mask);
  a.sel_kind = static_cast<const int32_t*>(sel_kind);
  a.node_labels = static_cast<const uint8_t*>(node_labels);
  a.traw = traw;
  a.naraw = naraw;
  a.P = P;
  a.N = N;
  a.T = T;
  a.PW = PW;
  a.S = S;
  a.E = E;
  a.L = L;
  a.TW = T > 32 ? (T + 31) / 32 : 1;
  const int nbx = (N + TN - 1) / TN;
  const int rows = NT / 32;  // pod rows a block takes at once
  int nby = (TARGET_BLOCKS + nbx - 1) / nbx;
  nby = max(1, min(nby, min((P + rows - 1) / rows, 65535)));
  a.PB = (P + nby - 1) / nby;
  nby = (P + a.PB - 1) / a.PB;
  // pod rows a chunk: as many as ROWBUF holds (a weight, a slot and the
  // toleration words a row), in whole passes of 8 rows, at most the slab's
  const int row_bytes = 8 * PW + 4 * a.TW;
  a.CH = min((ROWBUF / row_bytes) / rows * rows, (a.PB + rows - 1) / rows * rows);
  const dim3 grid((unsigned)nbx, (unsigned)nby);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (a.CH >= rows)
    score_planes_kernel<true, OutT><<<grid, NT, 0, st>>>(a);
  else
    score_planes_kernel<false, OutT><<<grid, NT, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// every pointer is device memory; traw and naraw are [P, N] each, bf16
extern "C" int ktt_score_planes(const void* node_taint_pref, const void* pod_tol_pref, const void* pref_terms,
                                const void* pref_weights, const void* sel_mask, const void* sel_kind,
                                const void* node_labels, void* traw, void* naraw, int P, int N, int T, int PW, int S,
                                int E, int L, void* stream) {
  return launch<__nv_bfloat16>(node_taint_pref, pod_tol_pref, pref_terms, pref_weights, sel_mask, sel_kind,
                               node_labels, traw, naraw, P, N, T, PW, S, E, L, stream);
}

// the same, traw and naraw f32 (KTPU_SCORE_DTYPE=f32)
extern "C" int ktt_score_planes_f32(const void* node_taint_pref, const void* pod_tol_pref, const void* pref_terms,
                                    const void* pref_weights, const void* sel_mask, const void* sel_kind,
                                    const void* node_labels, void* traw, void* naraw, int P, int N, int T, int PW,
                                    int S, int E, int L, void* stream) {
  return launch<float>(node_taint_pref, pod_tol_pref, pref_terms, pref_weights, sel_mask, sel_kind, node_labels,
                       traw, naraw, P, N, T, PW, S, E, L, stream);
}
