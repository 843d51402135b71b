// The selector-term match as packed words, shared by static_feasible.cu
// (K1: bool label rows) and ring_match.cu (K16: f32 label rows).
//
// A term s matches a row when every expression e of it passes:
//   PAD (kind 0): true, ANY (1): count > 0, NONE (2): count == 0, any other
//   kind: false,
// count being the number of labels l with mask[s, e, l] and row[l] both set
// (!= 0).  That is the JAX package's ops/filters.py:28 term_match and
// parallel/ring.py:35 _eval_block, whose f32 counting products are exact.
// Here no thread walks a row: a block packs a tile of up to 32 contiguous
// rows into 32-bit words in shared memory (scan_set: coalesced 16-byte
// loads, bit l of word l / 32 set where row[l] != 0, the bits past L
// zero), the terms' masks are packed the same way once a block, in the
// same pass as its first rows (or, when they do not fit, a warp ballots
// each mask word from global memory as it needs it), and a warp holds the
// tile's rows in its lanes: count > 0 is "some mask word & row word != 0"
// (term_words_ok).  match_tiles walks a kernel's tiles of 32 rows; where a
// tile's words do not fit a block's shared memory it takes them `rt` rows
// at a time (the lanes past rt idle).  K1 also has a listed-literal match
// of its own (static_feasible.cu) for sparse masks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"
#include "terms.cuh"

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
// dynamic shared memory a block may take on an H100 (227 KB), less a margin
// for the kernels' static shared memory
constexpr size_t MATCH_SMEM_MAX = 232448 - 2048;
constexpr size_t MASK_STAGE_MAX = 32768;  // the bytes of packed masks a block stages

template <class T>
__device__ __forceinline__ bool lit_set(T v) {
  return v != T(0);
}

// PAD, ANY, NONE: the expression's test on whether some literal hit
__device__ __forceinline__ bool expr_ok(int kind, bool hit) {
  return kind == KIND_ANY ? hit : (kind == KIND_NONE ? !hit : kind == KIND_PAD);
}

// Packing rows into words: a block scans the rows with 16-byte loads
// (PACK_DEPTH of them in flight a thread) and ORs the set literals into
// words cleared before (pack_clear, then a barrier): bool bytes (K1's label
// plane: a few labels a node) and f32 (K16's label rows) alike.  Rows past
// `rows` up to the tile's stay zero.
constexpr int PACK_DEPTH = 4;

__device__ __forceinline__ void pack_clear(uint32_t* __restrict__ dst, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = 0u;
}

__device__ __forceinline__ void set_lit(uint32_t* __restrict__ dst, int ldw, int L, int i) {
  const int r = i / L, l = i - r * L;
  atomicOr(&dst[r * ldw + (l >> 5)], 1u << (l & 31));
}

// the set elements among the 16 bytes of v, chunk `c` of a scan whose
// chunks start at element `head`: on_set(flat index) for each
template <class T, class OnSet>
__device__ __forceinline__ void set_elems_of(const uint4& v, int head, int c, OnSet& on_set) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int q = 0; q < 4; ++q)  // bit 7 of each nonzero byte
      for (uint32_t nz = (((w[q] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w[q]) & 0x80808080u; nz; nz &= nz - 1)
        on_set(head + c * 16 + 4 * q + ((__ffs(nz) - 1) >> 3));
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)  // != 0.0f: any bit but the sign (a NaN is set, -0.0f is not)
      if (w[q] << 1) on_set(head + c * 4 + q);
  }
}

// the elements of src before its first 16-byte boundary (at most n)
template <class T>
__device__ __forceinline__ int head_of(const T* src, int n) {
  return min((int)(((16u - ((uintptr_t)src & 15u)) & 15u) / sizeof(T)), n);
}

// Block-wide: on_a(i) for each set element i of a[0, na) and on_b(i) for
// each of b[0, nb) (b may be NULL), both in one pass, so every load of both
// is in flight at once: 16-byte loads, the ragged ends an element a thread
// (blockDim.x >= 16).
template <class T, class OnA, class OnB>
__device__ void scan_set(const T* __restrict__ a, int na, OnA on_a, const T* __restrict__ b, int nb, OnB on_b) {
  constexpr int V = 16 / sizeof(T);
  if (b == nullptr) nb = 0;
  const int ha = head_of(a, na), ca = (na - ha) / V;
  const int hb = nb > 0 ? head_of(b, nb) : 0, cb = (nb - hb) / V;
  // the four ragged ends (fewer than V elements each): thread t loads the
  // t-th of each now and tests it after the body's loads are out
  const int t = threadIdx.x, ta = ha + ca * V + t, tb = hb + cb * V + t;
  const T e0 = t < ha ? a[t] : T(0), e1 = ta < na ? a[ta] : T(0);
  const T e2 = t < hb ? b[t] : T(0), e3 = tb < nb ? b[tb] : T(0);
  const uint4* va = reinterpret_cast<const uint4*>(a + ha);
  const uint4* vb = reinterpret_cast<const uint4*>(b + hb);
  const int chunks = ca + cb;
  for (int c = threadIdx.x; c < chunks; c += PACK_DEPTH * blockDim.x) {
    uint4 v[PACK_DEPTH];
#pragma unroll
    for (int u = 0; u < PACK_DEPTH; ++u) {
      const int cc = c + u * blockDim.x;
      v[u] = cc < ca ? va[cc] : (cc < chunks ? vb[cc - ca] : make_uint4(0u, 0u, 0u, 0u));
    }
#pragma unroll
    for (int u = 0; u < PACK_DEPTH; ++u) {
      const int cc = c + u * blockDim.x;
      if (cc < ca) {
        set_elems_of<T>(v[u], ha, cc, on_a);
      } else {
        set_elems_of<T>(v[u], hb, cc - ca, on_b);
      }
    }
  }
  if (e0 != T(0)) on_a(t);
  if (e1 != T(0)) on_a(ta);
  if (e2 != T(0)) on_b(t);
  if (e3 != T(0)) on_b(tb);
}

// Warp-wide: does the row of this lane (rows_w + lane * ldw; lanes >= rt
// hold no row, an empty one) satisfy the term with E expressions, kinds
// `kind` [E], masks packed in mask_w [E, lw] or, when mask_w is NULL, read
// from `mask` [E, L]?  Every lane of the warp calls it; the loops are
// warp-uniform.
template <class T>
__device__ __forceinline__ bool term_words_ok(const uint32_t* __restrict__ rows_w, int ldw, int rt,
                                              const uint32_t* __restrict__ mask_w, const T* __restrict__ mask,
                                              const int32_t* __restrict__ kind, int E, int L) {
  const int lane = threadIdx.x & 31;
  const int lw = (L + 31) >> 5;
  const uint32_t* mine = rows_w + (lane < rt ? lane : 0) * ldw;
  const uint32_t keep = lane < rt ? FULL_MASK : 0u;
  bool ok = true;
  for (int e = 0; e < E; ++e) {
    const int k = kind[e];
    if (k == KIND_PAD) continue;
    if (k != KIND_ANY && k != KIND_NONE) return false;
    uint32_t acc = 0u;
    if (mask_w != nullptr) {
      const uint32_t* m = mask_w + e * lw;
      for (int j = 0; j < lw; ++j) acc |= m[j] & mine[j];
      acc &= keep;
    } else {
      const T* m = mask + (int64_t)e * L;
      for (int j = 0; j < lw; ++j) {
        const int l = 32 * j + lane;
        acc |= __ballot_sync(FULL_MASK, l < L && lit_set(m[l])) & mine[j];
      }
      acc &= keep;
    }
    ok = ok && expr_ok(k, acc != 0u);
    if (!__any_sync(FULL_MASK, ok)) return false;
  }
  return ok;
}

// The words a match takes: `ldw` a row (odd, so the lanes' rows fall in
// distinct banks), `rt` rows a tile (32 unless 32 rows do not fit), and
// whether the S x E masks are staged (with their kinds) -> the dynamic
// shared memory in bytes, or 0 when one row alone does not fit.
struct MatchPlan {
  int lw, ldw, rt;
  bool stage;
  size_t smem;
};

inline MatchPlan match_plan(int S, int E, int L) {
  MatchPlan p;
  p.lw = (L + 31) / 32;
  p.ldw = p.lw | 1;
  const size_t row_b = 4 * (size_t)p.ldw, mask_b = 4 * (size_t)S * E * (p.lw + 1);  // the words and the kinds
  p.stage = mask_b <= MASK_STAGE_MAX && 32 * row_b + mask_b <= MATCH_SMEM_MAX;
  const size_t rows_max = (MATCH_SMEM_MAX - (p.stage ? mask_b : 0)) / row_b;
  p.rt = rows_max < 32 ? (int)rows_max : 32;
  p.smem = p.rt < 1 ? 0 : p.rt * row_b + (p.stage ? mask_b : 0);
  return p;
}

// Block-wide: the term match of tiles tile0, tile0 + step, ... of 32 rows
// of `src` [n_rows, L] against the S terms (`mask` [S, E, L], `kind` [S,
// E]).  smem: the plan's shared memory (the staged masks first).  For each
// tile and each slice of rt rows from r0, each warp takes terms s = warp,
// warp + warps, ... and calls sink(s, tile, r0, rows, ok), warp-wide, ok
// being its lane's row r0 + lane's answer (lanes >= rows: no row).
template <class T, class Sink>
__device__ void match_tiles(const T* __restrict__ src, int n_rows, const T* __restrict__ mask,
                            const int32_t* __restrict__ kind, int S, int E, int L, const MatchPlan& plan,
                            uint32_t* __restrict__ smem, int tile0, int step, Sink sink) {
  const int SE = S * E;
  uint32_t* mask_w = plan.stage ? smem : nullptr;
  int32_t* kind_sm = reinterpret_cast<int32_t*>(smem) + (size_t)SE * plan.lw;
  uint32_t* rows_w = plan.stage ? smem + (size_t)SE * (plan.lw + 1) : smem;
  const int32_t* kinds = plan.stage ? kind_sm : kind;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int tiles = (n_rows + 31) / 32;
  bool masks_now = plan.stage;  // the masks are packed with the block's first rows
  for (int tile = tile0; tile < tiles; tile += step) {
    for (int r0 = 0; r0 < 32 && 32 * tile + r0 < n_rows; r0 += plan.rt) {
      const int rows = min(plan.rt, n_rows - 32 * tile - r0);
      const T* rows_src = src + (int64_t)(32 * tile + r0) * L;
      __syncthreads();  // the previous rows' readers are done
      // the kinds' loads go out beside the words' and land after them
      const int32_t kv = masks_now && threadIdx.x < SE ? kind[threadIdx.x] : 0;
      if (masks_now) pack_clear(mask_w, SE * plan.lw);
      pack_clear(rows_w, plan.rt * plan.ldw);
      __syncthreads();
      auto set_row = [&](int i) { set_lit(rows_w, plan.ldw, L, i); };
      auto set_mask = [&](int i) { set_lit(mask_w, plan.lw, L, i); };
      scan_set(rows_src, rows * L, set_row, masks_now ? mask : nullptr, SE * L, set_mask);
      if (masks_now)
        for (int i = threadIdx.x; i < SE; i += blockDim.x) kind_sm[i] = i == threadIdx.x ? kv : kind[i];
      __syncthreads();
      masks_now = false;
      for (int s = warp; s < S; s += warps) {
        const bool ok = term_words_ok<T>(rows_w, plan.ldw, plan.rt, mask_w ? mask_w + (size_t)s * E * plan.lw : nullptr,
                                         mask + (int64_t)s * E * L, kinds + (int64_t)s * E, E, L);
        sink(s, tile, r0, rows, ok);
      }
    }
  }
}

// cudaFuncSetAttribute for dynamic shared memory above 48 KB, once per
// device and size (allowed: the size set so far per device)
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int dev, size_t smem, size_t* allowed) {
  if (smem <= 48 * 1024 || (dev >= 0 && dev < ktt::MAX_DEVICES && smem <= allowed[dev])) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && dev >= 0 && dev < ktt::MAX_DEVICES) allowed[dev] = smem;
  return err;
}

}  // namespace
