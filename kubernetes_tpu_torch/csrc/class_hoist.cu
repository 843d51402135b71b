// The class hoists of the class-wave route: [U1, N] matrices, one row per
// equivalence class (U1 = classes + the padding class), the row of a class
// being the row any of its pods would get.
//
// K3 ktt_class_static_hoist replaces the JAX package's
//   ops/incremental.py:146 _static_hoist (fit-only stage set):
//   stat_u[u] = pack(node_valid & taints_ok & nodesel & nodename_ok), for
//   the class's first pod row r_u[u], WITHOUT pod_valid.  The taint and
//   selector tests are static_feasible.cu's integer ones (feasible.cuh:
//   term_match_kernel, pack_bits_kernel); one thread per (class, node), and
//   a warp ballot writes 32 nodes' bits as one word directly (tail bits
//   past N are zero), never a bool plane.
//
// K7 ktt_packed_static_rows replaces the dense chunked route's packed
//   static plane, the lax.map of static_feasible_rows + bitplane.pack over
//   blocks of pod rows (ops/assign.py:1014-1053, ops/filters.py:92): the
//   same kernel over every POD row (no class index) with the pod_valid
//   term, sfs[p] = pack(node_valid & pod_valid & taints_ok & nodesel &
//   nodename_ok).  At the north star it writes 51200 x 640 words (131 MB,
//   >= 39 us at 3.35 TB/s): the words are the bound.
//
// K4 ktt_class_usage_hoist replaces
//   ops/incremental.py:188 _usage_hoist (cols == NULL: every column) and
//   ops/incremental.py:214 _patch_hoist (cols: a pow2 column list padded
//   with the sentinel N, which is skipped):
//   base_u[u, n] = fit_w * fit_score + bal_w * balanced of used[n] + req_u[u]
//   fit_u[u] bit n = fit_ok (subtraction form) of req_u[u] at node n.
//   Full mode packs the fit bits by warp ballot; column mode writes each
//   dirty column's bit with one atomicOr (fits) or atomicAnd (does not),
//   which is the exact (w & ~touched) | new assignment of the JAX package's
//   bitplane.assign_cols even when several dirty columns share a word
//   (duplicate columns carry equal values).  Column mode updates the
//   buffers it is given in place: the wrapper hands it a copy of the
//   resident generation (the donation-aliasing rule).
//
// Bounds on an H100 at U1 = 102, N = 20480, R = 5: K3 writes 102 x 640
// words and reads KBs; K4 reads 2 x N x R int32 and writes U1 x N f32 +
// U1 x W words (~8.6 MB, >= 2.6 us at 3.35 TB/s) and does ~45 f32
// operations per (class, node) (~94 M, >= 1.4 us at 67 TFLOP/s).
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "feasible.cuh"
#include "score.cuh"

namespace {

constexpr int NT = 256;

// grid.y is at most 65535: kernels over rows loop blockIdx.y by gridDim.y
constexpr int MAX_GRID_Y = 65535;

// row u's pod row: the class's first pod r_u[u], or u itself (r_u NULL)
__device__ __forceinline__ int64_t pod_row(const int64_t* r_u, int u) { return r_u ? r_u[u] : u; }

// tolerations of each row's pod, as words: tol_w[u, TW]
__global__ void class_tol_kernel(const uint8_t* __restrict__ pod_tol_ns,  // [P, T]
                                 const int64_t* __restrict__ r_u, int U1, int T, int TW,
                                 uint32_t* __restrict__ tol_w) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)U1 * TW) return;
  const int u = (int)(i / TW), w = (int)(i % TW);
  const uint8_t* src = pod_tol_ns + pod_row(r_u, u) * T + 32 * w;
  const int lim = min(32, T - 32 * w);
  uint32_t bits = 0;
  for (int b = 0; b < lim; ++b) bits |= (uint32_t)(src[b] != 0) << b;
  tol_w[i] = bits;
}

// one thread per (row, node); rows are classes (r_u: their first pods) or
// pods (r_u NULL); pod_valid NULL leaves the pod_valid term out
__global__ void __launch_bounds__(NT) class_static_kernel(
    const uint8_t* __restrict__ node_valid,    // [N]
    const uint32_t* __restrict__ taint_w,      // [N, TW]
    const uint32_t* __restrict__ tol_w,        // [U1, TW]
    const int32_t* __restrict__ pod_nodename,  // [P]
    const int32_t* __restrict__ pod_terms,     // [P, TT]
    const uint8_t* __restrict__ pod_has_sel,   // [P]
    const uint8_t* __restrict__ tm,            // [S, N]
    const int64_t* __restrict__ r_u,           // [U1] or NULL
    const uint8_t* __restrict__ pod_valid,     // [P] or NULL
    int U1, int N, int W, int TW, int TT,
    uint32_t* __restrict__ stat_u) {  // [U1, W]
  const int n = blockIdx.x * NT + threadIdx.x;
  if (n >= W * 32) return;  // whole warps leave together (NT % 32 == 0)
  for (int u = blockIdx.y; u < U1; u += gridDim.y) {
    const int64_t p = pod_row(r_u, u);
    bool ok = n < N && node_valid[n] && (pod_valid == nullptr || pod_valid[p]);
    for (int w = 0; ok && w < TW; ++w) {
      if (taint_w[(int64_t)n * TW + w] & ~tol_w[(int64_t)u * TW + w]) ok = false;
    }
    const int pin = pod_nodename[p];
    if (pin != -1) ok = ok && pin == n;  // -2: the named node is missing
    if (ok && pod_has_sel[p]) {
      bool any = false;
      for (int j = 0; j < TT && !any; ++j) {
        const int s = pod_terms[p * TT + j];
        if (s >= 0) any = tm[(int64_t)s * N + n] != 0;
      }
      ok = any;
    }
    const uint32_t word = __ballot_sync(0xffffffffu, ok);
    if ((threadIdx.x & 31) == 0) stat_u[(int64_t)u * W + (n >> 5)] = word;
  }
}

// the packed static plane of U1 rows (classes or pods): term match, taint
// and toleration words, then one word per (row, 32 nodes)
int static_plane(const void* node_valid, const void* node_taint_ns, const void* node_labels,
                 const void* pod_valid, const void* pod_tol_ns, const void* pod_nodename,
                 const void* pod_terms, const void* pod_has_sel, const void* sel_mask,
                 const void* sel_kind, const void* r_u, void* tm, void* taint_w, void* tol_w,
                 void* stat_u, int U1, int N, int T, int TT, int S, int E, int L, cudaStream_t st) {
  if (U1 <= 0 || N <= 0) return (int)cudaGetLastError();
  const int TW = T > 32 ? (T + 31) / 32 : 1;  // T == 0 packs to one zero word
  const int W = (N + 31) / 32;
  term_match_kernel<<<blocks_for((int64_t)S * N, NT), NT, 0, st>>>(
      static_cast<const uint8_t*>(sel_mask), static_cast<const int32_t*>(sel_kind),
      static_cast<const uint8_t*>(node_labels), S, E, L, N, static_cast<uint8_t*>(tm));
  pack_bits_kernel<<<blocks_for((int64_t)N * TW, NT), NT, 0, st>>>(
      static_cast<const uint8_t*>(node_taint_ns), N, T, TW, static_cast<uint32_t*>(taint_w));
  class_tol_kernel<<<blocks_for((int64_t)U1 * TW, NT), NT, 0, st>>>(
      static_cast<const uint8_t*>(pod_tol_ns), static_cast<const int64_t*>(r_u), U1, T, TW,
      static_cast<uint32_t*>(tol_w));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_for((int64_t)W * 32, NT), U1 < MAX_GRID_Y ? U1 : MAX_GRID_Y);
  class_static_kernel<<<grid, NT, 0, st>>>(
      static_cast<const uint8_t*>(node_valid), static_cast<const uint32_t*>(taint_w),
      static_cast<const uint32_t*>(tol_w), static_cast<const int32_t*>(pod_nodename),
      static_cast<const int32_t*>(pod_terms), static_cast<const uint8_t*>(pod_has_sel),
      static_cast<const uint8_t*>(tm), static_cast<const int64_t*>(r_u),
      static_cast<const uint8_t*>(pod_valid), U1, N, W, TW, TT, static_cast<uint32_t*>(stat_u));
  return (int)cudaGetLastError();
}

// one thread per (class, node column): full mode over every column (cols
// == NULL, packing by ballot), column mode over the list
__global__ void __launch_bounds__(NT) class_usage_kernel(
    const int32_t* __restrict__ req_u,  // [U1, R]
    const int32_t* __restrict__ used,   // [N, R]
    const int32_t* __restrict__ alloc,  // [N, R]
    const int32_t* __restrict__ cols,   // [D] or NULL
    int D, ktt::ScoreParams sp, int N, int W, int R,
    float* __restrict__ base_u,    // [U1, N]
    uint32_t* __restrict__ fit_u) {  // [U1, W]
  const int t = blockIdx.x * NT + threadIdx.x;
  const int u = blockIdx.y;
  const int32_t* rq = req_u + (int64_t)u * R;
  if (cols == nullptr) {
    if (t >= W * 32) return;  // whole warps
    bool fit = false;
    if (t < N) {
      const int32_t* un = used + (int64_t)t * R;
      const int32_t* an = alloc + (int64_t)t * R;
      fit = ktt::fit_ok(R, [&](int r) { return rq[r]; }, [&](int r) { return un[r]; },
                        [&](int r) { return an[r]; });
      base_u[(int64_t)u * N + t] = ktt::score_flat(
          sp, [&](int r) { return ktt::wadd(un[r], rq[r]); }, [&](int r) { return an[r]; });
    }
    const uint32_t word = __ballot_sync(0xffffffffu, fit);
    if ((threadIdx.x & 31) == 0) fit_u[(int64_t)u * W + (t >> 5)] = word;
    return;
  }
  if (t >= D) return;
  const int c = cols[t];
  if (c < 0 || c >= N) return;  // the sentinel N pads the list
  const int32_t* un = used + (int64_t)c * R;
  const int32_t* an = alloc + (int64_t)c * R;
  const bool fit = ktt::fit_ok(R, [&](int r) { return rq[r]; }, [&](int r) { return un[r]; },
                               [&](int r) { return an[r]; });
  base_u[(int64_t)u * N + c] = ktt::score_flat(
      sp, [&](int r) { return ktt::wadd(un[r], rq[r]); }, [&](int r) { return an[r]; });
  uint32_t* word = fit_u + (int64_t)u * W + (c >> 5);
  const uint32_t bit = 1u << (c & 31);
  if (fit) {
    atomicOr(word, bit);
  } else {
    atomicAnd(word, ~bit);
  }
}

}  // namespace

extern "C" int ktt_class_static_hoist(const void* node_valid, const void* node_taint_ns,
                                      const void* node_labels, const void* pod_tol_ns,
                                      const void* pod_nodename, const void* pod_terms,
                                      const void* pod_has_sel, const void* sel_mask,
                                      const void* sel_kind, const void* r_u, void* tm,
                                      void* taint_w, void* tol_w, void* stat_u, int U1, int N,
                                      int T, int TT, int S, int E, int L, void* stream) {
  return static_plane(node_valid, node_taint_ns, node_labels, nullptr, pod_tol_ns, pod_nodename,
                      pod_terms, pod_has_sel, sel_mask, sel_kind, r_u, tm, taint_w, tol_w, stat_u,
                      U1, N, T, TT, S, E, L, reinterpret_cast<cudaStream_t>(stream));
}

// K7: every pod row, pod_valid included -> sfs [P, W]
extern "C" int ktt_packed_static_rows(const void* node_valid, const void* node_taint_ns,
                                      const void* node_labels, const void* pod_valid,
                                      const void* pod_tol_ns, const void* pod_nodename,
                                      const void* pod_terms, const void* pod_has_sel,
                                      const void* sel_mask, const void* sel_kind, void* tm,
                                      void* taint_w, void* tol_w, void* sfs, int P, int N, int T,
                                      int TT, int S, int E, int L, void* stream) {
  return static_plane(node_valid, node_taint_ns, node_labels, pod_valid, pod_tol_ns, pod_nodename,
                      pod_terms, pod_has_sel, sel_mask, sel_kind, nullptr, tm, taint_w, tol_w, sfs,
                      P, N, T, TT, S, E, L, reinterpret_cast<cudaStream_t>(stream));
}

// ip / fp: the score parameters (score.cuh make_score_params), host memory
extern "C" int ktt_class_usage_hoist(const void* req_u, const void* used, const void* alloc,
                                     const void* cols, int D, const int* ip, const float* fp,
                                     void* base_u, void* fit_u, int U1, int N, int R,
                                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const ktt::ScoreParams sp = ktt::make_score_params(ip, fp);
  if (!ktt::score_params_ok(sp, R)) return (int)cudaErrorInvalidValue;
  if (U1 <= 0 || N <= 0) return (int)cudaGetLastError();
  const int W = (N + 31) / 32;
  const int64_t work = cols ? (int64_t)D : (int64_t)W * 32;
  if (work <= 0) return (int)cudaGetLastError();
  dim3 grid(blocks_for(work, NT), U1);
  class_usage_kernel<<<grid, NT, 0, st>>>(
      static_cast<const int32_t*>(req_u), static_cast<const int32_t*>(used),
      static_cast<const int32_t*>(alloc), static_cast<const int32_t*>(cols), D, sp, N, W, R,
      static_cast<float*>(base_u), static_cast<uint32_t*>(fit_u));
  return (int)cudaGetLastError();
}
