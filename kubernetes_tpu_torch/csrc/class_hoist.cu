// The class hoists of the class-wave route: [U1, N] matrices, one row per
// equivalence class (U1 = classes + the padding class), the row of a class
// being the row any of its pods would get.
//
// K3 ktt_class_static_hoist replaces the JAX package's
//   ops/incremental.py:146 _static_hoist (its packed planes; the bf16
//   taint and node-affinity planes are K10's, score_planes.cu, over the
//   class view's rows):
//   stat_u[u] = pack(node_valid & taints_ok & nodesel & nodename_ok), for
//   the class's first pod row r_u[u], WITHOUT pod_valid; with elig_u (the
//   pairwise configs, want_elig) also elig_u[u] = pack(nodesel &
//   node_valid), the same words as K7's eligibility plane.  The selector
//   test is static_feasible.cu's integer one (terms.cuh term_ok); K3
//   and K7 share static_plane below, which packs along the nodes once and
//   then assembles each (row, 32 nodes) word with word operations, never
//   a bool plane (tail bits past N are zero).
//
// K7 ktt_packed_static_rows replaces the dense chunked route's packed
//   static plane, the lax.map of static_feasible_rows + bitplane.pack over
//   blocks of pod rows (ops/assign.py:1014-1053, ops/filters.py:92): the
//   same kernel over every POD row (no class index) with the pod_valid
//   term, sfs[p] = pack(node_valid & pod_valid & taints_ok & nodesel &
//   nodename_ok).  At the north star it writes 51200 x 640 words (131 MB,
//   >= 39 us at 3.35 TB/s): the words are the bound.  For the full stage
//   set (:1616-1640) it also writes the eligibility plane
//   eligs[p] = pack(nodesel & node_valid) that spread's minMatch reads.
//   Its `done` word (or NULL) gates both launches: the gang fixpoint's
//   device loop (ops/gang.py) queues K7 for each of its iterations, and the
//   ones after the fixpoint return at entry.  Both launches are grids of a
//   few blocks per SM that walk their items, so a gated call costs two
//   launches of ~1k blocks that read `done` and leave (the first design's
//   grid of one 256-thread block per (row, 256 nodes) put 8 x 65535 blocks
//   on the card per gated call at config 5: 328.8 us of card time).
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
constexpr int ROWS_NT = 256;

// row u's pod row: the class's first pod r_u[u], or u itself (r_u NULL)
__device__ __forceinline__ int64_t pod_row(const int64_t* r_u, int u) { return r_u ? r_u[u] : u; }

// The packed static plane of U1 rows (classes or pods) in two launches,
// each a grid of a few blocks per SM that walks its items, so a gated call
// is two launches of blocks that read `done` and leave:
//
// static_setup_kernel packs every input the rows share along the node axis,
//   one warp per 32-lane item: the term match words tmw[s, w] (bit j: node
//   32w + j satisfies term s), the node-valid words nw[w], per taint word k
//   the OR of a node word's taints orw[w, k] and the transposed taint words
//   ttw[t, w] (bit j: node 32w + j carries hard taint t), and each row's
//   toleration words tol_w[u, k];
// static_rows_kernel assembles each (row, node word) from them with word
//   operations, RB rows a tile (their pin, flags, terms and tolerations
//   staged in shared memory), the threads along the words so the stores
//   coalesce:
//     elig = nw & (has_sel ? OR over the row's terms of tmw[s] : ~0)
//     stat = pod_valid ? elig & ~(OR over the intolerable taints t of the
//            word's nodes of ttw[t]) & (pin unset ? ~0 : the pin's bit) : 0
//   which is the per-node test of the JAX package's ops/filters.py:92 bit
//   for bit (a node's taint word fails the row's tolerations exactly when
//   it carries a taint t outside them; tail bits past N stay zero, as nw's
//   are).
constexpr int SETUP_NT = 256;
constexpr int SETUP_PER_SM = 4;  // set-up blocks per SM
constexpr int ROWS_PER_SM = 8;   // row-kernel blocks per SM
constexpr int MAX_RB = 32;       // rows per tile
constexpr int ROW_SMEM = 32768;  // the staged rows' bytes a block may take

__global__ void __launch_bounds__(SETUP_NT) static_setup_kernel(
    const uint8_t* __restrict__ node_valid,     // [N]
    const uint8_t* __restrict__ node_taint_ns,  // [N, T]
    const uint8_t* __restrict__ node_labels,    // [N, L]
    const uint8_t* __restrict__ pod_tol_ns,     // [P, T]
    const uint8_t* __restrict__ sel_mask,       // [S, E, L]
    const int32_t* __restrict__ sel_kind,       // [S, E]
    const int64_t* __restrict__ r_u,            // [U1] or NULL
    int U1, int N, int W, int T, int TW, int S, int E, int L,
    uint32_t* __restrict__ tmw,    // [S, W]
    uint32_t* __restrict__ nodew,  // nw [W], orw [W, TW], ttw [32 TW, W]
    uint32_t* __restrict__ tol_w,  // [U1, TW]
    const int32_t* __restrict__ done) {
  if (done != nullptr && *done) return;
  const int lane = threadIdx.x & 31;
  const int64_t n_tm = (int64_t)S * W, n_node = (int64_t)W * TW, n_tol = (int64_t)U1 * TW;
  const int64_t items = n_tm + n_node + n_tol;
  uint32_t* nw = nodew;
  uint32_t* orw = nodew + W;
  uint32_t* ttw = orw + (int64_t)W * TW;
  const int64_t warps = (int64_t)gridDim.x * (SETUP_NT / 32);
  for (int64_t it = (int64_t)blockIdx.x * (SETUP_NT / 32) + (threadIdx.x >> 5); it < items; it += warps) {
    if (it < n_tm) {  // whole warps take the same branch: `it` is the warp's
      const int s = (int)(it / W), w = (int)(it % W), n = 32 * w + lane;
      const bool ok = n < N && term_ok(sel_mask, sel_kind, node_labels, s, n, E, L);
      const uint32_t word = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) tmw[it] = word;
    } else if (it < n_tm + n_node) {
      const int64_t j = it - n_tm;
      const int w = (int)(j / TW), k = (int)(j % TW), n = 32 * w + lane;
      uint32_t tw = 0;  // this lane's node's taints 32k .. 32k + 31
      if (n < N)
        for (int b = 0; b < 32 && 32 * k + b < T; ++b) tw |= (uint32_t)(node_taint_ns[(int64_t)n * T + 32 * k + b] != 0) << b;
      if (k == 0) {
        const uint32_t v = __ballot_sync(0xffffffffu, n < N && node_valid[n]);
        if (lane == 0) nw[w] = v;
      }
      const uint32_t any = __reduce_or_sync(0xffffffffu, tw);
      if (lane == 0) orw[j] = any;
      uint32_t mine = 0;  // lane b keeps the word of taint 32k + b
      for (int b = 0; b < 32; ++b) {
        const uint32_t v = __ballot_sync(0xffffffffu, (tw >> b) & 1u);
        if (lane == b) mine = v;
      }
      ttw[(int64_t)(32 * k + lane) * W + w] = mine;
    } else {
      const int64_t j = it - n_tm - n_node;
      const int u = (int)(j / TW), k = (int)(j % TW), t = 32 * k + lane;
      const bool tol = t < T && pod_tol_ns[pod_row(r_u, u) * T + t] != 0;
      const uint32_t v = __ballot_sync(0xffffffffu, tol);
      if (lane == 0) tol_w[j] = v;
    }
  }
}

// a staged row: [0] flags (1 pod_valid, 2 has_sel), [1] the pin's local
// node id (-1 unset, -2 not among these nodes), [2, 2 + TT) its terms,
// [2 + TT, 2 + TT + TW) its toleration words
__global__ void __launch_bounds__(ROWS_NT) static_rows_kernel(
    const uint32_t* __restrict__ tmw, const uint32_t* __restrict__ nodew, const uint32_t* __restrict__ tol_w,
    const int32_t* __restrict__ pod_nodename,  // [P]
    const int32_t* __restrict__ pod_terms,     // [P, TT]
    const uint8_t* __restrict__ pod_has_sel,   // [P]
    const int64_t* __restrict__ r_u,           // [U1] or NULL
    const uint8_t* __restrict__ pod_valid,     // [P] or NULL
    int U1, int N, int W, int TW, int TT, int base, int RB,
    uint32_t* __restrict__ stat_u,   // [U1, W]
    uint32_t* __restrict__ elig_u,   // [U1, W] or NULL
    const int32_t* __restrict__ done) {
  if (done != nullptr && *done) return;
  extern __shared__ int32_t rows_sm[];
  const uint32_t* nw = nodew;
  const uint32_t* orw = nodew + W;
  const uint32_t* ttw = orw + (int64_t)W * TW;
  const int stride = 2 + TT + TW;
  const int n_tiles = (U1 + RB - 1) / RB;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int u0 = tile * RB, rows = min(RB, U1 - u0);
    __syncthreads();  // the previous tile's reads of the staged rows are done
    for (int i = threadIdx.x; i < rows * stride; i += ROWS_NT) {
      const int r = i / stride, f = i % stride;
      const int64_t p = pod_row(r_u, u0 + r);
      int32_t v;
      if (f == 0) {
        v = (pod_valid == nullptr || pod_valid[p] ? 1 : 0) | (pod_has_sel[p] ? 2 : 0);
      } else if (f == 1) {
        // the pin is a GLOBAL node id; a node shard's launch numbers its
        // nodes from its first id `base` (the JAX package's my_nodes)
        const int pin = pod_nodename[p];
        v = pin == -1 ? -1 : ((pin >= base && pin - base < N) ? pin - base : -2);
      } else if (f < 2 + TT) {
        v = pod_terms[p * TT + (f - 2)];
      } else {
        v = (int32_t)tol_w[(int64_t)(u0 + r) * TW + (f - 2 - TT)];
      }
      rows_sm[i] = v;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < rows * W; i += ROWS_NT) {
      const int r = i / W, w = i - r * W;
      const int32_t* row = rows_sm + r * stride;
      uint32_t sel = ~0u;
      if (row[0] & 2) {
        sel = 0u;
        for (int j = 0; j < TT; ++j) {
          const int s = row[2 + j];
          if (s >= 0) sel |= tmw[(int64_t)s * W + w];
        }
      }
      const uint32_t elig = nw[w] & sel;
      uint32_t word = 0u;
      if (row[0] & 1) {
        uint32_t bad = 0u;
        for (int k = 0; k < TW; ++k) {
          uint32_t m = orw[(int64_t)w * TW + k] & ~(uint32_t)row[2 + TT + k];
          while (m) {
            const int t = __ffs(m) - 1;
            m &= m - 1;
            bad |= ttw[(int64_t)(32 * k + t) * W + w];
          }
        }
        const int pin = row[1];
        const uint32_t pinw = pin == -1 ? ~0u : ((pin >= 0 && (pin >> 5) == w) ? 1u << (pin & 31) : 0u);
        word = elig & ~bad & pinw;
      }
      const int64_t o = (int64_t)(u0 + r) * W + w;
      stat_u[o] = word;
      if (elig_u != nullptr) elig_u[o] = elig;
    }
  }
}

// the packed static plane of U1 rows (classes or pods): the set-up launch,
// then the row launch; the scratch is tm [S, W], nodew [W (1 + 33 TW)] and
// tol_w [U1, TW] words (kernels.py static_scratch)
int static_plane(const void* node_valid, const void* node_taint_ns, const void* node_labels,
                 const void* pod_valid, const void* pod_tol_ns, const void* pod_nodename,
                 const void* pod_terms, const void* pod_has_sel, const void* sel_mask,
                 const void* sel_kind, const void* r_u, void* tm, void* taint_w, void* tol_w,
                 void* stat_u, void* elig_u, const void* done, int U1, int N, int T, int TT, int S,
                 int E, int L, int base, cudaStream_t st) {
  const int32_t* dn = static_cast<const int32_t*>(done);
  if (U1 <= 0 || N <= 0) return (int)cudaGetLastError();
  const int TW = T > 32 ? (T + 31) / 32 : 1;  // T == 0 packs to one zero word
  const int W = (N + 31) / 32;
  const int stride = 2 + TT + TW;
  int RB = MAX_RB;
  while (RB > 1 && RB * stride * 4 > ROW_SMEM) RB /= 2;
  if (RB * stride * 4 > ROW_SMEM) return (int)cudaErrorInvalidValue;
  int dev = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // few rows (the class planes): fewer rows a tile, so every block has one
  const int row_blocks = ROWS_PER_SM * nsm;
  while (RB > 1 && (U1 + RB - 1) / RB < row_blocks) RB /= 2;
  const int64_t items = (int64_t)S * W + (int64_t)W * TW + (int64_t)U1 * TW;
  const int64_t setup_blocks = (items + SETUP_NT / 32 - 1) / (SETUP_NT / 32);
  const int64_t setup_cap = (int64_t)SETUP_PER_SM * nsm;
  static_setup_kernel<<<(unsigned)(setup_blocks < setup_cap ? setup_blocks : setup_cap), SETUP_NT, 0, st>>>(
      static_cast<const uint8_t*>(node_valid), static_cast<const uint8_t*>(node_taint_ns),
      static_cast<const uint8_t*>(node_labels), static_cast<const uint8_t*>(pod_tol_ns),
      static_cast<const uint8_t*>(sel_mask), static_cast<const int32_t*>(sel_kind), static_cast<const int64_t*>(r_u),
      U1, N, W, T, TW, S, E, L, static_cast<uint32_t*>(tm), static_cast<uint32_t*>(taint_w),
      static_cast<uint32_t*>(tol_w), dn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (U1 + RB - 1) / RB;
  static_rows_kernel<<<(unsigned)(tiles < row_blocks ? tiles : row_blocks), ROWS_NT, (size_t)RB * stride * 4, st>>>(
      static_cast<const uint32_t*>(tm), static_cast<const uint32_t*>(taint_w), static_cast<const uint32_t*>(tol_w),
      static_cast<const int32_t*>(pod_nodename), static_cast<const int32_t*>(pod_terms),
      static_cast<const uint8_t*>(pod_has_sel), static_cast<const int64_t*>(r_u),
      static_cast<const uint8_t*>(pod_valid), U1, N, W, TW, TT, base, RB, static_cast<uint32_t*>(stat_u),
      static_cast<uint32_t*>(elig_u), dn);
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
                                      void* taint_w, void* tol_w, void* stat_u, void* elig_u, int U1,
                                      int N, int T, int TT, int S, int E, int L, int base, void* stream) {
  return static_plane(node_valid, node_taint_ns, node_labels, nullptr, pod_tol_ns, pod_nodename,
                      pod_terms, pod_has_sel, sel_mask, sel_kind, r_u, tm, taint_w, tol_w, stat_u, elig_u,
                      nullptr, U1, N, T, TT, S, E, L, base, reinterpret_cast<cudaStream_t>(stream));
}

// K7: every pod row, pod_valid included -> sfs [P, W]; eligs (or NULL) gets
// the packed nodesel & node_valid plane the rounds and full scans read;
// done (or NULL): a device word that makes every launch return at entry.
// K3 and K7 take `base`, the first global node id of the node block they
// see (0 on one device; a node shard's s * nl on the mesh, where they launch
// once per shard over its rows, parallel/sharded.py)
extern "C" int ktt_packed_static_rows(const void* node_valid, const void* node_taint_ns,
                                      const void* node_labels, const void* pod_valid,
                                      const void* pod_tol_ns, const void* pod_nodename,
                                      const void* pod_terms, const void* pod_has_sel,
                                      const void* sel_mask, const void* sel_kind, void* tm,
                                      void* taint_w, void* tol_w, void* sfs, void* eligs, const void* done,
                                      int P, int N, int T, int TT, int S, int E, int L, int base,
                                      void* stream) {
  return static_plane(node_valid, node_taint_ns, node_labels, pod_valid, pod_tol_ns, pod_nodename,
                      pod_terms, pod_has_sel, sel_mask, sel_kind, nullptr, tm, taint_w, tol_w, sfs, eligs,
                      done, P, N, T, TT, S, E, L, base, reinterpret_cast<cudaStream_t>(stream));
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
