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
//   ops/incremental.py:214 _patch_hoist (cols: a column list padded with
//   the sentinel N; entries outside [0, N) are skipped):
//   base_u[u, n] = fit_w * fit_score + bal_w * balanced of used[n] + req_u[u]
//   fit_u[u] bit n = fit_ok (subtraction form) of req_u[u] at node n.
//   Both modes are one launch over node-major tiles: a block owns UT = 256
//   nodes (a thread each) and a slice of the classes, the slices sized so
//   the grid is one wave of the blocks an SM holds
//   (occupancy.cuh; 6 at the north star).
//   Each is built for every strategy and for K = 1..4 scored resources
//   (and one for any K), so a kernel issues only its own strategy's
//   divisions and no guard for absent resources (score.cuh score_pre: the
//   same arithmetic in the same order).  Full mode (usage_full_kernel)
//   reads the tile's used and alloc rows once, coalesced, through shared
//   memory; each thread keeps its node's alloc - used in shared memory and
//   the node-only part of the score (score.cuh ScoreNode: the scored
//   allocatables as f32, the count of the present ones) and the scored
//   usage in registers for every class of the slice; the classes' request
//   rows and scored requests are staged in shared memory UCB at a time;
//   each class row's fit bits are one warp ballot and one store, and
//   base_u's stores coalesce along n.  Column mode (usage_patch_kernel)
//   writes a NEW generation in the same launch: each block copies its
//   tile of the resident base_in / fit_in for PCB classes at a time into
//   shared memory (cp.async) while it reads the whole column list
//   (SCAN_BATCH loads in flight a thread), marks and compacts its tile's
//   listed columns (a repeated column is one column; the list needs no
//   order), stages their node rows and scores the (class, column) pairs
//   over all its threads into the copies; then it stores the tile, and the
//   warp that owns a fit word writes it whole as (old & ~touched) | new,
//   the exact column assignment of the JAX package's
//   bitplane.assign_cols.  No atomics, no copy launch; the resident pair
//   is only read (the donation-aliasing rule).
//
// Bounds on an H100 at U1 = 101, N = 20480, R = 5: K3 writes 101 x 640
// words and reads KBs; K4's full mode reads 2 x N x R int32 and writes U1 x
// N f32 + U1 x W words (~9.4 MB, >= 2.8 us at 3.35 TB/s) and does ~28 f32
// operations per (class, node) at K = 2 (~58 M, >= 0.9 us at 67 TFLOP/s).
// The floor is the issue rate: a pair executes ~220 SASS instructions at
// K = 2, R = 5 (the fit test over R ~55; the score ~160, six IEEE
// divisions and a sqrtf, each a reciprocal and correction sequence with a
// slow-path check), ~15 us at 132 SMs x 128 instructions a clock at 1.755
// GHz.  Column mode moves the resident pair twice (read, write: ~17 MB,
// >= 5.1 us).
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "feasible.cuh"
#include "occupancy.cuh"
#include "score.cuh"

namespace {

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

// K4: UT nodes a tile, one a thread; full mode stages UCB classes' request
// rows at a time, column mode PCB (its scores of the listed columns sit in
// shared memory until the tile is copied)
constexpr int UT = 256;
constexpr int UCB = 32;
constexpr int PCB = 16;
constexpr int SCAN_BATCH = 8;  // column-list loads a thread keeps in flight
constexpr int SMAX_K = ktt::SCORE_MAX_K;

// a chunk of cb classes from uc: their request rows [cb, R] into rq and
// their scored requests [cb, SMAX_K] into rqk
__device__ __forceinline__ void stage_requests(const int32_t* __restrict__ req_u, const ktt::ScoreParams& sp, int R,
                                               int uc, int cb, int32_t* rq, int32_t* rqk) {
  for (int i = threadIdx.x; i < cb * R; i += UT) rq[i] = req_u[(int64_t)uc * R + i];
  for (int i = threadIdx.x; i < cb * SMAX_K; i += UT) {
    const int c = i / SMAX_K, k = i - c * SMAX_K;
    rqk[i] = k < sp.k ? req_u[(int64_t)(uc + c) * R + sp.idx[k]] : 0;
  }
}

// full mode: node-major.  STRAT / KT: the fit strategy and the number of
// scored resources (score.cuh; KT 0 reads sp.k).  Dynamic shared memory:
// the tile's used rows, its alloc rows ([UT * R] int32 each, node-major as
// they are read) and its alloc - used ([R][UT], one word a thread a
// resource).
template <int STRAT, int KT>
__global__ void __launch_bounds__(UT) usage_full_kernel(
    const int32_t* __restrict__ req_u,  // [U1, R]
    const int32_t* __restrict__ used,   // [N, R]
    const int32_t* __restrict__ alloc,  // [N, R]
    ktt::ScoreParams sp, int U1, int N, int W, int R, int cs,
    float* __restrict__ base_u,      // [U1, N]
    uint32_t* __restrict__ fit_u) {  // [U1, W]
  extern __shared__ int32_t node_sm[];
  __shared__ int32_t rq_sm[UCB * ktt::SCORE_MAX_R];
  __shared__ int32_t rqk_sm[UCB * SMAX_K];
  constexpr int KS = ktt::k_slots<KT>();
  const int kk = KT > 0 ? KT : sp.k;
  const int t = threadIdx.x;
  const int n0 = blockIdx.x * UT, n = n0 + t;
  const int nodes = min(UT, N - n0);
  const int64_t row0 = (int64_t)n0 * R;
  int32_t* avail = node_sm + 2 * UT * R;
  for (int i = t; i < nodes * R; i += UT) {
    node_sm[i] = used[row0 + i];
    node_sm[UT * R + i] = alloc[row0 + i];
  }
  __syncthreads();
  const bool live = t < nodes;
  // whole warps: a warp whose word is past W has no node below N
  const bool warp_live = n0 + (t & ~31) < N;
  int uk[KS];  // the scored resources' usage
  ktt::ScoreNode nd{};
#pragma unroll
  for (int k = 0; k < KS; ++k) uk[k] = 0;
  if (live) {
    const int32_t* un = node_sm + t * R;
    const int32_t* an = node_sm + UT * R + t * R;
    for (int r = 0; r < R; ++r) avail[r * UT + t] = ktt::wsub(an[r], un[r]);
    nd = ktt::score_node<KT>(sp, [&](int r) { return an[r]; });
#pragma unroll
    for (int k = 0; k < KS; ++k)
      if (k < kk) uk[k] = un[sp.idx[k]];
  }
  const int ua = blockIdx.y * cs, ub = min(U1, ua + cs);
  for (int uc = ua; uc < ub; uc += UCB) {
    const int cb = min(UCB, ub - uc);
    __syncthreads();  // the previous chunk's reads of the staged requests are done
    stage_requests(req_u, sp, R, uc, cb, rq_sm, rqk_sm);
    __syncthreads();
    if (!warp_live) continue;
    for (int c = 0; c < cb; ++c) {
      bool fit = false;
      if (live) {
        const int32_t* rq = rq_sm + c * R;
        fit = true;
#pragma unroll 4
        for (int r = 0; r < R; ++r) {
          const int q = rq[r];
          if (q != 0 && !(q <= avail[r * UT + t])) fit = false;
        }
        float fq[KS];
#pragma unroll
        for (int k = 0; k < KS; ++k) fq[k] = (k < kk) ? (float)ktt::wadd(uk[k], rqk_sm[c * SMAX_K + k]) : 0.0f;
        base_u[(int64_t)(uc + c) * N + n] = ktt::score_pre<STRAT, KT>(sp, nd, fq);
      }
      const uint32_t word = __ballot_sync(0xffffffffu, fit);
      if ((t & 31) == 0) fit_u[(int64_t)(uc + c) * W + (n >> 5)] = word;
    }
  }
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem));
}

// column mode: the new generation of the block's tile and class slice, the
// listed columns rescored.  The resident rows of each chunk of classes are
// copied into shared memory asynchronously (cp.async) while the block reads
// the list (SCAN_BATCH loads in flight a thread), stages the listed
// columns' node rows (dynamic shared memory, [UT][2 R] int32 at most) and
// scores them, which it then writes over the copies.
template <int STRAT, int KT>
__global__ void __launch_bounds__(UT) usage_patch_kernel(
    const int32_t* __restrict__ req_u,  // [U1, R]
    const int32_t* __restrict__ used,   // [N, R]
    const int32_t* __restrict__ alloc,  // [N, R]
    const int32_t* __restrict__ cols,   // [D]
    int D, ktt::ScoreParams sp, int U1, int N, int W, int R, int cs,
    const float* __restrict__ base_in,     // [U1, N], the resident generation
    const uint32_t* __restrict__ fit_in,   // [U1, W]
    float* __restrict__ base_u,            // [U1, N], the new one
    uint32_t* __restrict__ fit_u) {        // [U1, W]
  __shared__ int listed_sm[UT];  // node t of the tile is listed (1) or not (0)
  __shared__ int dcol[UT];       // the tile's listed columns (tile-local ids), ascending
  __shared__ int warp_cnt[UT / 32];
  __shared__ int32_t rq_sm[PCB * ktt::SCORE_MAX_R];
  __shared__ int32_t rqk_sm[PCB * SMAX_K];
  __shared__ float tile_sm[PCB][UT];           // the chunk's base_u rows of the tile
  __shared__ uint32_t word_sm[PCB][UT / 32];   // their resident fit words
  __shared__ uint8_t res_fit[PCB][UT];         // the listed columns' fit bits
  extern __shared__ int32_t rows_sm[];         // the listed columns' node rows
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n0 = blockIdx.x * UT, n = n0 + t;
  const int end = min(n0 + UT, N);
  const int ua = blockIdx.y * cs, ub = min(U1, ua + cs);
  auto fetch = [&](int uc, int cb) {
    if (n < N)
      for (int c = 0; c < cb; ++c) cp_async4(&tile_sm[c][t], base_in + (int64_t)(uc + c) * N + n);
    if (t < cb * (UT / 32)) {
      const int c = t / (UT / 32), j = t - c * (UT / 32), w = (n0 >> 5) + j;
      if (w < W) cp_async4(&word_sm[c][j], fit_in + (int64_t)(uc + c) * W + w);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (ua < ub) {  // the first chunk's rows and requests load while the list is read
    fetch(ua, min(PCB, ub - ua));
    stage_requests(req_u, sp, R, ua, min(PCB, ub - ua), rq_sm, rqk_sm);
  }
  listed_sm[t] = 0;
  __syncthreads();
  for (int i0 = 0; i0 < D; i0 += SCAN_BATCH * UT) {  // the list's loads in flight a batch at a time
    int c[SCAN_BATCH];
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k) c[k] = i0 + k * UT + t < D ? __ldg(cols + i0 + k * UT + t) : -1;
#pragma unroll
    for (int k = 0; k < SCAN_BATCH; ++k)
      if (c[k] >= n0 && c[k] < end) listed_sm[c[k] - n0] = 1;  // a repeated column marks it again
  }
  __syncthreads();
  const bool listed = listed_sm[t] != 0;
  const uint32_t mine = __ballot_sync(0xffffffffu, listed);
  if (lane == 0) warp_cnt[warp] = __popc(mine);
  __syncthreads();
  int before = 0, nlisted = 0;
#pragma unroll
  for (int j = 0; j < UT / 32; ++j) {
    before += j < warp ? warp_cnt[j] : 0;
    nlisted += warp_cnt[j];
  }
  const int my = listed ? before + __popc(mine & ((1u << lane) - 1u)) : -1;
  if (listed) dcol[my] = t;
  __syncthreads();
  // the listed columns' used and alloc rows, [nlisted][2 R]
  for (int k = t; k < nlisted * R; k += UT) {
    const int i = k / R, r = k - i * R;
    const int64_t g = (int64_t)(n0 + dcol[i]) * R + r;
    rows_sm[i * 2 * R + r] = __ldg(used + g);
    rows_sm[i * 2 * R + R + r] = __ldg(alloc + g);
  }
  const bool warp_live = n0 + (t & ~31) < N;
  const uint32_t touched = mine;  // listed columns are below N
  for (int uc = ua; uc < ub; uc += PCB) {
    const int cb = min(PCB, ub - uc);
    __syncthreads();  // the listed rows are staged; the previous chunk's reads are done
    if (uc != ua) {
      fetch(uc, cb);
      stage_requests(req_u, sp, R, uc, cb, rq_sm, rqk_sm);
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    for (int p = t; p < cb * nlisted; p += UT) {
      const int c = p / nlisted, i = p - c * nlisted;
      const int32_t* un = rows_sm + i * 2 * R;
      const int32_t* an = un + R;
      const int32_t* rq = rq_sm + c * R;
      res_fit[c][i] = ktt::fit_ok(R, [&](int r) { return rq[r]; }, [&](int r) { return un[r]; },
                                  [&](int r) { return an[r]; });
      tile_sm[c][dcol[i]] = ktt::score_flat<STRAT, KT>(sp, [&](int r) { return ktt::wadd(un[r], rq[r]); },
                                                        [&](int r) { return an[r]; });
    }
    __syncthreads();
    if (!warp_live) continue;
    for (int c = 0; c < cb; ++c) {
      const int64_t u = uc + c;
      if (n < N) base_u[u * N + n] = tile_sm[c][t];
      const uint32_t fresh = __ballot_sync(0xffffffffu, my >= 0 && res_fit[c][my]);
      if (lane == 0) fit_u[u * W + (n >> 5)] = (word_sm[c][warp] & ~touched) | fresh;
    }
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

namespace {

struct UsageArgs {
  const int32_t* req_u;
  const int32_t* used;
  const int32_t* alloc;
  const int32_t* cols;
  int D;
  ktt::ScoreParams sp;
  int U1, N, W, R, dev, nsm;
  const float* base_in;
  const uint32_t* fit_in;
  float* base_u;
  uint32_t* fit_u;
};

// one wave: the node tiles times as many class slices as the card holds
// blocks of this kernel beside them
template <class Kernel>
cudaError_t usage_grid(ktt::Occupancy& memo, Kernel kernel, size_t smem, const UsageArgs& a, dim3* grid, int* cs) {
  int per_sm = 0;
  const cudaError_t err = ktt::blocks_per_sm(memo, kernel, a.dev, UT, smem, &per_sm);
  if (err != cudaSuccess) return err;
  const int tiles = (a.N + UT - 1) / UT;
  int slices = per_sm * a.nsm / tiles;
  if (slices > a.U1) slices = a.U1;
  if (slices < 1) slices = 1;
  *cs = (a.U1 + slices - 1) / slices;
  *grid = dim3(tiles, (a.U1 + *cs - 1) / *cs);
  return cudaSuccess;
}

// K4's one launch for strategy STRAT and KT scored resources (0: any)
template <int STRAT, int KT>
cudaError_t launch_usage(const UsageArgs& a, cudaStream_t st) {
  static ktt::Occupancy patch_memo, full_memo;
  dim3 grid;
  int cs = 0;
  cudaError_t err;
  if (a.cols != nullptr) {
    const size_t rows = (size_t)2 * UT * a.R * sizeof(int32_t);
    if (a.R > 8) {  // past 16 KB of listed rows: above the 48 KB default with the static arrays
      err = cudaFuncSetAttribute(usage_patch_kernel<STRAT, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows);
      if (err != cudaSuccess) return err;
    }
    err = usage_grid(patch_memo, usage_patch_kernel<STRAT, KT>, rows, a, &grid, &cs);
    if (err != cudaSuccess) return err;
    usage_patch_kernel<STRAT, KT><<<grid, UT, rows, st>>>(a.req_u, a.used, a.alloc, a.cols, a.D, a.sp, a.U1, a.N,
                                                          a.W, a.R, cs, a.base_in, a.fit_in, a.base_u, a.fit_u);
    return cudaGetLastError();
  }
  const size_t smem = (size_t)3 * UT * a.R * sizeof(int32_t);
  if (smem > 48 * 1024) {  // R > 16: up to 96 KB at SCORE_MAX_R = 32
    err = cudaFuncSetAttribute(usage_full_kernel<STRAT, KT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  err = usage_grid(full_memo, usage_full_kernel<STRAT, KT>, smem, a, &grid, &cs);
  if (err != cudaSuccess) return err;
  usage_full_kernel<STRAT, KT><<<grid, UT, smem, st>>>(a.req_u, a.used, a.alloc, a.sp, a.U1, a.N, a.W, a.R, cs,
                                                       a.base_u, a.fit_u);
  return cudaGetLastError();
}

// the kernels of strategy STRAT: one a small K, one for any K
template <int STRAT>
cudaError_t launch_usage_k(const UsageArgs& a, cudaStream_t st) {
  switch (a.sp.k) {
    case 1: return launch_usage<STRAT, 1>(a, st);
    case 2: return launch_usage<STRAT, 2>(a, st);
    case 3: return launch_usage<STRAT, 3>(a, st);
    case 4: return launch_usage<STRAT, 4>(a, st);
    default: return launch_usage<STRAT, 0>(a, st);
  }
}

}  // namespace

// ip / fp: the score parameters (score.cuh make_score_params), host memory.
// cols == NULL: full mode into base_u / fit_u (base_in, fit_in unused);
// else column mode: base_u / fit_u get the resident base_in / fit_in with
// the D listed columns rescored (all four buffers [U1, N] f32 / [U1, W]
// words, the outputs not the inputs).
extern "C" int ktt_class_usage_hoist(const void* req_u, const void* used, const void* alloc,
                                     const void* cols, int D, const int* ip, const float* fp,
                                     const void* base_in, const void* fit_in, void* base_u, void* fit_u,
                                     int U1, int N, int R, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const ktt::ScoreParams sp = ktt::make_score_params(ip, fp);
  if (!ktt::score_params_ok(sp, R)) return (int)cudaErrorInvalidValue;
  if (cols != nullptr && (base_in == nullptr || fit_in == nullptr || D < 0)) return (int)cudaErrorInvalidValue;
  if (U1 <= 0 || N <= 0) return (int)cudaGetLastError();
  int dev = 0, nsm = 0;
  const cudaError_t err = ktt::device_sms(&dev, &nsm);
  if (err != cudaSuccess) return (int)err;
  const int W = (N + 31) / 32;
  const UsageArgs args{static_cast<const int32_t*>(req_u), static_cast<const int32_t*>(used),
                       static_cast<const int32_t*>(alloc), static_cast<const int32_t*>(cols), D, sp, U1, N, W, R, dev, nsm,
                       static_cast<const float*>(base_in), static_cast<const uint32_t*>(fit_in),
                       static_cast<float*>(base_u), static_cast<uint32_t*>(fit_u)};
  switch (sp.strategy) {
    case ktt::LEAST_ALLOCATED: return (int)launch_usage_k<ktt::LEAST_ALLOCATED>(args, st);
    case ktt::MOST_ALLOCATED: return (int)launch_usage_k<ktt::MOST_ALLOCATED>(args, st);
    default: return (int)launch_usage_k<ktt::REQUESTED_TO_CAPACITY_RATIO>(args, st);
  }
}
