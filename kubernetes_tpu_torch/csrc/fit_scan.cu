// Fit-only sequential commit scan: for each pod p in activeQ (array) order,
//   feasible[n] = sf[p, n] & (req == 0 | req <= alloc[n] - used[n]) over R
//   total[n]    = fit_w * fit_score(used[n] + req, alloc[n])
//               + bal_w * balanced_allocation(used[n] + req, alloc[n])
//   choice      = lowest n with the highest total among feasible nodes
//                 (-1 when none is feasible or the pod is not valid)
//   used[choice] += req
//
// Replaces the JAX package's ops/assign.py:181 schedule_scan (the step at
// :258 and commit at :334) with every optional stage off, inlining
// ops/filters.py:126 fit_ok and ops/scores.py:110-228 (LeastAllocated,
// MostAllocated, RequestedToCapacityRatio with interp_shape_f32, and
// BalancedAllocation).  The f32 arithmetic follows ops/scores.py op for op
// (the mean over the K scored resources is the sequential sum times
// f32(1/K), as XLA lowers the JAX package's mean); the build passes
// -fmad=false so nvcc contracts no a*b+c into an FMA, and keeps IEEE
// division and sqrtf, so totals are bitwise those of the plain versions and
// ties (hence choices) do not move.
//
// Design: ONE thread-block cluster of kc blocks of 1024 threads walks all P
// pods in order (each pod depends on the previous pod's commit), kc the
// widest cluster the card schedules, up to 16 (a non-portable size;
// ops/kernels.py SCAN_CLUSTER caps it), and no more blocks than 16-node
// runs of the node axis.  Block q owns the nodes [lo(q), lo(q + 1)),
// lo(q) = 16 * floor(q * (N / 16) / kc): near-equal runs of whole 16-node
// units, so the wrapper pads N to 16 only.  Per block:
//   - its run's allocatable and running usage stay in shared memory for
//     the whole scan ([R, run] each, the transposed layout; 51 KB at the
//     north star's kc = 16, R = 5), written back once at the end; where
//     they do not fit (a wide R on few blocks) they stay in the global
//     [R, N] arrays, the block's own columns only;
//   - its slice of pod p+1's sf row streams into shared memory (cp.async,
//     double buffered) while pod p is scored;
//   - one node a thread (nodes lo + tid, lo + tid + 1024, ...): the fit
//     test against the running usage, then for a node that passes the
//     total of fit_total, a template on the strategy and K (one kernel a
//     (strategy, K) pair: no run-time branch on the strategy, the K scored
//     resources in registers); each thread keeps its best (score desc,
//     position asc; its nodes ascend), a warp shuffle tree and one
//     shared-memory pass reduce the block's key;
//   - the key goes to the block's exchange slot (shared memory, two slots
//     by the parity of the cluster barriers passed); after ONE cluster
//     barrier warp 0 of every block reads the kc slots through distributed
//     shared memory (map_shared_rank) and takes their best: the keys are
//     (score, axis position), so the best is the whole row's "highest
//     score, lowest index" whatever the order it is folded in; the block whose run
//     holds the choice adds the request to its usage.  A slot is rewritten
//     two barriers later, after every block has passed the barrier between,
//     so no block overwrites a slot another still reads.
// Two block barriers and one cluster barrier a pod.  Measured against it
// on the card (bench/perpod_scan.py): every warp reading the kc slots with
// no block barrier after (512 reads of each block's slot a pod) took 1.8x
// the time; a warp a segment of the run, each queueing its feasible nodes
// so no lane idles in the scoring, gained ~4% of the scoring and lost more
// in the per-pod floor.
// An invalid pod (padding: its sf row is all 0) is decided alike in every
// block without a barrier.  The launch copies its start usage `used_in`
// [n_real, R] into the running state itself (zero in the padding columns)
// and zeroes n_scored before its first cluster barrier; each warp adds its
// scored pairs once at the end.  So the gang fixpoint's gated mode
// (ops/gang.py), which passes `done` (a device word: every block returns at
// entry once it is set, before any barrier) and the same buffers to every
// iteration, leaves the last real launch's usage and counts in place.  The
// launch is refused (an error, no other kernel) when the card schedules no
// cluster.  The first design, one block on one SM with the strategy a
// run-time branch, spent ~20.7 us a pod at the north star issuing ~200
// instructions a node on one SM's four schedulers.

// SHARD MODE (ktt_fit_scan_shard; the JAX package's schedule_scan under
// shard_map with every optional stage off, ops/assign.py:181 with
// axis_name, its _rmax then _rmin at :320-326): the same kernel, one
// cluster, over the shard-major sequence of every shard's columns, each
// shard's nl nodes padded to Np (a multiple of 16; a padding column has no
// sf bit, so it is never chosen).  Block q's run is cut from that sequence
// as above, so it may span shards or hold part of one: its sf pieces
// stream from each shard's own rows (each thread's first piece found once
// a launch) and its start usage comes from each shard's used_in, a node
// read through its shard's pointers at its local column; the allocatable
// and the usage are [R, S * Np] on the axis (shard s's columns a block the
// wrapper lays out), so a run's state stays resident as on one device and
// its columns are written back in place.  The keys
// carry the axis position s * Np + j, which orders the real nodes as their
// global ids s * nl + j do, so the cluster's fold picks "highest score,
// lowest global id", the JAX pmax then pmin; the choice is written as the
// global id.  The first shard mode, a cooperative grid of one block a
// shard joined by a grid barrier and a global exchange every pod, ran the
// north star on 4 shards on 4 SMs at 2.4x the one-device cluster's time.
// The gated mode is refused in shard mode.
//
// Bounds on an H100: the bytes are sf read once (P*N, 1.05 GB at the
// 50k x 20k shape) plus the small [N, R] / [P, R] arrays, >= 0.31 ms at
// 3.35 TB/s; the dependency floor is P sequential cluster-wide reductions
// (the same launch with no feasible node).  The kernel also counts the
// (pod, node) pairs it scored (n_scored) so the caller can state the f32
// operation bound of this run's data.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;
constexpr int MAX_SHARDS = 8;
constexpr int MAX_R = 32;
constexpr int MAX_K = 8;
constexpr int MAX_SHAPE = 16;
constexpr int MAX_KC = 16;  // blocks per cluster: the widest an H100 schedules
constexpr int UNIT = 16;    // nodes per unit of a block's run (cp.async moves 16 sf bytes)
// dynamic shared memory a block may take beside its static buffers
constexpr size_t SMEM_CAP = 232448 - 2048;

enum Strategy { LEAST_ALLOCATED = 0, MOST_ALLOCATED = 1, REQUESTED_TO_CAPACITY_RATIO = 2 };

struct Params {
  uint32_t score_mask;  // bit r: resource r is one of the K scored ones
  float inv_k;  // f32(1/K)
  int n_shape;
  int strategy;
  float fit_w;
  float bal_w;
};

__device__ __forceinline__ bool better(float s, int i, float s2, int i2) {
  return s > s2 || (s == s2 && i < i2);
}

// ops/scores.py interp_shape_f32: descending segments, the first match wins
__device__ __forceinline__ float interp_shape(float util, const float* xs, const float* ys, int n) {
  float out = ys[n - 1];
  for (int i = n - 1; i > 0; --i) {
    float t = (util - xs[i - 1]) / (xs[i] - xs[i - 1]);
    float seg = ys[i - 1] + t * (ys[i] - ys[i - 1]);
    if (util <= xs[i]) out = seg;
  }
  if (util <= xs[0]) out = ys[0];
  return out;
}

// fit_w * fit_score + bal_w * balanced_allocation of a node whose scored
// resources' allocatable are al[k] and usage plus the pod's request uq[k]
// (a node that passed fit, so the sum cannot wrap), strategy S
template <int S, int K>
__device__ __forceinline__ float fit_total(const int (&al)[K], const int (&uq)[K], const float* s_xs,
                                           const float* s_ys, const Params& prm) {
  float fa[K], fq[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    fa[k] = (float)al[k];
    fq[k] = (float)uq[k];
  }
  float fit = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float a = fa[k], q = fq[k];
    float x;
    if constexpr (S == LEAST_ALLOCATED) {
      x = (a > 0.0f) ? fmaxf(0.0f, (a - q) * 100.0f / a) : 0.0f;
    } else if constexpr (S == MOST_ALLOCATED) {
      x = (a > 0.0f && q <= a) ? q * 100.0f / a : 0.0f;
    } else {
      const float util = (a > 0.0f) ? q * 100.0f / a : 100.0f;
      x = interp_shape(util, s_xs, s_ys, prm.n_shape) * 10.0f;
    }
    fit = (k == 0) ? x : fit + x;
  }
  fit = fit * prm.inv_k;
  float fr[K];
  float fsum = 0.0f;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool present = fa[k] > 0.0f;
    fr[k] = present ? fminf(1.0f, fq[k] / fa[k]) : 0.0f;
    fsum = (k == 0) ? fr[k] : fsum + fr[k];
    cnt += present ? 1 : 0;
  }
  const float cntf = (float)(cnt > 1 ? cnt : 1);
  const float mean = fsum / cntf;
  float var = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float d = fr[k] - mean;
    const float sq = (fa[k] > 0.0f) ? d * d : 0.0f;
    var = (k == 0) ? sq : var + sq;
  }
  var = var / cntf;
  const float bal = (1.0f - sqrtf(var)) * 100.0f;
  return prm.fit_w * fit + prm.bal_w * bal;
}

// The node axis: S shards of Np columns (Np a multiple of UNIT), shard s
// the positions [s * Np, (s + 1) * Np), of which the first nl are its nodes
// (global ids s * nl + j; the rest are padding, whose sf bit is never set).
// One device: S = 1, Np = N, nl = the real node count.
struct Axis {
  int S, nl, Np;
};

// one node shard's own arrays (one device: the whole axis)
struct FitShard {
  const uint8_t* sf;       // [P, Np] its static rows
  const int32_t* used_in;  // [nl, R] its start usage
};

struct FitShards {
  FitShard sh[MAX_SHARDS];
};

// the shard of axis position g
__device__ __forceinline__ int shard_of(int g, const Axis& ax) { return ax.S > 1 ? g / ax.Np : 0; }

// the global node id of axis position g (g holds a node, not padding)
__device__ __forceinline__ int global_id(int g, const Axis& ax) {
  const int s = shard_of(g, ax);
  return s * ax.nl + (g - s * ax.Np);
}

// the first position of block q's run: whole UNIT-node units, near-equal
// (N a multiple of UNIT)
__host__ __device__ __forceinline__ int run_lo(int q, int kc, int N) {
  return UNIT * (int)((int64_t)q * (N / UNIT) / kc);
}

// the longest run of a cluster of kc blocks
inline int run_max(int kc, int N) { return UNIT * ((N / UNIT + kc - 1) / kc); }

// row 0's byte at run position i (a multiple of 16), in its shard's own sf
// rows: a 16-byte piece never straddles two shards, Np being a multiple of 16
__device__ __forceinline__ const uint8_t* sf_piece(const FitShard* sh, const Axis& ax, int lo, int i) {
  const int g = lo + i, s = shard_of(g, ax);
  return sh[s].sf + (g - s * ax.Np);
}

// cp.async of sf row `row` at the `ns` positions from lo into `dst` (lo and
// ns multiples of 16); src0: this thread's first piece in row 0 (NULL past
// the run), worked out once a launch, so a run of at most NT pieces costs
// no shard lookup a pod
__device__ __forceinline__ void prefetch_run(uint8_t* dst, const uint8_t* src0, const FitShard* sh,
                                             const Axis& ax, int row, int lo, int ns) {
  const int64_t off = (int64_t)row * ax.Np;
  const int i0 = threadIdx.x * 16;
  if (src0 != nullptr) __pipeline_memcpy_async(dst + i0, src0 + off, 16);
  for (int i = i0 + NT * 16; i < ns; i += NT * 16) __pipeline_memcpy_async(dst + i, sf_piece(sh, ax, lo, i) + off, 16);
  __pipeline_commit();
}

// a block's best (score, axis position), its exchange slot's content
struct Key {
  float v;
  int n;
};

__device__ __forceinline__ void warp_best(float& v, int& n) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int on = __shfl_xor_sync(0xffffffffu, n, off);
    if (better(ov, on, v, n)) {
      v = ov;
      n = on;
    }
  }
}

// The scan: one cluster of kc blocks, block q on its run of the node axis
// (the design above), one device or shard mode alike; `resident`: the
// run's allocatable and usage live in shared memory (else in alloc_t /
// used_t, the run's columns)
template <int ST, int K>
__global__ void __launch_bounds__(NT) fit_scan_kernel(
    FitShards tab, Axis ax,
    const int32_t* __restrict__ pod_req,   // [P, R]
    const uint8_t* __restrict__ pod_valid,  // [P]
    const int32_t* __restrict__ alloc_t,   // [R, N] on the axis
    int32_t* used_t,                       // [R, N] on the axis, the final usage
    const int32_t* __restrict__ score_idx,  // [K]
    const float* __restrict__ shape_xy,    // [2 * n_shape]: xs then ys
    Params prm, int P, int R,
    int32_t* __restrict__ choices,  // [P] global node ids
    unsigned long long* __restrict__ n_scored,
    const int32_t* __restrict__ done,  // or NULL
    int resident) {
  if (done != nullptr && *done) return;  // every thread of every block reads the same word
  cg::cluster_group cl = cg::this_cluster();
  const int kc = (int)cl.num_blocks(), q = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = ax.S * ax.Np;
  const int lo = run_lo(q, kc, N), ns = run_lo(q + 1, kc, N) - lo;
  extern __shared__ __align__(16) uint8_t dyn[];  // [2][ns] sf bytes; resident: alloc, used [R][ns]
  __shared__ FitShard s_sh[MAX_SHARDS];
  __shared__ int s_req[2][MAX_R];  // pods p, p+1
  __shared__ int s_valid[2];
  __shared__ float s_xs[MAX_SHAPE];
  __shared__ float s_ys[MAX_SHAPE];
  __shared__ float s_bv[NT / 32];
  __shared__ int s_bn[NT / 32];
  __shared__ Key slot[2];  // the exchange, by barrier parity
  uint8_t* rows = dyn;
  int* al;
  int* us;
  int ld;
  if (resident) {
    al = reinterpret_cast<int*>(dyn + 2 * ns);
    us = al + R * ns;
    ld = ns;
  } else {
    al = const_cast<int*>(alloc_t) + lo;
    us = used_t + lo;
    ld = N;
  }
#pragma unroll
  for (int s = 0; s < MAX_SHARDS; ++s)  // static indices: a dynamic one copies the table to local memory
    if (tid == s && s < ax.S) s_sh[s] = tab.sh[s];
  __syncthreads();
  const uint8_t* src0 = tid * 16 < ns ? sf_piece(s_sh, ax, lo, tid * 16) : nullptr;
  for (int i = tid; i < R * ns; i += NT) {  // the start state of the run, each node's from its shard
    const int r = i / ns, j = i - r * ns, g = lo + j, s = shard_of(g, ax), c = g - s * ax.Np;
    us[r * ld + j] = c < ax.nl ? s_sh[s].used_in[(int64_t)c * R + r] : 0;
    if (resident) al[r * ld + j] = alloc_t[(int64_t)r * N + g];
  }
  if (q == 0 && tid == 0) *n_scored = 0;
  if (tid < prm.n_shape) {
    s_xs[tid] = shape_xy[tid];
    s_ys[tid] = shape_xy[prm.n_shape + tid];
  }
  int sidx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) sidx[k] = score_idx[k];
  unsigned long long scored = 0;
  if (P > 0) {
    prefetch_run(rows, src0, s_sh, ax, 0, lo, ns);
    if (tid < R) s_req[0][tid] = pod_req[tid];
    if (tid == 0) s_valid[0] = pod_valid[0];
  }
  // n_scored is zeroed and every block of the cluster runs (its slots are
  // readable) before any block goes on
  cl.sync();
  int nb = 0;  // cluster barriers passed in the pod loop
  for (int p = 0; p < P; ++p) {
    const uint8_t* cur = rows + (p & 1) * ns;
    // the other buffer was last read in pod p-1, before its block barrier
    if (p + 1 < P) {
      prefetch_run(rows + ((p + 1) & 1) * ns, src0, s_sh, ax, p + 1, lo, ns);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);  // this thread's part of row p has landed
    __syncthreads();  // row p, request p and the last commit visible
    const int* req = s_req[p & 1];
    const int valid = s_valid[p & 1];
    // pod p+1's request, by the warp with the fewest nodes: its buffer was
    // last read by pod p-1's commit, before the barrier above
    if (p + 1 < P && warp == NT / 32 - 1) {
      if (lane < R) s_req[(p + 1) & 1][lane] = pod_req[(int64_t)(p + 1) * R + lane];
      if (lane == 31) s_valid[(p + 1) & 1] = pod_valid[p + 1];
    }
    if (!valid) {  // alike in every block: no exchange
      if (q == 0 && tid == 0) choices[p] = -1;
      continue;
    }
    int rqk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) rqk[k] = req[sidx[k]];
    float best = -INFINITY;
    int best_n = INT32_MAX;
    for (int j = tid; j < ns; j += NT) {
      if (!cur[j]) continue;
      int ak[K], uq[K];
      bool ok = true;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int a = al[sidx[k] * ld + j], u = us[sidx[k] * ld + j];
        if (rqk[k] != 0) ok &= rqk[k] <= a - u;  // a resource the pod does not request never blocks
        ak[k] = a;
        uq[k] = u + rqk[k];
      }
      for (int r = 0; r < R; ++r) {  // the requested resources not scored
        const int rq = req[r];
        if (rq == 0 || ((prm.score_mask >> r) & 1u)) continue;
        ok &= rq <= al[r * ld + j] - us[r * ld + j];
      }
      if (!ok) continue;
      ++scored;
      const float total = fit_total<ST, K>(ak, uq, s_xs, s_ys, prm);
      if (total > best) {  // positions ascend per thread: keeps the lowest
        best = total;
        best_n = lo + j;
      }
    }
    warp_best(best, best_n);
    if (lane == 0) {
      s_bv[warp] = best;
      s_bn[warp] = best_n;
    }
    __syncthreads();
    if (warp == 0) {
      best = s_bv[lane];
      best_n = s_bn[lane];
      warp_best(best, best_n);
      if (lane == 0) slot[nb & 1] = Key{best, best_n};
    }
    cl.sync();
    if (warp == 0) {  // the kc blocks' keys (warp 0 alone reads them), then the owner's commit
      Key k{-INFINITY, INT32_MAX};
      if (lane < kc) k = *cl.map_shared_rank(&slot[nb & 1], lane);
      warp_best(k.v, k.n);
      const int choice = k.v > -INFINITY ? k.n : -1;  // an axis position
      if (q == 0 && lane == 0) choices[p] = choice >= 0 ? global_id(choice, ax) : -1;
      if (choice >= lo && choice < lo + ns)
        for (int r = lane; r < R; r += 32) us[r * ld + (choice - lo)] += req[r];
    }
    ++nb;
  }
  for (int off = 16; off > 0; off >>= 1) scored += __shfl_down_sync(0xffffffffu, scored, off);
  if (lane == 0 && scored) atomicAdd(n_scored, scored);
  if (resident) {
    __syncthreads();  // the last commit
    for (int i = tid; i < R * ns; i += NT) {
      const int r = i / ns, j = i - r * ns;
      used_t[(int64_t)r * N + lo + j] = us[r * ns + j];
    }
  }
  cl.sync();  // no block leaves while another may read its slots
}

// the launch's cluster, per kernel: asked of the runtime again only when
// the device, N, R or the cap changes (each query costs host time)
struct ClusterChoice {
  int dev = -1, N = 0, R = 0, max_kc = 0;
  int kc = 0, resident = 0;
  size_t smem = 0;
};

template <int ST, int K>
cudaError_t launch(const FitShards& tab, const Axis& ax, const void* pod_req, const void* pod_valid,
                   const void* alloc_t, void* used_t, const void* score_idx, const void* shape_xy, const Params& prm,
                   int P, int R, void* choices, void* n_scored, const void* done, int max_kc, int* kc_out,
                   cudaStream_t st) {
  static ClusterChoice memo;
  auto kernel = fit_scan_kernel<ST, K>;
  const int N = ax.S * ax.Np;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (memo.dev != dev || memo.N != N || memo.R != R || memo.max_kc != max_kc) {
    ClusterChoice c;
    for (int k = max_kc < N / UNIT ? max_kc : N / UNIT; k >= 1 && c.kc == 0; --k) {
      const size_t rows = 2 * (size_t)run_max(k, N), state = 8 * (size_t)R * run_max(k, N);
      const int res = rows + state <= SMEM_CAP;
      const size_t smem = res ? rows + state : rows;
      if (smem <= SMEM_CAP && ktt::cluster_fits(kernel, k, NT, smem)) {
        c.kc = k;
        c.resident = res;
        c.smem = smem;
      }
    }
    if (c.kc == 0) return cudaErrorInvalidConfiguration;  // refused: the card schedules no such cluster
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
    if (err != cudaSuccess) return err;
    c.dev = dev;
    c.N = N;
    c.R = R;
    c.max_kc = max_kc;
    memo = c;
  }
  if (kc_out != nullptr) *kc_out = memo.kc;
  return ktt::launch_cluster(kernel, memo.kc, NT, memo.smem, st, tab, ax, static_cast<const int32_t*>(pod_req),
                             static_cast<const uint8_t*>(pod_valid), static_cast<const int32_t*>(alloc_t),
                             static_cast<int32_t*>(used_t), static_cast<const int32_t*>(score_idx),
                             static_cast<const float*>(shape_xy), prm, P, R, static_cast<int32_t*>(choices),
                             static_cast<unsigned long long*>(n_scored), static_cast<const int32_t*>(done),
                             memo.resident);
}

// the limits both entries check -> 0, or cudaErrorInvalidValue
int bad_args(int R, int K, int n_shape, int strategy, int P, int max_kc) {
  return (R < 1 || R > MAX_R || K < 1 || K > MAX_K || n_shape < 1 || n_shape > MAX_SHAPE || P < 0 || max_kc < 1 ||
          max_kc > MAX_KC || strategy < LEAST_ALLOCATED || strategy > REQUESTED_TO_CAPACITY_RATIO)
             ? (int)cudaErrorInvalidValue
             : 0;
}

// the launch of the (strategy, K) pair's kernel
int launch_any(const FitShards& tab, const Axis& ax, const void* pod_req, const void* pod_valid,
               const void* alloc_t, void* used_t, const void* score_idx, int K, unsigned score_mask,
               const void* shape_xy, int n_shape, int strategy, float fit_w, float bal_w, int P, int R, void* choices,
               void* n_scored, const void* done, int max_kc, int* kc_out, cudaStream_t st) {
  const Params prm{score_mask, 1.0f / (float)K, n_shape, strategy, fit_w, bal_w};
  switch (strategy * 16 + K) {
#define KTT_CASE(s, k)                                                                                             \
  case s * 16 + k:                                                                                                 \
    return (int)launch<s, k>(tab, ax, pod_req, pod_valid, alloc_t, used_t, score_idx, shape_xy, prm, P, R, choices, \
                             n_scored, done, max_kc, kc_out, st);
#define KTT_CASES(s) \
  KTT_CASE(s, 1) KTT_CASE(s, 2) KTT_CASE(s, 3) KTT_CASE(s, 4) KTT_CASE(s, 5) KTT_CASE(s, 6) KTT_CASE(s, 7) KTT_CASE(s, 8)
    KTT_CASES(0) KTT_CASES(1) KTT_CASES(2)
#undef KTT_CASES
#undef KTT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// score_idx is on the device; score_mask holds the same resource ids as
// bits, for the kernel's fit test; used_in: the start usage [n_real, R];
// done (or NULL): the gate above; max_kc: the widest cluster to take
// (1..16); kc_out (host, or NULL): the cluster width launched
extern "C" int ktt_fit_scan(const void* sf, const void* pod_req, const void* pod_valid,
                            const void* alloc_t, void* used_t, const void* score_idx, int K,
                            unsigned score_mask, const void* shape_xy, int n_shape, int strategy,
                            float fit_w, float bal_w, int P, int N, int R, void* choices,
                            void* n_scored, const void* used_in, int n_real, const void* done,
                            int max_kc, int* kc_out, void* stream) {
  const int bad = bad_args(R, K, n_shape, strategy, P, max_kc);
  if (bad || N % UNIT != 0 || N < UNIT || n_real > N || used_in == nullptr) return bad ? bad : (int)cudaErrorInvalidValue;
  FitShards tab{};
  tab.sh[0] = FitShard{static_cast<const uint8_t*>(sf), static_cast<const int32_t*>(used_in)};
  return launch_any(tab, Axis{1, n_real, N}, pod_req, pod_valid, alloc_t, used_t, score_idx, K, score_mask, shape_xy,
                    n_shape, strategy, fit_w, bal_w, P, R, choices, n_scored, done, max_kc, kc_out,
                    reinterpret_cast<cudaStream_t>(stream));
}

// shard mode: the same kernel over every shard's columns; shard_ptrs holds S
// rows of (sf [P, Np], used_in [nl, R]); shard s owns the global ids
// [s * nl, (s + 1) * nl); Np: nl padded to 16; alloc_t / used_t [R, S * Np]:
// the allocatable and the final usage on the axis (shard s's columns
// [s * Np, (s + 1) * Np)); max_kc / kc_out as ktt_fit_scan's.  No gated
// mode.
extern "C" int ktt_fit_scan_shard(const void* const* shard_ptrs, int S, int nl, const void* pod_req,
                                  const void* pod_valid, const void* alloc_t, void* used_t, const void* score_idx,
                                  int K, unsigned score_mask, const void* shape_xy, int n_shape, int strategy,
                                  float fit_w, float bal_w, int P, int Np, int R, void* choices, void* n_scored,
                                  int max_kc, int* kc_out, void* stream) {
  const int bad = bad_args(R, K, n_shape, strategy, P, max_kc);
  if (bad || Np % UNIT != 0 || Np < UNIT || nl < 1 || nl > Np || S < 1 || S > MAX_SHARDS)
    return bad ? bad : (int)cudaErrorInvalidValue;
  FitShards tab{};
  for (int s = 0; s < S; ++s)
    tab.sh[s] = FitShard{static_cast<const uint8_t*>(shard_ptrs[2 * s]),
                         static_cast<const int32_t*>(shard_ptrs[2 * s + 1])};
  return launch_any(tab, Axis{S, nl, Np}, pod_req, pod_valid, alloc_t, used_t, score_idx, K, score_mask, shape_xy,
                    n_shape, strategy, fit_w, bal_w, P, R, choices, n_scored, nullptr, max_kc, kc_out,
                    reinterpret_cast<cudaStream_t>(stream));
}
