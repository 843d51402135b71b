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
// Design: ONE persistent block of 1024 threads walks all P pods in order.
// Each pod depends on the previous pod's commit, so the scan is a chain of
// P block-wide reductions:
//   - the sf row of pod p+1 streams into shared memory (cp.async, double
//     buffered) while pod p is scored, so no thread waits on device memory
//     for the mask;
//   - each thread takes 4 consecutive nodes at a time (one 4-byte word of
//     the row; words tid, tid+1024, ...) and loads their allocatable and
//     usage as int4 for every requested resource at once, with no early
//     exit, so a batch costs one L2 round trip instead of one per resource;
//     `alloc` and `used` arrive transposed ([R, N]) for those loads and stay
//     resident in L2 (2 x 410 KB at N=20480, R=5);
//   - the K scored resources' int4 pairs are always loaded and stay in
//     registers: the scores of the batch's nodes are computed from them,
//     with no further load (the kernel is a template on K, 1..8, so those
//     registers have a fixed count);
//   - each thread keeps its best (score desc, index asc; it visits its nodes
//     in ascending order), a warp shuffle tree and one shared-memory pass
//     reduce the key, thread 0 commits to `used`, and the next pod starts
//     after __syncthreads().
// The launch copies its start usage `used_in` [n_real, R] into the running
// state `used_t` itself (zero in the padding columns) and zeroes n_scored.
// So the gang fixpoint's gated mode (ops/gang.py), which passes `done` (a
// device word: the launch returns at entry once it is set) and the same
// buffers to every iteration, leaves the last real launch's usage and
// counts in place.
// No grid-wide sync is needed; the rest of the card idles.  A multi-SM scan
// (a cluster, or the chunked / wave algorithms of kernels B4/B5) is later
// work.  The wrapper pads N to a multiple of 16 (cp.async moves 16 bytes).
//
// SHARD MODE (fit_scan_shard_kernel; the JAX package's schedule_scan under
// shard_map with every optional stage off): a cooperative grid of S
// blocks, block s scanning node shard s's columns through its own pointers
// (its sf rows, allocatable and running usage [R, Np], its first global
// node id).  Per pod each block reduces its shard's best (score, global
// id) as above and writes it to its slot of the exchange (xv, xi; two
// slots per shard, by pod parity); after ONE grid barrier every block
// takes the best of the S slots in shard order (the max of (score, -global
// id): the JAX package's pmax of the best, then pmin of the ids that attain
// it) and the owner shard adds the request to its column.  A pod's slot is
// rewritten two pods later, after the next pod's barrier, so no block
// overwrites a slot another still reads.
//
// Bounds on an H100: the bytes are sf read once (P*N, 1.05 GB at the
// 50k x 20k shape) plus the small [N, R] / [P, R] arrays, >= 0.31 ms at
// 3.35 TB/s; the dependency floor is P sequential block reductions.  The
// kernel also counts the (pod, node) pairs it scored (n_scored) so the
// caller can state the f32 operation bound of this run's data.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;
constexpr int MAX_SHARDS = 8;
constexpr int MAX_R = 32;
constexpr int MAX_K = 8;
constexpr int MAX_SHAPE = 16;

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

__device__ __forceinline__ int lane_of(const int4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// fit_w * fit_score + bal_w * balanced_allocation of node j (0..3) of a batch
// whose scored resources' allocatable and usage are sa / su, for the pod
// whose request of scored resource k is rqk[k] (a node that passed fit, so
// used + req cannot wrap)
template <int K>
__device__ __forceinline__ float node_total(const int4 (&sa)[K], const int4 (&su)[K],
                                            const int (&rqk)[K], int j, const float* s_xs,
                                            const float* s_ys, const Params& prm) {
  float fa[K], fq[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    fa[k] = (float)lane_of(sa[k], j);
    fq[k] = (float)(lane_of(su[k], j) + rqk[k]);
  }
  float fit = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float a = fa[k], q = fq[k];
    float x;
    if (prm.strategy == LEAST_ALLOCATED) {
      x = (a > 0.0f) ? fmaxf(0.0f, (a - q) * 100.0f / a) : 0.0f;
    } else if (prm.strategy == MOST_ALLOCATED) {
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

// cp.async row `row` of sf into shared buffer `dst` (N bytes, N % 16 == 0)
__device__ __forceinline__ void prefetch_row(uint8_t* dst, const uint8_t* __restrict__ sf,
                                             int row, int N) {
  const uint8_t* src = sf + (int64_t)row * N;
  for (int i = threadIdx.x * 16; i < N; i += NT * 16) __pipeline_memcpy_async(dst + i, src + i, 16);
  __pipeline_commit();
}

// the best (score desc, node id asc) feasible node of the pod whose sf
// row is `cur` and whose request is s_req: each thread keeps its best (it
// visits its nodes in ascending order), a warp shuffle tree and one
// shared-memory pass reduce the key, and warp 0 ends holding it (lane 0
// the block's).  Node ids are id_base + n.
template <int K>
__device__ __forceinline__ void pod_best(const uint8_t* cur, int NQ, const int4* alloc4, const int4* used4,
                                         const int (&sidx)[K], const int* s_req, int R, const float* s_xs,
                                         const float* s_ys, const Params& prm, bool valid, int id_base,
                                         unsigned long long& scored, float* s_best, int* s_node, float& best,
                                         int& best_n) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  best = -INFINITY;
  best_n = INT32_MAX;
  if (valid) {
    int rqk[K];
#pragma unroll
    for (int k = 0; k < K; ++k) rqk[k] = s_req[sidx[k]];
    const uint32_t* words = reinterpret_cast<const uint32_t*>(cur);
    for (int q = tid; q < NQ; q += NT) {
      const uint32_t m = words[q];
      if (m == 0) continue;
      bool ok0 = (m & 0xffu) != 0, ok1 = (m & 0xff00u) != 0;
      bool ok2 = (m & 0xff0000u) != 0, ok3 = (m & 0xff000000u) != 0;
      int4 sa[K], su[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        sa[k] = alloc4[(int64_t)sidx[k] * NQ + q];
        su[k] = used4[(int64_t)sidx[k] * NQ + q];
        const int rq = rqk[k];
        if (rq != 0) {  // a resource the pod does not request never blocks
          ok0 &= rq <= sa[k].x - su[k].x;
          ok1 &= rq <= sa[k].y - su[k].y;
          ok2 &= rq <= sa[k].z - su[k].z;
          ok3 &= rq <= sa[k].w - su[k].w;
        }
      }
      for (int r = 0; r < R; ++r) {  // the requested resources not scored
        const int rq = s_req[r];
        if (rq == 0 || ((prm.score_mask >> r) & 1u)) continue;
        const int4 a = alloc4[(int64_t)r * NQ + q];
        const int4 u = used4[(int64_t)r * NQ + q];
        ok0 &= rq <= a.x - u.x;
        ok1 &= rq <= a.y - u.y;
        ok2 &= rq <= a.z - u.z;
        ok3 &= rq <= a.w - u.w;
      }
      const bool ok[4] = {ok0, ok1, ok2, ok3};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!ok[j]) continue;
        ++scored;
        const float total = node_total<K>(sa, su, rqk, j, s_xs, s_ys, prm);
        if (total > best) {  // nodes ascend per thread: keeps the lowest index
          best = total;
          best_n = id_base + 4 * q + j;
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(0xffffffffu, best, off);
    const int on = __shfl_down_sync(0xffffffffu, best_n, off);
    if (better(ob, on, best, best_n)) {
      best = ob;
      best_n = on;
    }
  }
  if (lane == 0) {
    s_best[warp] = best;
    s_node[warp] = best_n;
  }
  __syncthreads();
  if (warp == 0) {
    best = s_best[lane];
    best_n = s_node[lane];
    for (int off = 16; off > 0; off >>= 1) {
      const float ob = __shfl_down_sync(0xffffffffu, best, off);
      const int on = __shfl_down_sync(0xffffffffu, best_n, off);
      if (better(ob, on, best, best_n)) {
        best = ob;
        best_n = on;
      }
    }
  }
}

template <int K>
__global__ void __launch_bounds__(NT) fit_scan_kernel(
    const uint8_t* __restrict__ sf,        // [P, N]
    const int32_t* __restrict__ pod_req,   // [P, R]
    const uint8_t* __restrict__ pod_valid,  // [P]
    const int32_t* __restrict__ alloc_t,   // [R, N]
    int32_t* used_t,                       // [R, N], updated in place
    const int32_t* __restrict__ score_idx,  // [K]
    const float* __restrict__ shape_xy,    // [2 * n_shape]: xs then ys
    Params prm, int P, int N, int R,
    int32_t* __restrict__ choices,  // [P]
    unsigned long long* __restrict__ n_scored,
    const int32_t* __restrict__ used_in,  // [n_real, R]
    int n_real,
    const int32_t* __restrict__ done) {  // or NULL
  if (done != nullptr && *done) return;  // every thread reads the same word
  extern __shared__ __align__(16) uint8_t s_rows[];  // [2][N]: sf rows p, p+1
  __shared__ int s_req[MAX_R];
  __shared__ float s_xs[MAX_SHAPE];
  __shared__ float s_ys[MAX_SHAPE];
  __shared__ float s_best[NT / 32];
  __shared__ int s_node[NT / 32];

  const int tid = threadIdx.x;
  for (int64_t i = tid; i < (int64_t)R * N; i += NT) {  // the start state
    const int r = (int)(i / N), n = (int)(i % N);
    used_t[i] = n < n_real ? used_in[(int64_t)n * R + r] : 0;
  }
  if (tid == 0) *n_scored = 0;
  __syncthreads();
  if (tid < prm.n_shape) {
    s_xs[tid] = shape_xy[tid];
    s_ys[tid] = shape_xy[prm.n_shape + tid];
  }
  int sidx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) sidx[k] = score_idx[k];
  const int NQ = N >> 2;
  const int4* alloc4 = reinterpret_cast<const int4*>(alloc_t);
  const int4* used4 = reinterpret_cast<const int4*>(used_t);
  unsigned long long scored = 0;

  if (P > 0) prefetch_row(s_rows, sf, 0, N);
  for (int p = 0; p < P; ++p) {
    uint8_t* cur = s_rows + (p & 1) * N;
    // the other buffer was last read in pod p-1, before that pod's
    // reduction barrier, so it is free to refill
    if (p + 1 < P) {
      prefetch_row(s_rows + ((p + 1) & 1) * N, sf, p + 1, N);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);  // this thread's part of row p has landed
    if (tid < R) s_req[tid] = pod_req[(int64_t)p * R + tid];
    __syncthreads();  // row p and s_req visible; the previous commit too
    float best;
    int best_n;
    pod_best<K>(cur, NQ, alloc4, used4, sidx, s_req, R, s_xs, s_ys, prm, pod_valid[p], 0, scored, s_best, s_node,
                best, best_n);
    if (tid == 0) {
      const int choice = (best > -INFINITY && pod_valid[p]) ? best_n : -1;
      choices[p] = choice;
      if (choice >= 0) {
        for (int r = 0; r < R; ++r) used_t[(int64_t)r * N + choice] += s_req[r];
      }
    }
    // orders this commit before any thread reads `used` for the next pod,
    // and s_req's reads before it is overwritten
    __syncthreads();
  }
  atomicAdd(n_scored, scored);
}

template <int K>
cudaError_t launch(const void* sf, const void* pod_req, const void* pod_valid, const void* alloc_t,
                   void* used_t, const void* score_idx, const void* shape_xy, const Params& prm,
                   int P, int N, int R, void* choices, void* n_scored, const void* used_in, int n_real,
                   const void* done, cudaStream_t st) {
  const size_t smem = 2 * (size_t)N;
  cudaError_t err = cudaFuncSetAttribute(fit_scan_kernel<K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  fit_scan_kernel<K><<<1, NT, smem, st>>>(
      static_cast<const uint8_t*>(sf), static_cast<const int32_t*>(pod_req),
      static_cast<const uint8_t*>(pod_valid), static_cast<const int32_t*>(alloc_t),
      static_cast<int32_t*>(used_t), static_cast<const int32_t*>(score_idx),
      static_cast<const float*>(shape_xy), prm, P, N, R, static_cast<int32_t*>(choices),
      static_cast<unsigned long long*>(n_scored), static_cast<const int32_t*>(used_in), n_real,
      static_cast<const int32_t*>(done));
  return cudaGetLastError();
}


// one node shard of a shard-mode launch
struct FitShard {
  const uint8_t* sf;       // [P, Np] the shard's static rows
  const int32_t* alloc_t;  // [R, Np]
  int32_t* used_t;         // [R, Np] its running usage
  const int32_t* used_in;  // [nl, R] its start usage
};

struct FitShards {
  FitShard sh[MAX_SHARDS];
};

template <int K>
__global__ void __launch_bounds__(NT) fit_scan_shard_kernel(
    FitShards tab, int S, int nl,
    const int32_t* __restrict__ pod_req,   // [P, R]
    const uint8_t* __restrict__ pod_valid,  // [P]
    const int32_t* __restrict__ score_idx,  // [K]
    const float* __restrict__ shape_xy,    // [2 * n_shape]
    Params prm, int P, int N, int R,       // N: the shard's columns padded to 16
    int32_t* __restrict__ choices,         // [P] global node ids
    unsigned long long* __restrict__ n_scored,
    float* xv, int32_t* xi) {              // [2, S] the exchange
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) uint8_t s_rows[];  // [2][N]: sf rows p, p+1
  __shared__ int s_req[MAX_R];
  __shared__ float s_xs[MAX_SHAPE];
  __shared__ float s_ys[MAX_SHAPE];
  __shared__ float s_best[NT / 32];
  __shared__ int s_node[NT / 32];

  const int s = blockIdx.x;
  const FitShard sh = tab.sh[s];
  const uint8_t* __restrict__ sf = sh.sf;
  int32_t* used_t = sh.used_t;
  const int base = s * nl;
  const int tid = threadIdx.x;
  for (int64_t i = tid; i < (int64_t)R * N; i += NT) {  // the shard's start state
    const int r = (int)(i / N), n = (int)(i % N);
    used_t[i] = n < nl ? sh.used_in[(int64_t)n * R + r] : 0;
  }
  if (s == 0 && tid == 0) *n_scored = 0;
  if (tid < prm.n_shape) {
    s_xs[tid] = shape_xy[tid];
    s_ys[tid] = shape_xy[prm.n_shape + tid];
  }
  grid.sync();
  int sidx[K];
#pragma unroll
  for (int k = 0; k < K; ++k) sidx[k] = score_idx[k];
  const int NQ = N >> 2;
  const int4* alloc4 = reinterpret_cast<const int4*>(sh.alloc_t);
  const int4* used4 = reinterpret_cast<const int4*>(used_t);
  unsigned long long scored = 0;

  if (P > 0) prefetch_row(s_rows, sf, 0, N);
  for (int p = 0; p < P; ++p) {
    uint8_t* cur = s_rows + (p & 1) * N;
    if (p + 1 < P) {
      prefetch_row(s_rows + ((p + 1) & 1) * N, sf, p + 1, N);
    } else {
      __pipeline_commit();
    }
    __pipeline_wait_prior(1);
    if (tid < R) s_req[tid] = pod_req[(int64_t)p * R + tid];
    __syncthreads();
    float best;
    int best_n;
    pod_best<K>(cur, NQ, alloc4, used4, sidx, s_req, R, s_xs, s_ys, prm, pod_valid[p], base, scored, s_best, s_node,
                best, best_n);
    if (tid == 0) {
      xv[(p & 1) * S + s] = best;
      xi[(p & 1) * S + s] = best_n;
    }
    grid.sync();
    if (tid == 0) {
      float v = -INFINITY;
      int n = INT32_MAX;
      for (int s2 = 0; s2 < S; ++s2) {  // shard order
        const float v2 = __ldcg(xv + (p & 1) * S + s2);
        const int n2 = __ldcg(xi + (p & 1) * S + s2);
        if (better(v2, n2, v, n)) {
          v = v2;
          n = n2;
        }
      }
      const int choice = (v > -INFINITY && pod_valid[p]) ? n : -1;
      if (s == 0) choices[p] = choice;
      if (choice >= base && choice < base + nl)  // the owner's column
        for (int r = 0; r < R; ++r) used_t[(int64_t)r * N + (choice - base)] += s_req[r];
    }
    // orders the owner's commit before its threads read `used` for the next
    // pod, and s_req's reads before it is overwritten
    __syncthreads();
  }
  atomicAdd(n_scored, scored);
}

template <int K>
cudaError_t launch_shard(const FitShards& tab, int S, int nl, const void* pod_req, const void* pod_valid,
                         const void* score_idx, const void* shape_xy, const Params& prm, int P, int N, int R,
                         void* choices, void* n_scored, void* xv, void* xi, cudaStream_t st) {
  const size_t smem = 2 * (size_t)N;
  cudaError_t err = cudaFuncSetAttribute(fit_scan_shard_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, nsm = 0, coop = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fit_scan_shard_kernel<K>, NT, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || nsm * per_sm < S) return cudaErrorInvalidConfiguration;
  const int32_t* rq = static_cast<const int32_t*>(pod_req);
  const uint8_t* pv = static_cast<const uint8_t*>(pod_valid);
  const int32_t* si = static_cast<const int32_t*>(score_idx);
  const float* sxy = static_cast<const float*>(shape_xy);
  int32_t* ch = static_cast<int32_t*>(choices);
  unsigned long long* ns = static_cast<unsigned long long*>(n_scored);
  float* xvp = static_cast<float*>(xv);
  int32_t* xip = static_cast<int32_t*>(xi);
  FitShards t = tab;
  Params pr = prm;
  void* args[] = {&t, &S, &nl, &rq, &pv, &si, &sxy, &pr, &P, &N, &R, &ch, &ns, &xvp, &xip};
  err = cudaLaunchCooperativeKernel((void*)fit_scan_shard_kernel<K>, dim3(S), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// score_idx is on the device; score_mask holds the same resource ids as
// bits, for the kernel's fit test; used_in: the start usage [n_real, R];
// done (or NULL): the gate above
extern "C" int ktt_fit_scan(const void* sf, const void* pod_req, const void* pod_valid,
                            const void* alloc_t, void* used_t, const void* score_idx, int K,
                            unsigned score_mask, const void* shape_xy, int n_shape, int strategy,
                            float fit_w, float bal_w, int P, int N, int R, void* choices,
                            void* n_scored, const void* used_in, int n_real, const void* done,
                            void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (R < 1 || R > MAX_R || K < 1 || K > MAX_K || n_shape < 1 || n_shape > MAX_SHAPE ||
      N % 16 != 0 || n_real > N || used_in == nullptr || P < 0)
    return (int)cudaErrorInvalidValue;
  const Params prm{score_mask, 1.0f / (float)K, n_shape, strategy, fit_w, bal_w};
  switch (K) {
#define KTT_CASE(k)                                                                            \
  case k:                                                                                      \
    return (int)launch<k>(sf, pod_req, pod_valid, alloc_t, used_t, score_idx, shape_xy, prm, P, \
                          N, R, choices, n_scored, used_in, n_real, done, st);
    KTT_CASE(1) KTT_CASE(2) KTT_CASE(3) KTT_CASE(4)
    KTT_CASE(5) KTT_CASE(6) KTT_CASE(7) KTT_CASE(8)
#undef KTT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// shard mode: shard_ptrs holds S rows of (sf [P, Np], alloc_t [R, Np],
// used_t [R, Np], used_in [nl, R]); shard s owns the global ids
// [s * nl, (s + 1) * nl); Np: nl padded to 16; xv / xi: the exchange [2, S]
extern "C" int ktt_fit_scan_shard(const void* const* shard_ptrs, int S, int nl, const void* pod_req,
                                  const void* pod_valid, const void* score_idx, int K, unsigned score_mask,
                                  const void* shape_xy, int n_shape, int strategy, float fit_w, float bal_w, int P,
                                  int Np, int R, void* choices, void* n_scored, void* xv, void* xi, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (R < 1 || R > MAX_R || K < 1 || K > MAX_K || n_shape < 1 || n_shape > MAX_SHAPE || Np % 16 != 0 ||
      nl > Np || S < 1 || S > MAX_SHARDS || P < 0)
    return (int)cudaErrorInvalidValue;
  FitShards tab{};
  for (int s = 0; s < S; ++s) {
    const void* const* r = shard_ptrs + 4 * s;
    tab.sh[s] = FitShard{static_cast<const uint8_t*>(r[0]), static_cast<const int32_t*>(r[1]),
                         static_cast<int32_t*>(const_cast<void*>(r[2])), static_cast<const int32_t*>(r[3])};
  }
  const Params prm{score_mask, 1.0f / (float)K, n_shape, strategy, fit_w, bal_w};
  switch (K) {
#define KTT_CASE(k)                                                                                    \
  case k:                                                                                              \
    return (int)launch_shard<k>(tab, S, nl, pod_req, pod_valid, score_idx, shape_xy, prm, P, Np, R, choices, \
                                n_scored, xv, xi, st);
    KTT_CASE(1) KTT_CASE(2) KTT_CASE(3) KTT_CASE(4)
    KTT_CASE(5) KTT_CASE(6) KTT_CASE(7) KTT_CASE(8)
#undef KTT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
