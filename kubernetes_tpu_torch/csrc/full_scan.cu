// K11 full_scan: the per-pod sequential commit scan over the full stage set.
//
// Replaces the JAX package's ops/assign.py:181 schedule_scan (its step at
// :258-332 and commit at :334-370, every optional stage: NodePorts,
// PodTopologySpread, InterPodAffinity filter and preferred score,
// TaintToleration and preferred NodeAffinity scores, ImageLocality), with
// ops/pairwise.py (B9) inlined from pairwise.cuh.  Kernel fit_scan keeps the
// fit-only stage set; the router picks by the score config.
//
// For each pod p in activeQ (array) order, one block of 1024 threads:
//   1. the pod's slots into shared memory; the spread minMatch per slot and
//      the required-affinity waiver against the running counts;
//   2. per node: static bit (K7's packed plane) & fit against the running
//      usage & host ports & spread skew & inter-pod required; for feasible
//      nodes the base score (fit + balanced), the spread raw and the
//      inter-pod preferred raw, into a global row scratch; block maxima of
//      the taint, node-affinity and spread raws and the inter-pod max/min
//      over the feasible set;
//   3. per node: the total in the plain version's stage order, masked to
//      -inf where infeasible; the argmax (lowest index on ties);
//   4. thread 0 adds the request to the chosen node's usage, the pod's
//      counts to total_t and its ports; every thread adds the pod's term
//      rows to the [T, N] count planes at the nodes of the chosen node's
//      domains.
// No grid-wide sync is needed; the rest of the card idles (as fit_scan).
// The launch copies its start state into the running state itself
// (pairwise.cuh copy_start_state), and in the gang fixpoint's gated mode
// (FullArgs::done) returns at entry once the device word is set.
//
// SHARD MODE (full_scan_shard_kernel, the JAX package's schedule_scan
// under shard_map, ops/assign.py:181 with axis_name, collectives at
// :252-344): a cooperative grid of S blocks, block s working for node shard
// s through its own pointers (pairwise.cuh shard_view; per shard its
// planes, usage [nl, R], count planes, ports and its own copy of total_t).
// The only memory the shards share is the exchange FullX, one slot per
// shard per quantity; each shard writes only its own, and after a grid
// barrier every block combines the S slots in shard order.  Per pod:
//   1. (pairwise) each slot's partial max of -count -> barrier -> the max
//      over shards, then inf -> 0 (the JAX pmin taken before it);
//   2. row_feas -> the five partial maxima -> barrier -> their max: the
//      normalisation scalars (_rmax);
//   3. row_total: the shard's best (score, global id), and the commit
//      entries its best node would make (the domain columns from its own
//      dbt) -> barrier -> every block takes the best of the S slots (the
//      max of (score, -global id): _rmax then _rmin), the owner adds the
//      request and ports to its node, every block adds the winner's
//      entries to its own count columns and its total_t copy.
// Three grid barriers a pod (two without the pairwise stages).  A block
// reads node-axis data only through its shard's pointers.
//
// Bounds on an H100 at config 3 (P = 10240, N = 6144, T = 80): the bytes
// are the two packed planes (2 x 10240 x 192 words, 15.7 MB) and the pods'
// arrays read once, >= 5 us at 3.35 TB/s; the operations, ~60 f32 per
// feasible (pod, node), under 4 G, >= 0.06 ms at 67 TFLOP/s.  Neither sets
// the time: the chain of P dependent block-wide passes and barriers does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pairwise.cuh"

namespace cg = cooperative_groups;

namespace {

using ktt::CommitEnt;
using ktt::FullArgs;
using ktt::PodSlots;
using ktt::RowScalars;

constexpr int MAX_ENT = ktt::PW_MAX_M + 3 * ktt::PW_MAX_S;

struct ScanScratch {
  uint8_t* feas;  // [N]
  float* base;    // [N]
  float* sraw;    // [N]
  float* ipraw;   // [N]
  float* total;   // [N]
};

__global__ void __launch_bounds__(ktt::PW_NT) full_scan_kernel(FullArgs a, ScanScratch s, int32_t* choices) {
  __shared__ PodSlots ps;
  __shared__ RowScalars rs;
  __shared__ float red[5 * 32];
  __shared__ int redi[32];
  __shared__ CommitEnt ents[MAX_ENT];
  __shared__ int n_ent;
  __shared__ int s_choice;
  if (a.done != nullptr && *a.done) return;  // every thread reads the same word
  ktt::copy_start_state(a, threadIdx.x, blockDim.x);
  __syncthreads();
  for (int p = 0; p < a.P; ++p) {
    ktt::load_pod(a, p, ps);
    __syncthreads();
    if (!ps.valid) {  // a padding or gated pod: its static row is all 0
      if (threadIdx.x == 0) choices[p] = -1;
      __syncthreads();
      continue;
    }
    ktt::pod_scalars(a, p, ps, red);
    ktt::row_pass(a, p, ps, s.feas, s.base, s.sraw, s.ipraw, s.total, rs, red, redi);
    if (threadIdx.x == 0) {
      const int choice = rs.best > -INFINITY ? rs.best_n : -1;
      choices[p] = choice;
      s_choice = choice;
      n_ent = 0;
      if (choice >= 0) {
        for (int r = 0; r < a.R; ++r) {
          int32_t* u = a.used + (int64_t)choice * a.R + r;
          *u = ktt::wadd(__ldcg(u), ps.req[r]);
        }
        for (int k = 0; k < ps.n_port; ++k) a.ports_used[(int64_t)choice * a.PT + ps.port[k]] = 1;
        n_ent = ktt::commit_entries(a, p, choice, ents, a.total_t);
      }
    }
    __syncthreads();
    if (s_choice >= 0)
      for (int n = threadIdx.x; n < a.N; n += blockDim.x)
        for (int k = 0; k < n_ent; ++k) ktt::apply_entry(a, ents[k], n);
    // the commit lands before any thread reads the state for the next pod
    __syncthreads();
  }
}

// the exchange of shard mode: one slot per shard per quantity
struct FullX {
  float* mm;        // [S, PW_MAX_S] each spread slot's partial max of -count
  float* sc;        // [S, 5] the partial normalisation maxima
  float* bv;        // [S] the shard's best total
  int32_t* bn;      // [S] its global node id
  CommitEnt* ents;  // [S, MAX_ENT] the commit entries at the shard's best node
  int32_t* n_ent;   // [S]
};

// the row scratch of shard mode: [S, nl] per row
struct ShardRows {
  uint8_t* feas;
  float* base;
  float* sraw;
  float* ipraw;
  float* total;
};

__global__ void __launch_bounds__(ktt::PW_NT) full_scan_shard_kernel(FullArgs g, ktt::ShardTable tab, ShardRows rows,
                                                                     FullX x, int32_t* choices) {
  cg::grid_group grid = cg::this_grid();
  __shared__ FullArgs a;
  __shared__ PodSlots ps;
  __shared__ RowScalars rs;
  __shared__ float red[5 * 32];
  __shared__ int redi[32];
  __shared__ int s_win, s_nent;
  const int s = blockIdx.x, S = tab.S, tid = threadIdx.x;
  const int base = tab.sh[s].base, nl = tab.sh[s].nl;
  if (tid == 0) ktt::shard_view(g, tab.sh[s], a);
  __syncthreads();
  ktt::copy_start_state(a, tid, blockDim.x);
  __syncthreads();
  const int64_t row = (int64_t)s * nl;
  uint8_t* feas = rows.feas + row;
  float* base_r = rows.base + row;
  float* sraw = rows.sraw + row;
  float* ipraw = rows.ipraw + row;
  float* total = rows.total + row;
  for (int p = 0; p < a.P; ++p) {
    ktt::load_pod(a, p, ps);
    __syncthreads();
    if (!ps.valid) {  // the same pod on every shard: a uniform branch
      if (s == 0 && tid == 0) choices[p] = -1;
      __syncthreads();
      continue;
    }
    if (a.pw) {  // 1. the spread minMatch
      ktt::pod_scalars_partial(a, p, ps, red);
      if (tid < ps.n_sp) x.mm[s * ktt::PW_MAX_S + tid] = ps.sp_mm[tid];
      grid.sync();
      if (tid < ps.n_sp) {
        float v = -INFINITY;
        for (int s2 = 0; s2 < S; ++s2) v = fmaxf(v, __ldcg(x.mm + s2 * ktt::PW_MAX_S + tid));
        ps.sp_mm[tid] = v;
      }
      __syncthreads();
      if (tid == 0) ktt::pod_scalars_finish(ps);
      __syncthreads();
    }
    float m[5];  // 2. the normalisation scalars
    ktt::row_feas(a, p, ps, feas, base_r, sraw, ipraw, m, red);
    if (tid == 0)
      for (int k = 0; k < 5; ++k) x.sc[s * 5 + k] = m[k];
    grid.sync();
    for (int k = 0; k < 5; ++k) {
      float v = -INFINITY;
      for (int s2 = 0; s2 < S; ++s2) v = fmaxf(v, __ldcg(x.sc + s2 * 5 + k));
      m[k] = v;
    }
    // 3. the argmax and the commit
    ktt::row_total(a, ps, ktt::row_scalars(m), feas, base_r, sraw, ipraw, total, base, rs, red, redi);
    if (tid == 0) {
      x.bv[s] = rs.best;
      x.bn[s] = rs.best_n;
      x.n_ent[s] = rs.best > -INFINITY ? ktt::commit_entries(a, p, rs.best_n - base, x.ents + s * MAX_ENT, nullptr)
                                       : 0;
    }
    grid.sync();
    if (tid == 0) {
      float v = -INFINITY;
      int n = ktt::PW_IMAX, w = -1;
      for (int s2 = 0; s2 < S; ++s2) {
        const float v2 = __ldcg(x.bv + s2);
        const int n2 = __ldcg(x.bn + s2);
        if (ktt::pw_better(v2, n2, v, n)) {
          v = v2;
          n = n2;
          w = s2;
        }
      }
      const int choice = v > -INFINITY ? n : -1;
      if (s == 0) choices[p] = choice;
      s_win = choice >= 0 ? w : -1;
      s_nent = choice >= 0 ? __ldcg(x.n_ent + w) : 0;
      if (choice >= 0 && w == s) {  // the owner: usage and ports of its node
        const int cl = choice - base;
        for (int r = 0; r < a.R; ++r) {
          int32_t* u = a.used + (int64_t)cl * a.R + r;
          *u = ktt::wadd(__ldcg(u), ps.req[r]);
        }
        for (int k = 0; k < ps.n_port; ++k) a.ports_used[(int64_t)cl * a.PT + ps.port[k]] = 1;
      }
      for (int k = 0; k < s_nent; ++k) {  // this shard's copy of total_t
        const CommitEnt e = ktt::load_ent(x.ents + w * MAX_ENT + k);
        if (e.plane == 0 && e.dcol < a.D) a.total_t[e.t] = __ldcg(a.total_t + e.t) + e.w;
      }
    }
    __syncthreads();
    if (s_win >= 0)
      for (int n = tid; n < nl; n += blockDim.x)
        for (int k = 0; k < s_nent; ++k) ktt::apply_entry(a, ktt::load_ent(x.ents + s_win * MAX_ENT + k), n);
    // the commit lands before any thread reads the state for the next pod
    __syncthreads();
  }
}

}  // namespace

// ip / fp: the score parameters (score.cuh make_score_params), host memory;
// wp: the stage weights (taint, node affinity, spread, inter-pod, image,
// hardPodAffinityWeight); sw: the stage switches (pairwise, interpod score,
// ports, taint, node affinity, image); dims: P, N, R, T, D, PT, CS, A1, A2,
// B, M; ptrs[27..33]: done and the start state (pairwise.cuh read_gate)
extern "C" int ktt_full_scan(const void* const* ptrs, const int* dims, const int* sw, const float* wp,
                             const int* ip, const float* fp, void* choices, void* scratch, void* stream) {
  FullArgs a;
  const int bad = ktt::read_full_args(ptrs, dims, sw, wp, ip, fp, a);
  if (bad) return bad;
  ScanScratch s;
  uint8_t* base = static_cast<uint8_t*>(scratch);  // 4 f32 rows, then the byte row
  s.base = reinterpret_cast<float*>(base);
  s.sraw = s.base + a.N;
  s.ipraw = s.sraw + a.N;
  s.total = s.ipraw + a.N;
  s.feas = reinterpret_cast<uint8_t*>(s.total + a.N);
  full_scan_kernel<<<1, ktt::PW_NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      a, s, static_cast<int32_t*>(choices));
  return (int)cudaGetLastError();
}

// shard mode: ptrs / dims / sw / wp / ip / fp as ktt_full_scan's for shard
// 0's arrays (the pod side; dims[1] = nl), done NULL; shard_ptrs: S rows of
// pairwise.cuh ShardPtrs' 18 pointers; rows: the row scratch (feas [S, nl]
// bytes; base, sraw, ipraw, total [S, nl] f32); xs: the exchange (mm, sc,
// bv, bn, ents, n_ent).  A cooperative launch of S blocks.
extern "C" int ktt_full_scan_shard(const void* const* ptrs, const int* dims, const int* sw, const float* wp,
                                   const int* ip, const float* fp, const void* const* shard_ptrs, int S,
                                   void* choices, void* const* rows, void* const* xs, void* stream) {
  FullArgs g;
  const int bad = ktt::read_full_args(ptrs, dims, sw, wp, ip, fp, g);
  if (bad) return bad;
  if (S < 1 || S > ktt::PW_MAX_SHARDS || g.done != nullptr) return (int)cudaErrorInvalidValue;
  ktt::ShardTable tab = ktt::make_shard_table(shard_ptrs, S, g.N);
  ShardRows r{static_cast<uint8_t*>(rows[0]), static_cast<float*>(rows[1]), static_cast<float*>(rows[2]),
              static_cast<float*>(rows[3]), static_cast<float*>(rows[4])};
  FullX x{static_cast<float*>(xs[0]), static_cast<float*>(xs[1]), static_cast<float*>(xs[2]),
          static_cast<int32_t*>(xs[3]), static_cast<CommitEnt*>(xs[4]), static_cast<int32_t*>(xs[5])};
  int dev = 0, nsm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, full_scan_shard_kernel, ktt::PW_NT, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1 || nsm * per_sm < S) return (int)cudaErrorInvalidConfiguration;
  int32_t* ch = static_cast<int32_t*>(choices);
  void* args[] = {&g, &tab, &r, &x, &ch};
  err = cudaLaunchCooperativeKernel((void*)full_scan_shard_kernel, dim3(S), dim3(ktt::PW_NT), args, 0,
                                    reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
