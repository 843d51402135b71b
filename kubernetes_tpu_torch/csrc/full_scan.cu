// K11 full_scan: the per-pod sequential commit scan over the full stage set.
//
// Replaces the JAX package's ops/assign.py:181 schedule_scan (its step at
// :258-332 and commit at :334-370, every optional stage: NodePorts,
// PodTopologySpread, InterPodAffinity filter and preferred score,
// TaintToleration and preferred NodeAffinity scores, ImageLocality), with
// ops/pairwise.py (B9) inlined from pairwise.cuh.  Kernel fit_scan keeps the
// fit-only stage set; the router picks by the score config.
//
// Design: ONE thread-block cluster of kc blocks of 1024 threads walks all P
// pods in order (each depends on the previous pod's commit); kc is the
// widest cluster the card schedules, up to 16 (a non-portable size;
// ops/kernels.py SCAN_CLUSTER caps it), with at least 32 nodes a block.
// Block q owns the nodes [lo(q), lo(q + 1)), lo(q) = floor(q * N / kc), a
// thread the nodes lo + tid, lo + tid + 1024, ...; a node's count planes
// are read and written by its thread alone, its usage and ports by its
// thread and by warp 0's commit, so no block waits on another's writes.
// Each block keeps its own copy of the replicated total_t and its run's row
// scratch (feasibility, base score, spread and inter-pod raws) in shared
// memory.  Per pod, as K12's exact re-hoist (rounds.cu phase A):
//   0. the pod's slots, loaded a pod ahead by warps 24..30 (which hold the
//      fewest nodes), and its required-affinity waiver, from the block's
//      total_t by the previous pod's commit;
//   1. (a hard spread slot only: no other reads the minMatch) per slot the
//      block's max of -count over its keyed eligible nodes, each thread's
//      taken right after it applied the previous pod's commit to its nodes
//      -> cluster barrier -> their max across the cluster (order free),
//      inf -> 0;
//   2. per node of the run: static bit (K7's packed plane) & fit against the
//      running usage & host ports & spread skew & inter-pod required, with
//      every load of the node in flight at once (pairwise.cuh
//      node_feasible); for
//      feasible nodes the base score, the spread and inter-pod raws into the
//      row scratch; the five normalisation maxima -> cluster barrier ->
//      their max;
//   3. the totals in the plain version's stage order, masked to -inf where
//      infeasible, and the block's best (score, node id) -> cluster barrier;
//   4. warp 0 of every block (alone: 512 readers of each block's key a pod
//      cost more than the barrier they save) takes the best of the kc
//      blocks' keys through distributed shared memory (the keys carry the
//      node id, so "highest score, lowest index" holds whatever the fold's
//      order); the owner block's warp 0 adds the request to the node's usage
//      and sets its ports; warp 0 builds the pod's commit entries (a lane
//      an entry, in the JAX commit's order: matched, anti, preferred,
//      required affinity at hardPodAffinityWeight) with the winner's domain
//      columns, adds the matched weights to the total_t copy in entry order
//      and takes the next pod's waiver -> block barrier -> every thread
//      applies the entries to its nodes' count planes.
// At most three cluster barriers a pod (two without a hard spread slot) and
// four block barriers besides; every block's exchange (the minMatch
// partials, the maxima, the key) is read between two barriers no block can
// pass before all have read it.  An invalid pod is decided alike in every
// block without an exchange.  The launch copies its start state into the
// running state itself (pairwise.cuh copy_start_state, spread over the
// cluster before its first barrier) and block 0 writes total_t at the end;
// in the gang fixpoint's gated mode (FullArgs::done) every block returns at
// entry once the device word is set.  The launch is refused (an error, no
// other kernel) when the card schedules no cluster.  The first design, one
// block for the whole node axis with its row scratch in global memory and
// thread 0 alone building the commit, took ~55 us a pod at config 3, 42 of
// them in the feasibility pass (bench/perpod_scan.py --phases).

// SHARD MODE (full_scan_kernel<true>, the JAX package's schedule_scan
// under shard_map, ops/assign.py:181 with axis_name, collectives at
// :252-344): the same kernel, one cluster, over S node shards of nl nodes,
// shard s owning the global ids [s * nl, (s + 1) * nl).  A block's run is
// one range of global ids cut as above and may span shards or hold part of
// one.  A node is read and written through its shard's view (pairwise.cuh
// shard_view / view_at: its planes, usage, count planes, ports and its own
// total_t copy, at local ids), one FullArgs a shard in shared memory; the
// row scratch is the block's shared memory by global id, as on one device.
// Each JAX collective becomes the cluster's own combination: the spread
// pmin and the five normalisation maxima (_rmax) are the cluster maxima
// (order free); the keys carry the global id, so the fold is _rmax then
// _rmin; the winner's commit entries take their domain columns from the
// owner shard's dbt (_gather_at_nodes); the block whose run holds the
// winner adds the usage and ports at its local id; every block applies the
// entries to its run's count planes, and at the end every shard's total_t
// copy takes the one sequence of adds.  The launch's own node-side
// pointers are NULL in shard mode.  The first shard mode, a cooperative
// grid of one block a shard joined by three grid barriers and a global
// exchange a pod, took 2.1-2.4x the one-device cluster's time at config 3
// on 4 / 5 shards.  The gated mode is refused in shard mode.
//
// Bounds on an H100 at config 3 (P = 10240, N = 6144, T = 80): the bytes
// are the two packed planes (2 x 10240 x 192 words, 15.7 MB) and the pods'
// arrays read once, >= 5 us at 3.35 TB/s; the operations, ~60 f32 per
// feasible (pod, node), under 4 G, >= 0.06 ms at 67 TFLOP/s.  Neither sets
// the time: the chain of P dependent cluster-wide passes and barriers does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"
#include "pairwise.cuh"

namespace cg = cooperative_groups;

namespace {

using ktt::CommitEnt;
using ktt::FullArgs;
using ktt::PodSlots;
using ktt::RowScalars;

constexpr int MAX_ENT = ktt::PW_MAX_M + 3 * ktt::PW_MAX_S;
constexpr int MAX_KC = 16;    // blocks per cluster: the widest an H100 schedules
constexpr int MIN_RUN = 32;   // nodes a block at least
constexpr int LOAD_W0 = ktt::PW_NWARP - 8;  // the first of the 7 warps that load the next pod's slots
// dynamic shared memory a block may take beside its static buffers
constexpr size_t SMEM_CAP = 232448 - 12288;

#ifdef KTT_FULL_PHASES
// A build with -DKTT_FULL_PHASES (kubernetes_tpu_torch/bench/perpod_scan.py)
// makes thread 0 of block 0 add the SM cycles between the pod loop's
// phase boundaries into g_phase_cycles[phase], each boundary counted in
// g_phase_hits; PH_CLUSTER holds its waits at the cluster barriers.
enum { PH_POD, PH_SPREAD, PH_FEAS, PH_TOTAL, PH_COMMIT, PH_APPLY, PH_CLUSTER, PH_N };
__device__ unsigned long long g_phase_cycles[PH_N];
__device__ unsigned long long g_phase_hits[PH_N];
#define KTT_PHASE(k)                                                     \
  do {                                                                   \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                           \
      const long long now = clock64();                                   \
      g_phase_cycles[k] += (unsigned long long)(now - ph_t);             \
      g_phase_hits[k] += 1;                                              \
      ph_t = now;                                                        \
    }                                                                    \
  } while (0)
#define KTT_PHASE_START long long ph_t = clock64()
#else
#define KTT_PHASE(k) ((void)0)
#define KTT_PHASE_START ((void)0)
#endif

// a block's best (score, node id)
struct Key {
  float v;
  int n;
};

// one block's static shared memory
struct ScanSmem {
  PodSlots ps[2];  // pods p, p+1
  float red_sp[ktt::PW_MAX_S * 32];  // the warps' partials of each reduction
  float red5[5 * 32];
  float redv[32];
  int redi[32];
  // read by the cluster's other blocks through distributed shared memory
  float part[ktt::PW_MAX_S];  // 1. this block's max of -count per hard spread slot
  float part5[5];             // 2. its normalisation maxima
  Key key;                    // 3. its best
  float mx5[5];               // the combined maxima
  CommitEnt ents[MAX_ENT];
  int n_ent;
};

__host__ __device__ __forceinline__ int run_lo(int q, int kc, int N) { return (int)((int64_t)q * N / kc); }

__device__ __forceinline__ void warp_best(float& v, int& n) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(ktt::PW_FULL, v, off);
    const int on = __shfl_xor_sync(ktt::PW_FULL, n, off);
    if (ktt::pw_better(ov, on, v, n)) {
      v = ov;
      n = on;
    }
  }
}

// the dynamic shared memory of a block whose run holds ns nodes: the
// total_t copy [T], then base, sraw, ipraw [ns] f32 and feas [ns] bytes
inline size_t dyn_smem(int T, int ns) { return 4 * (size_t)T + 12 * (size_t)ns + (size_t)ns; }

// whether the pod has a hard spread slot: only those read the minMatch
__device__ __forceinline__ bool has_hard(const PodSlots& ps) {
  bool h = false;
  for (int c = 0; c < ps.n_sp; ++c) h = h || ps.sp_hard[c];
  return h;
}

// the loaded pod's required-affinity waiver from a total_t copy (one
// thread)
__device__ __forceinline__ void waiver(PodSlots& ps, const float* tt) {
  float total_any = 0.0f;
  for (int k = 0; k < ps.n_af; ++k) total_any += tt[ps.af_t[k]];
  ps.waiver = ps.n_af > 0 && total_any == 0.0f && ps.self_all;
}

// per hard spread slot of the loaded pod, this thread's max of -count over
// its keyed eligible nodes among lo + i, i = tid, tid + nt, ... < ns (-inf:
// none; min as -max(-x)), each node read through its view
template <bool SH>
__device__ __forceinline__ void spread_partial(const FullArgs& a, const FullArgs* views, int nl, const PodSlots& ps,
                                               int lo, int ns, float (&v)[ktt::PW_MAX_S]) {
#pragma unroll
  for (int c = 0; c < ktt::PW_MAX_S; ++c) v[c] = -INFINITY;
  if (!a.pw || !ps.valid || !has_hard(ps)) return;
  for (int i = threadIdx.x; i < ns; i += blockDim.x) {
    int l;
    const FullArgs& g = ktt::view_at<SH>(a, views, nl, lo + i, l);
    if (!ktt::pw_bit(g.eligs, ps.prow, g.W, l)) continue;
#pragma unroll
    for (int c = 0; c < ktt::PW_MAX_S; ++c) {
      if (c >= ps.n_sp) break;
      if (!ps.sp_hard[c]) continue;
      const int64_t j = (int64_t)ps.sp_t[c] * g.N + l;
      if (g.dbt[j] < a.D) v[c] = fmaxf(v[c], -__ldcg(g.cnt + j));
    }
  }
}

// the block's max of v[0..n) into out[0..n): a warp shuffle per value, the
// warps' maxima into red, one block barrier, then thread k over them (the
// caller's next barrier publishes out)
template <int KR>
__device__ __forceinline__ void block_max_to(float (&v)[KR], int n, float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    if (k >= n) break;
    for (int off = 16; off > 0; off >>= 1) v[k] = fmaxf(v[k], __shfl_xor_sync(ktt::PW_FULL, v[k], off));
    if (lane == 0) red[k * 32 + warp] = v[k];
  }
  __syncthreads();
  if ((int)threadIdx.x < n) {
    float x = -INFINITY;
    for (int w = 0; w < nw; ++w) x = fmaxf(x, red[threadIdx.x * 32 + w]);
    out[threadIdx.x] = x;
  }
}

// One device (SH false: `a` holds every node, tab is not read) or shard
// mode (SH true: `a` the pod side with N the global node count S * nl, tab
// the S shards' node-side pointers, each node read through its shard's
// view at its local id)
template <bool SH>
__global__ void __launch_bounds__(ktt::PW_NT) full_scan_kernel(FullArgs a, ktt::ShardTable tab, int32_t* choices) {
  __shared__ ScanSmem m;
  __shared__ FullArgs views[SH ? ktt::PW_MAX_SHARDS : 1];  // shard mode: each shard's view
  extern __shared__ __align__(16) float dyn[];
  if (a.done != nullptr && *a.done) return;  // every thread of every block reads the same word
  cg::cluster_group cl = cg::this_cluster();
  const int kc = (int)cl.num_blocks(), q = (int)cl.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nt = blockDim.x, nw = nt >> 5;
  const int lo = run_lo(q, kc, a.N), ns = run_lo(q + 1, kc, a.N) - lo;
  const int nl = SH ? tab.sh[0].nl : a.N;
  float* tt = dyn;  // this block's copy of total_t
  float* base_r = tt + a.T;
  float* sraw_r = base_r + ns;
  float* ipraw_r = sraw_r + ns;
  uint8_t* feas_r = reinterpret_cast<uint8_t*>(ipraw_r + ns);
  if constexpr (SH) {
    if (tid < tab.S) ktt::shard_view(a, tab.sh[tid], views[tid]);
    __syncthreads();
    for (int s = 0; s < tab.S; ++s) ktt::copy_start_state(views[s], (int64_t)q * nt + tid, (int64_t)kc * nt);
  } else {
    ktt::copy_start_state(a, (int64_t)q * nt + tid, (int64_t)kc * nt);
  }
  for (int t = tid; t < a.T; t += nt) tt[t] = a.total0[t];
  if (a.P > 0) ktt::load_pod_warps(a, 0, m.ps[0]);
  KTT_PHASE_START;
  // the start state in place and every block of the cluster running (its
  // exchange readable) before any block goes on
  cl.sync();
  float v[ktt::PW_MAX_S];  // the next pod's spread partials, this thread's
  if (a.P > 0) {
    if (tid == 0 && a.pw) waiver(m.ps[0], tt);
    spread_partial<SH>(a, views, nl, m.ps[0], lo, ns, v);
  }
  __syncthreads();
  for (int p = 0; p < a.P; ++p) {
    // pod p's slots and waiver were published by the last block barrier of
    // pod p-1, which also ordered its commit before this pod's reads;
    // pod p-1's slots are read no more, so pod p+1's take their buffer
    PodSlots& ps = m.ps[p & 1];
    PodSlots& nx = m.ps[(p + 1) & 1];
    if (p + 1 < a.P) ktt::load_pod_warps(a, p + 1, nx, LOAD_W0);
    KTT_PHASE(PH_POD);
    if (!ps.valid) {  // a padding or gated pod, alike in every block: its static row is all 0
      if (q == 0 && tid == 0) choices[p] = -1;
      __syncthreads();  // pod p+1's slots
      if (p + 1 < a.P) {
        if (tid == 0 && a.pw) waiver(nx, tt);
        spread_partial<SH>(a, views, nl, nx, lo, ns, v);
      }
      __syncthreads();  // its waiver
      KTT_PHASE(PH_APPLY);
      continue;
    }
    if (a.pw && has_hard(ps)) {  // 1. the minMatch of the hard spread slots
      block_max_to(v, ps.n_sp, m.red_sp, m.part);
      KTT_PHASE(PH_SPREAD);
      cl.sync();
      KTT_PHASE(PH_CLUSTER);
      if (tid < ps.n_sp && ps.sp_hard[tid]) {
        float x = -INFINITY;
        for (int r = 0; r < kc; ++r) x = fmaxf(x, cl.map_shared_rank(m.part, r)[tid]);
        const float mm = -x;  // the min over the cluster, inf -> 0
        ps.sp_mm[tid] = isinf(mm) ? 0.0f : mm;
      }
      __syncthreads();
      KTT_PHASE(PH_SPREAD);
    }
    // 2. feasibility, raws and the five maxima over the run
    float mx[5] = {0.0f, 0.0f, 0.0f, -INFINITY, -INFINITY};
    for (int i = tid; i < ns; i += nt) {
      int l;
      const FullArgs& g = ktt::view_at<SH>(a, views, nl, lo + i, l);
      float base = 0.0f, sraw = 0.0f, ipraw = 0.0f;
      const bool f = ktt::node_feasible(g, p, ps, l, base, sraw, ipraw);
      feas_r[i] = f;
      if (!f) continue;
      base_r[i] = base;
      sraw_r[i] = sraw;
      ipraw_r[i] = ipraw;
      const int64_t pn = ps.prow * g.N + l;
      if (a.taint) mx[0] = fmaxf(mx[0], ktt::bf(g.traw, pn, g.f32));
      if (a.nap) mx[1] = fmaxf(mx[1], ktt::bf(g.naraw, pn, g.f32));
      mx[2] = fmaxf(mx[2], sraw);
      mx[3] = fmaxf(mx[3], ipraw);
      mx[4] = fmaxf(mx[4], -ipraw);
    }
    block_max_to(mx, 5, m.red5, m.part5);
    KTT_PHASE(PH_FEAS);
    cl.sync();
    KTT_PHASE(PH_CLUSTER);
    if (tid < 5) {
      float x = -INFINITY;
      for (int r = 0; r < kc; ++r) x = fmaxf(x, cl.map_shared_rank(m.part5, r)[tid]);
      m.mx5[tid] = x;
    }
    __syncthreads();
    // 3. the masked totals and the best
    const float mv[5] = {m.mx5[0], m.mx5[1], m.mx5[2], m.mx5[3], m.mx5[4]};
    const RowScalars sc = ktt::row_scalars(mv);
    float best = -INFINITY;
    int best_n = ktt::PW_IMAX;
    for (int i = tid; i < ns; i += nt) {
      if (!feas_r[i]) continue;
      const int n = lo + i;
      int l;
      const FullArgs& g = ktt::view_at<SH>(a, views, nl, n, l);
      const float total = ktt::node_total(g, sc, ps.prow * g.N + l, base_r[i], sraw_r[i], ipraw_r[i]);
      if (total > best) {  // nodes ascend per thread: keeps the lowest index
        best = total;
        best_n = n;
      }
    }
    warp_best(best, best_n);
    if (lane == 0) {
      m.redv[warp] = best;
      m.redi[warp] = best_n;
    }
    __syncthreads();
    if (warp == 0) {
      best = lane < nw ? m.redv[lane] : -INFINITY;
      best_n = lane < nw ? m.redi[lane] : ktt::PW_IMAX;
      warp_best(best, best_n);
      if (lane == 0) m.key = Key{best, best_n};
    }
    KTT_PHASE(PH_TOTAL);
    cl.sync();
    KTT_PHASE(PH_CLUSTER);
    // 4. the commit, warp 0 of every block: the kc blocks' keys (warp 0
    // alone reads them), the owner's usage and ports, the commit entries,
    // total_t and pod p+1's waiver
    if (warp == 0) {
      Key k{-INFINITY, ktt::PW_IMAX};
      if (lane < kc) k = *cl.map_shared_rank(&m.key, lane);
      warp_best(k.v, k.n);
      const int choice = k.v > -INFINITY ? k.n : -1;
      if (q == 0 && lane == 0) choices[p] = choice;
      int n_ent = 0;
      if (choice >= 0) {
        int cn;  // the chosen node's id in its view (its owner shard's)
        const FullArgs& g = ktt::view_at<SH>(a, views, nl, choice, cn);
        if (choice >= lo && choice < lo + ns) {  // the owner: usage and ports of its node
          for (int r = lane; r < a.R; r += 32) {
            int32_t* u = g.used + (int64_t)cn * a.R + r;
            *u = ktt::wadd(__ldcg(u), ps.req[r]);
          }
          for (int c = lane; c < ps.n_port; c += 32) g.ports_used[(int64_t)cn * a.PT + ps.port[c]] = 1;
        }
        const int nm = ps.n_m, na = ps.n_an, npf = a.ips ? ps.n_pf : 0;
        const int naf = a.ips && a.hpaw != 0.0f ? ps.n_af : 0;
        n_ent = a.pw ? nm + na + npf + naf : 0;
        for (int e0 = lane; e0 < n_ent; e0 += 32) {  // pairwise.cuh commit_entries' order, a lane an entry
          int e = e0;
          CommitEnt ce;
          if (e < nm) {
            ce = CommitEnt{0, ps.m_t[e], 0, ps.m_v[e]};
          } else if ((e -= nm) < na) {
            ce = CommitEnt{1, ps.an_t[e], 0, 1.0f};
          } else if ((e -= na) < npf) {
            ce = CommitEnt{2, ps.pf_t[e], 0, ps.pf_w[e]};
          } else {
            ce = CommitEnt{2, ps.af_t[e - npf], 0, a.hpaw};
          }
          ce.dcol = g.dbt[(int64_t)ce.t * g.N + cn];  // the owner's domain column (_gather_at_nodes)
          m.ents[e0] = ce;
        }
        __syncwarp();
        if (lane == 0)  // the matched weights into total_t where the key is present, in entry order
          for (int e = 0; e < nm; ++e) {
            const CommitEnt ce = m.ents[e];
            if (ce.dcol < a.D) tt[ce.t] = tt[ce.t] + ce.w;
          }
      }
      if (lane == 0) {
        m.n_ent = n_ent;
        if (p + 1 < a.P && a.pw) waiver(nx, tt);
      }
    }
    __syncthreads();  // the commit, and pod p+1's slots and waiver
    KTT_PHASE(PH_COMMIT);
    // the entries at the run's nodes, a thread a node, then pod p+1's
    // spread partials at the same nodes (each node's planes are its
    // thread's alone: no barrier between)
    const int n_ent = m.n_ent;
    if (n_ent > 0)
      for (int i = tid; i < ns; i += nt) {
        int l;
        const FullArgs& g = ktt::view_at<SH>(a, views, nl, lo + i, l);
        for (int e = 0; e < n_ent; ++e) ktt::apply_entry(g, m.ents[e], l);
      }
    if (p + 1 < a.P) spread_partial<SH>(a, views, nl, nx, lo, ns, v);
    KTT_PHASE(PH_APPLY);
  }
  __syncthreads();
  if (q == 0) {  // total_t: every shard's copy takes the same values
    if constexpr (SH) {
      for (int s = 0; s < tab.S; ++s)
        for (int t = tid; t < a.T; t += nt) views[s].total_t[t] = tt[t];
    } else {
      for (int t = tid; t < a.T; t += nt) a.total_t[t] = tt[t];
    }
  }
  cl.sync();  // no block leaves while another may read its exchange
}

// the launch's cluster, per mode: asked of the runtime again only when the
// device, N, T or the cap changes (each query costs host time)
struct ClusterChoice {
  int dev = -1, N = 0, T = 0, max_kc = 0;
  int kc = 0;
  size_t smem = 0;
};

// one cluster of the widest width <= max_kc (and <= one block per MIN_RUN
// nodes of a.N) that the card schedules; refused when none
template <bool SH>
int launch_full(const FullArgs& a, const ktt::ShardTable& tab, void* choices, int max_kc, int* kc_out,
                void* stream) {
  static ClusterChoice memo;
  auto kernel = full_scan_kernel<SH>;
  // the dynamic shared memory a block may take beside its static buffers
  constexpr size_t cap_smem = SMEM_CAP - (SH ? ktt::PW_MAX_SHARDS * sizeof(FullArgs) : 0);
  if (max_kc < 1 || max_kc > MAX_KC) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (memo.dev != dev || memo.N != a.N || memo.T != a.T || memo.max_kc != max_kc) {
    ClusterChoice c;
    const int cap = a.N / MIN_RUN < max_kc ? a.N / MIN_RUN : max_kc;
    for (int k = cap > 1 ? cap : 1; k >= 1 && c.kc == 0; --k) {
      const size_t smem = dyn_smem(a.T, (a.N + k - 1) / k);
      if (smem <= cap_smem && ktt::cluster_fits(kernel, k, ktt::PW_NT, smem)) {
        c.kc = k;
        c.smem = smem;
      }
    }
    if (c.kc == 0) return (int)cudaErrorInvalidConfiguration;  // refused: the card schedules no such cluster
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
    if (err != cudaSuccess) return (int)err;
    c.dev = dev;
    c.N = a.N;
    c.T = a.T;
    c.max_kc = max_kc;
    memo = c;
  }
  if (kc_out != nullptr) *kc_out = memo.kc;
  return (int)ktt::launch_cluster(kernel, memo.kc, ktt::PW_NT, memo.smem, reinterpret_cast<cudaStream_t>(stream), a,
                                  tab, static_cast<int32_t*>(choices));
}

}  // namespace

// ip / fp: the score parameters (score.cuh make_score_params), host memory;
// wp: the stage weights (taint, node affinity, spread, inter-pod, image,
// hardPodAffinityWeight); sw: the stage switches (pairwise, interpod score,
// ports, taint, node affinity, image); dims: P, N, R, T, D, PT, CS, A1, A2,
// B, M; ptrs[27..33]: done and the start state (pairwise.cuh read_gate);
// max_kc: the widest cluster to take (1..16); kc_out (host, or NULL): the
// cluster width launched
extern "C" int ktt_full_scan(const void* const* ptrs, const int* dims, const int* sw, const float* wp,
                             const int* ip, const float* fp, void* choices, int max_kc, int* kc_out, void* stream) {
  FullArgs a;
  const int bad = ktt::read_full_args(ptrs, dims, sw, wp, ip, fp, a);
  if (bad) return bad;
  const ktt::ShardTable tab{};
  return launch_full<false>(a, tab, choices, max_kc, kc_out, stream);
}

// shard mode: ptrs / dims / sw / wp / ip / fp as ktt_full_scan's for shard
// 0's arrays (the pod side; dims[1] = nl; done NULL); shard_ptrs: S rows of
// pairwise.cuh ShardPtrs' 18 pointers; max_kc / kc_out as ktt_full_scan's.
// full_scan_kernel<true>: the one-device launch of one cluster over the
// S * nl global ids.
extern "C" int ktt_full_scan_shard(const void* const* ptrs, const int* dims, const int* sw, const float* wp,
                                   const int* ip, const float* fp, const void* const* shard_ptrs, int S,
                                   void* choices, int max_kc, int* kc_out, void* stream) {
  FullArgs a;
  const int bad = ktt::read_full_args(ptrs, dims, sw, wp, ip, fp, a);
  if (bad) return bad;
  if (S < 1 || S > ktt::PW_MAX_SHARDS || a.done != nullptr) return (int)cudaErrorInvalidValue;
  const ktt::ShardTable tab = ktt::make_shard_table(shard_ptrs, S, a.N);
  a.N = S * a.N;
  a.W = (a.N + 31) / 32;
  // every node-side access goes through a shard's view: the launch keeps the
  // pod side and the replicated total0 only
  a.sfs = a.eligs = nullptr;
  a.traw = a.naraw = a.img_s = nullptr;
  a.alloc = a.dbt = nullptr;
  a.used = nullptr;
  a.cnt = a.antin = a.pref = a.total_t = nullptr;
  a.ports_used = nullptr;
  a.used0 = nullptr;
  a.cnt0 = a.anti0 = a.pref0 = nullptr;
  a.ports0 = nullptr;
  return launch_full<true>(a, tab, choices, max_kc, kc_out, stream);
}

#ifdef KTT_FULL_PHASES
// cycles, hits: host arrays of PH_N; reads block 0's phase counters, then
// zeroes them
extern "C" int ktt_full_scan_phases(unsigned long long* cycles, unsigned long long* hits) {
  const unsigned long long zero[PH_N] = {};
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(hits, g_phase_hits, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_hits, zero, sizeof(zero));
  return (int)err;
}
#endif
