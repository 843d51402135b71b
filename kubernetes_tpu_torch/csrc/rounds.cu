// K12 rounds: the rounds scan for the full stage set, dense and class-row
// mode.
//
// Replaces the lax.scan(chunk, ...) of the JAX package's ops/assign.py:1464
// schedule_scan_rounds (inc=None, and inc= through the class index: the
// class-row mode of pairwise.cuh, one kernel with an indirection) with its
// body: per chunk of C = 16 pods
// (KTPU_RCHUNK) the share incidence (:1771-1795), then the round loop
// (:1830-2212) until every pod of the chunk is committed — the exact
// re-hoist of each uncommitted pod against round-start state (:1832-1919),
// dispersal speculation over the pod's top-Zr, Zr = min(32, N) (:1920-1936),
// the exact repair under the intra-round prefix (:1938-2056, repair_iters
// times), the commit of the longest confirmed prefix plus the first
// divergence-only pod (:2062-2080) and the absorb into usage, ports and the
// count planes (:2082-2211) — and the ordinals of :2225-2235 (the rounds of
// the earlier chunks plus the pod's own round).  The base score is computed
// against the current usage instead of being patched at committed columns
// (dense mode: the [C, N] chunk hoist; class-row mode: the carried [U1, N]
// class hoist, :1820-1826, :2199-2224): every form gives the score of the
// same usage row, bit for bit, so the class-row mode reads no base_u.
//
// Design: one cooperative persistent launch walks the P / C chunks in
// order, with no host synchronisation per chunk or per round.  The grid is
// C thread-block clusters of kc blocks of 1024 threads: the widest cluster
// (<= 8) of which the card holds C at once, as the cooperative launch
// needs, and no more than one block per 32 nodes.  Cluster b holds pod b
// of the chunk; block (b, q) works on the q-th of kc near-equal runs of the
// node axis (at config 3 1024 nodes, one a thread), and the cluster
// combines through distributed shared memory.  Every block keeps the chunk's state
// (committed, out, ordinals, argmaxes, speculation, repair) in its shared
// memory, alike, so only the writes to the shared state need a single
// writer.  A round:
//   A. (cluster b, pod b uncommitted) the exact re-hoist on the runs:
//      the spread minMatch partials -> cluster barrier -> their max (order
//      free); feasibility and raws into the [C, N] row scratch, the five
//      normalisation maxima -> cluster barrier -> their max; the masked
//      total row and each block's top-32 keys by lax.top_k's order
//      (topk.cuh block_top32: warp shuffles, five block barriers) ->
//      cluster barrier -> the leader's warp 0 folds the kc lists (keys are
//      distinct: the node id is in the key) into the pod's top-Zr and its
//      argmax c0 -> grid barrier;
//   B. every block alike: the ranks among the earlier uncommitted pods
//      sharing an argmax, the speculation c;
//   C. cluster b repairs pod b: the leader rescoring the candidate
//      columns c_j, a warp each (any block's columns: the row scratch is
//      read through L2), under the exact int32 prefix usage, every block the best
//      unpicked round-start score of its run -> an exchange slot each (by
//      iteration parity) -> grid barrier -> every block alike: t and the
//      hazard of every pod;
//   D. every block alike: the commit prefix (a ballot finds the first
//      mismatch), and the round's commit entries in shared memory, in the
//      JAX absorb's order; block i adds pod i's request to the usage
//      (atomically), sets its ports; one warp adds the matched weights to
//      total_t, a lane per term, each term's adds in order;
//   E. every block applies the entries to its share of the [T, N] planes, a
//      thread per (column, plane and term) adding that term's weights in
//      entry order -> grid barrier.
// Three grid barriers a round (one more per further repair iteration) and
// three cluster barriers; every cross-block read goes through L2 (__ldcg)
// or the cluster's shared memory.  A chunk that does not finish in C
// rounds (every round commits a pod, so the algorithm rules it out) stops
// and reports it in the status, which the wrapper's caller raises on.  The
// first design (a block per pod, block 0 alone speculating and committing
// on one thread, five grid barriers a round) spent its rounds waiting: at
// config 3 the mean block's barrier time was 44% the slowest pod's 6144-node
// row pass and 24% block 0's serial commit (bench/rounds_phases.py).
//
// SHARD MODE (rounds_kernel<true>; the JAX package's schedule_scan_rounds
// under shard_map, axis_name set: ops/assign.py:1464, collectives at
// :1586-1592, :1803-1812, :1864-1911, :1933, :1966-2034, :2115-2145), dense
// and class-row: the same kernel over S node shards of nl nodes, shard s
// owning the global ids [s * nl, (s + 1) * nl).  A block's run is one
// range of global ids and may span shards, or start inside a shard's
// packed word (nl need not divide by 32: the per-shard packed planes pack
// per shard); the cut is by node count, not by words, so on 5 shards of
// config 3 (N pads to 6145) one run holds 1025 nodes, its last the invalid
// pad, where 33-word runs would hold up to 1037 and take a second node on
// some threads.  A node is read through its shard's view (pairwise.cuh
// shard_view: its planes, count planes, ports, alloc and its own total_t
// copy, at local ids), one FullArgs a shard in shared memory; the row
// scratch, the usage (one replicated [N, R] copy, which the JAX package
// all-gathers once per step and carries replicated) and the exchange are
// indexed by global id.  So each JAX collective becomes the single-device
// combination: the spread pmin and _rmax are the cluster's maxima (order
// free), _global_top_k the fold of the kc top-32 lists (keys carry the
// global id: ties to the lower id, the lower shard position), _gather_cols
// the candidate's owner view, _gather_at_nodes the commit's domain column
// from the owner's dbt; the commit entries are section-major as on one
// device (the pod-major order of the first shard design was ROADMAP C4),
// and every shard's total_t copy takes the same adds in the same order.
// The launch's own node-side pointers are NULL in shard mode, except the
// replicated usage and shard 0's total_t (the waiver reads it).  The gated
// mode is refused here.
//
// Bounds on an H100 at config 3 (640 chunks, 1691 rounds in the JAX run):
// the bytes are the packed static and eligibility planes and the pod
// arrays read once (~16 MB, >= 5 us at 3.35 TB/s); the operations are each
// round's re-hoist, ~60 f32 per (pod, node) feasible for it.  Neither sets
// the time: the chain of rounds, three grid barriers and the block-wide
// passes of each, does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pairwise.cuh"
#include "topk.cuh"

namespace cg = cooperative_groups;

namespace {

using ktt::CommitEnt;
using ktt::FullArgs;
using ktt::PodSlots;
using ktt::RowScalars;

constexpr int MAXC = 32;
constexpr int ZR_MAX = 32;

// the scratch (ktt_rounds' sp[0..7] and sp[13]; sp[8..12] and sp[14] are
// not read)
struct RoundsScratch {
  uint8_t* feas;  // [C, N]
  float* base;    // [C, N]
  float* sraw;    // [C, N]
  float* ipraw;   // [C, N]
  float* total;   // [C, N]
  float* topv;    // [C, ZR_MAX] each pod's top-Zr this round
  int32_t* topi;  // [C, ZR_MAX]
  int32_t* c0;    // [C] each pod's argmax this round
  int32_t* x;     // [C * max entries per pod * 4] the repair's exchange (RepairX)
};

#ifdef KTT_ROUNDS_PHASES
// A build with -DKTT_ROUNDS_PHASES (kubernetes_tpu_torch/bench/rounds_phases.py)
// makes thread 0 of every block add the SM cycles between the round loop's
// phase boundaries into g_block_cycles[phase][block] (block 0's also into
// g_phase_cycles, with each boundary counted in g_phase_hits).  A phase's
// cycles are the block's own work in it; the waits at the grid barriers
// that close the phases are PH_BARRIER.  With a log set (ktt_rounds_log),
// every block also writes each grid barrier's wait, tagged with its site
// (BS_*), into its row of the log: the block that arrived last waited the
// least, and its wait is the barrier's own latency.  The waits at the
// cluster barriers of the re-hoist are PH_CLUSTER (only the clusters of
// uncommitted pods pass them, so they are not in the grid's log).
enum {
  PH_CHUNK,
  PH_SPREAD,
  PH_FEAS,
  PH_TOTAL,
  PH_TOPK,
  PH_MERGE,
  PH_CLUSTER,
  PH_SPECULATE,
  PH_RESCORE,
  PH_REPAIR,
  PH_COMMIT,
  PH_APPLY,
  PH_BARRIER,
  PH_N
};
enum { BS_START, BS_ROWS, BS_REPAIRED, BS_ROUND, BS_N };
constexpr int PH_MAX_BLOCKS = 256;
__device__ unsigned long long g_phase_cycles[PH_N];
__device__ unsigned long long g_phase_hits[PH_N];
__device__ unsigned long long g_block_cycles[PH_N * PH_MAX_BLOCKS];
__device__ unsigned long long* g_bar_log;
__device__ int g_bar_cap;
#define KTT_PHASE(k)                                                                          \
  do {                                                                                        \
    if (threadIdx.x == 0) {                                                                   \
      const long long now = clock64();                                                        \
      const unsigned long long d = (unsigned long long)(now - ph_t);                          \
      if (blockIdx.x < PH_MAX_BLOCKS) g_block_cycles[(k) * PH_MAX_BLOCKS + blockIdx.x] += d; \
      if (blockIdx.x == 0) {                                                                  \
        g_phase_cycles[k] += d;                                                               \
        g_phase_hits[k] += 1;                                                                 \
      }                                                                                       \
      ph_t = now;                                                                             \
    }                                                                                         \
  } while (0)
#define KTT_GRID_SYNC(site)                                                                    \
  do {                                                                                         \
    const long long t_ = clock64();                                                            \
    grid.sync();                                                                               \
    if (threadIdx.x == 0) {                                                                    \
      if (g_bar_log != nullptr && bar_i < g_bar_cap)                                           \
        g_bar_log[(long long)blockIdx.x * g_bar_cap + bar_i] =                                 \
            ((unsigned long long)(site) << 56) | (unsigned long long)(clock64() - t_);         \
      ++bar_i;                                                                                 \
    }                                                                                          \
  } while (0)
#define KTT_PH_PARAM , long long& ph_t
#define KTT_PH_ARG , ph_t
#else
#define KTT_PHASE(k) ((void)0)
#define KTT_GRID_SYNC(site) grid.sync()
#define KTT_PH_PARAM
#define KTT_PH_ARG
#endif

// term sets: does any valid id of x[0..nx) occur in y[0..ny) (with yw: a
// nonzero weight)?
__device__ bool meets(const int32_t* x, int nx, const int32_t* y, int ny, const float* yw = nullptr) {
  for (int k = 0; k < nx; ++k) {
    if (x[k] < 0) continue;
    for (int l = 0; l < ny; ++l)
      if (y[l] == x[k] && (yw == nullptr || yw[l] != 0.0f)) return true;
  }
  return false;
}

// share(i, j): j's state writes touch a term i reads, or their host ports
// overlap (the incidence products of assign.py:1771-1795 as set tests)
__device__ bool share_of(const FullArgs& a, int64_t i, int64_t j) {
  bool s = false;
  if (a.pw) {
    const int32_t* mt_j = a.mt + j * a.M;
    const float* mv_j = a.mv + j * a.M;
    const int32_t* mt_i = a.mt + i * a.M;
    s = meets(a.spread_t + i * a.CS, a.CS, mt_j, a.M, mv_j) || meets(a.aff + i * a.A1, a.A1, mt_j, a.M, mv_j) ||
        meets(a.anti + i * a.A2, a.A2, mt_j, a.M, mv_j) || meets(mt_i, a.M, a.anti + j * a.A2, a.A2);
    if (a.ips) {
      s = s || meets(a.pref_t + i * a.B, a.B, mt_j, a.M, mv_j) || meets(mt_i, a.M, a.pref_t + j * a.B, a.B) ||
          (a.hpaw != 0.0f && meets(mt_i, a.M, a.aff + j * a.A1, a.A1));
    }
  }
  if (a.ports)
    for (int q = 0; q < a.PT && !s; ++q) s = a.pod_ports[i * a.PT + q] && a.pod_ports[j * a.PT + q];
  return s;
}

// The node axis: N global ids over S shards of nl nodes (shard s owns
// [s * nl, (s + 1) * nl); one device: S = 1, nl = N), cut into kc
// near-equal runs of ids, one a cluster rank (a run may span shards).
struct Axis {
  int N, S, nl;
  __device__ int run_lo(int q, int kc) const { return (int)((int64_t)q * N / kc); }
};

// node n's view (the launch's arguments on one device, its shard's in
// shard mode) and its id l there
template <bool SH>
__device__ __forceinline__ const FullArgs& view_at(const FullArgs& a, const FullArgs* views, int nl, int n, int& l) {
  if constexpr (SH) {
    const int s = n / nl;
    l = n - s * nl;
    return views[s];
  } else {
    l = n;
    return a;
  }
}

// candidate column c_j in the repair of pod i: node cl of view v (global
// id `id`, its row scratch column) rescored under the exact prefix usage
// (used_at(r): the node's usage plus the int32 adds of the earlier active
// pods that picked it), with pod i's round-start raws and scalars -> (mj,
// bn = id, hard: a shared term, or a fit drop at a normalisation extreme)
template <class UsedAt>
__device__ __forceinline__ void rescore_at(const FullArgs& a, const FullArgs& v, const RowScalars& rs,
                                           const PodSlots& ps, int share_j, const uint8_t* feas_i,
                                           const float* sraw_i, const float* ipraw_i, int cl, int id, UsedAt used_at,
                                           float& mj, int& bn, int& hard) {
  const int64_t nr = (int64_t)cl * a.R;
  const int* req = ps.req;
  const bool fit = ktt::fit_ok(a.R, [&](int r) { return req[r]; }, used_at, [&](int r) { return v.alloc[nr + r]; });
  const float baseij = ktt::score_flat(a.sp, [&](int r) { return ktt::wadd(used_at(r), req[r]); },
                                       [&](int r) { return v.alloc[nr + r]; });
  const bool f0 = __ldcg(feas_i + id);
  const float sr = f0 ? __ldcg(sraw_i + id) : 0.0f;
  const float ir = f0 ? __ldcg(ipraw_i + id) : 0.0f;
  const int64_t pn = ps.prow * v.N + cl;
  const float nt = ktt::node_total(v, rs, pn, baseij, sr, ir);
  mj = (f0 && fit) ? nt : -INFINITY;
  bn = id;
  bool extreme = false;
  if (a.taint) extreme = extreme || (rs.t_mx > 0.0f && ktt::bf(v.traw, pn) == rs.t_mx);
  if (a.nap) extreme = extreme || (rs.na_mx > 0.0f && ktt::bf(v.naraw, pn) == rs.na_mx);
  if (a.pw) extreme = extreme || (rs.s_mx > 0.0f && sr == rs.s_mx);
  if (a.ips) extreme = extreme || (rs.ip_mx > rs.ip_mn && (ir == rs.ip_mx || ir == rs.ip_mn));
  hard = share_j || (f0 && !fit && extreme);
}

// rescore_at with the prefix usage of column cl in an int[SCORE_MAX_R] row
// (same(k): pod k of the chunk is active on this column)
template <class Same>
__device__ __forceinline__ void rescore(const FullArgs& a, const FullArgs& v, const RowScalars& rs,
                                        const PodSlots& ps, int share_j, const uint8_t* feas_i, const float* sraw_i,
                                        const float* ipraw_i, int c0p, int i, int cl, int id, Same same, float& mj,
                                        int& bn, int& hard) {
  int uij[ktt::SCORE_MAX_R];
  for (int r = 0; r < a.R; ++r) uij[r] = __ldcg(v.used + (int64_t)cl * a.R + r);
  for (int k = 0; k < i; ++k)
    if (same(k))
      for (int r = 0; r < a.R; ++r) uij[r] = ktt::wadd(uij[r], a.preq[(c0p + k) * a.R + r]);
  rescore_at(a, v, rs, ps, share_j, feas_i, sraw_i, ipraw_i, cl, id, [&](int r) { return uij[r]; }, mj, bn, hard);
}

constexpr int RESCORE_R = 8;  // resources rescore_regs keeps in registers

// rescore with the usage row in registers (R <= RESCORE_R, a select over
// the unrolled row where rescore indexes an int[SCORE_MAX_R] array: that
// array lives in local memory, and 1024 threads' frames do not stay in L1)
template <class Same>
__device__ __forceinline__ void rescore_regs(const FullArgs& a, const FullArgs& v, const RowScalars& rs,
                                             const PodSlots& ps, int share_j, const uint8_t* feas_i,
                                             const float* sraw_i, const float* ipraw_i, int c0p, int i, int cl,
                                             int id, Same same, float& mj, int& bn, int& hard) {
  const int64_t nr = (int64_t)cl * a.R;
  int u[RESCORE_R];
#pragma unroll
  for (int r = 0; r < RESCORE_R; ++r) u[r] = r < a.R ? __ldcg(v.used + nr + r) : 0;
  for (int k = 0; k < i; ++k)
    if (same(k)) {
      const int32_t* rq = a.preq + (int64_t)(c0p + k) * a.R;
#pragma unroll
      for (int r = 0; r < RESCORE_R; ++r)
        if (r < a.R) u[r] = ktt::wadd(u[r], rq[r]);
    }
  auto used_at = [&](int r) {
    int x0 = 0;
#pragma unroll
    for (int x = 0; x < RESCORE_R; ++x)
      if (x == r) x0 = u[x];
    return x0;
  };
  rescore_at(a, v, rs, ps, share_j, feas_i, sraw_i, ipraw_i, cl, id, used_at, mj, bn, hard);
}

constexpr int MAX_ENT = ktt::PW_MAX_M + 3 * ktt::PW_MAX_S;  // commit entries of one pod
constexpr int MAX_KC = 8;  // blocks per cluster: the portable cluster size

// one block's shared memory.  "cluster": the same in every block of the
// cluster (pod b's); "alike": the same in every block of the grid
struct ClusterSmem {
  PodSlots ps;    // cluster
  RowScalars rs;  // cluster: the round-start normalisation scalars
  float red[ktt::PW_MAX_S * 32];
  int redi[32];
  unsigned long long topk_keys[ktt::PW_NWARP * 32];  // block_top32's scratch; A3: [0, 32) its run's top keys
  // read by the cluster's other blocks through distributed shared memory
  float part[ktt::PW_MAX_S];  // A1: this block's max of -count per spread slot
  float part5[5];             // A2: its normalisation maxima
  float mx5[5];               // cluster: the combined maxima
  int share[MAXC];  // cluster: share(b, j)
  float rv[MAXC];   // the leader's rescored candidates (value, node, hazard)
  int rn[MAXC], rh[MAXC];
  // the chunk state, alike
  int committed[MAXC], out[MAXC], ord[MAXC], c0[MAXC], c[MAXC], t[MAXC], hard[MAXC];
  int newly[MAXC], cf[MAXC];
  int cnt[4 * MAXC], off[4 * MAXC];  // commit entries per (section, pod), their first slots
  int nrounds, base_rounds, status, cont, n_ents, n_lead;
  int rlo[MAX_KC];  // the first global id of each block's run in the cluster
};

// the repair's exchange (the scratch's sp[13]: the commit entries live in
// shared memory): per iteration parity, pod i's rescored candidate (vb, bn,
// hard) from its cluster's leader and each of its blocks' best unpicked
// node (av, an), 6 C + 4 C kc words
struct RepairX {
  int32_t* x;
  int C, kc;
  __device__ int32_t* cand(int par, int i) const { return x + ((int64_t)par * C + i) * 3; }
  __device__ int32_t* best(int par, int i, int q) const { return x + 6 * C + (((int64_t)par * C + i) * kc + q) * 2; }
};

// pairwise.cuh load_pod's slots of pod p, a warp a section (lanes over the
// slots, a ballot's prefix keeping the slot order): the request and flags,
// spread, required affinity (and whether the pod matches all of it), anti,
// matched terms, preferred terms, host ports.  The caller synchronises.
__device__ void load_pod_warps(const FullArgs& a, int p, PodSlots& ps) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t q = p;
  const unsigned lt = (1u << lane) - 1u;
  if (w == 0) {
    for (int r = lane; r < a.R; r += 32) ps.req[r] = a.preq[q * a.R + r];
    if (lane == 0) {
      ps.valid = a.pvalid[p];
      ps.prow = a.cls != nullptr ? (int64_t)a.cls[p] : q;
      if (!a.pw) {
        ps.n_sp = ps.n_af = ps.n_an = ps.n_m = 0;
        ps.self_all = 1;
      }
      if (!a.pw || !a.ips) ps.n_pf = 0;
      if (!a.ports) ps.n_port = 0;
    }
  } else if (a.pw && w == 1) {
    const int t = lane < a.CS ? a.spread_t[q * a.CS + lane] : -1;
    const unsigned b = __ballot_sync(ktt::PW_FULL, t >= 0);
    if (t >= 0) {
      const int k = __popc(b & lt);
      ps.sp_t[k] = t;
      ps.sp_skew[k] = a.skew[q * a.CS + lane];
      ps.sp_hard[k] = a.hard[q * a.CS + lane];
    }
    if (lane == 0) ps.n_sp = __popc(b);
  } else if (a.pw && w == 2) {
    const int t = lane < a.A1 ? a.aff[q * a.A1 + lane] : -1;
    const unsigned b = __ballot_sync(ktt::PW_FULL, t >= 0);
    const unsigned other = __ballot_sync(ktt::PW_FULL, t >= 0 && !a.aself[q * a.A1 + lane]);
    if (t >= 0) ps.af_t[__popc(b & lt)] = t;
    if (lane == 0) {
      ps.n_af = __popc(b);
      ps.self_all = other == 0u;
    }
  } else if (a.pw && w == 3) {
    const int t = lane < a.A2 ? a.anti[q * a.A2 + lane] : -1;
    const unsigned b = __ballot_sync(ktt::PW_FULL, t >= 0);
    if (t >= 0) ps.an_t[__popc(b & lt)] = t;
    if (lane == 0) ps.n_an = __popc(b);
  } else if (a.pw && w == 4) {
    const int t = lane < a.M ? a.mt[q * a.M + lane] : -1;
    const unsigned b = __ballot_sync(ktt::PW_FULL, t >= 0);
    if (t >= 0) {
      const int k = __popc(b & lt);
      ps.m_t[k] = t;
      ps.m_v[k] = a.mv[q * a.M + lane];
    }
    if (lane == 0) ps.n_m = __popc(b);
  } else if (a.pw && a.ips && w == 5) {
    const int t = lane < a.B ? a.pref_t[q * a.B + lane] : -1;
    const unsigned b = __ballot_sync(ktt::PW_FULL, t >= 0);
    if (t >= 0) {
      const int k = __popc(b & lt);
      ps.pf_t[k] = t;
      ps.pf_w[k] = a.pref_w[q * a.B + lane];
    }
    if (lane == 0) ps.n_pf = __popc(b);
  } else if (a.ports && w == 6) {
    int n = 0;
    for (int c0 = 0; c0 < a.PT; c0 += 32) {
      const int c = c0 + lane;
      const bool on = c < a.PT && a.pod_ports[q * a.PT + c];
      const unsigned b = __ballot_sync(ktt::PW_FULL, on);
      if (on) ps.port[n + __popc(b & lt)] = c;
      n += __popc(b);
    }
    if (lane == 0) ps.n_port = n;
  }
}

// the block's max of v[0..n) (n <= KR, the same in every thread) into
// out[0..n) in shared memory: a warp shuffle per value, then thread k over
// the warps' maxima of value k, in warp order.  Every thread calls it; it
// begins and ends with a barrier.
template <int KR>
__device__ void block_max_into(float (&v)[KR], int n, float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    if (k >= n) break;
    for (int off = 16; off > 0; off >>= 1) v[k] = fmaxf(v[k], __shfl_xor_sync(ktt::PW_FULL, v[k], off));
  }
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < KR; ++k)
      if (k < n) red[k * 32 + warp] = v[k];
  }
  __syncthreads();
  if ((int)threadIdx.x < n) {
    float x = -INFINITY;
    for (int w = 0; w < nw; ++w) x = fmaxf(x, red[threadIdx.x * 32 + w]);
    out[threadIdx.x] = x;
  }
  __syncthreads();
}

// A1: the pod's required-affinity waiver (thread 0) and, per spread slot,
// this block's max of -count over its keyed eligible nodes [lo, hi) ->
// m.part (the JAX pmin's partial, combined across the cluster)
template <bool SH>
__device__ void slice_spread(const FullArgs& a, const FullArgs* views, const Axis& ax, ClusterSmem& m, int lo,
                             int hi) {
  const PodSlots& ps = m.ps;
  if (threadIdx.x == 0) {
    float total_any = 0.0f;
    for (int k = 0; k < ps.n_af; ++k) total_any += __ldcg(a.total_t + ps.af_t[k]);
    m.ps.waiver = ps.n_af > 0 && total_any == 0.0f && ps.self_all;
  }
  float v[ktt::PW_MAX_S];
#pragma unroll
  for (int c = 0; c < ktt::PW_MAX_S; ++c) v[c] = -INFINITY;
  for (int n = lo + threadIdx.x; n < hi; n += blockDim.x) {
    int l;
    const FullArgs& g = view_at<SH>(a, views, ax.nl, n, l);
    if (!ktt::pw_bit(g.eligs, ps.prow, g.W, l)) continue;
#pragma unroll
    for (int c = 0; c < ktt::PW_MAX_S; ++c) {
      if (c >= ps.n_sp) break;
      const int64_t i = (int64_t)ps.sp_t[c] * g.N + l;
      if (g.dbt[i] < a.D) v[c] = fmaxf(v[c], -__ldcg(g.cnt + i));
    }
  }
  block_max_into(v, ps.n_sp, m.red, m.part);
}

// A2 and A3 on the run [lo, hi): feasibility, raws and the five maxima
// (combined across the cluster), then the masked total row and this block's
// top-32 keys (lax.top_k's order; the ids local to the run)
template <bool SH>
__device__ void slice_rows(const FullArgs& a, const FullArgs* views, const Axis& ax, ClusterSmem& m,
                           cg::cluster_group& cl, int kc, int p, int lo, int hi, uint8_t* feas_r, float* base_r,
                           float* sraw_r, float* ipraw_r, float* total_r KTT_PH_PARAM) {
  const PodSlots& ps = m.ps;
  const int tid = threadIdx.x;
  float mx[5] = {0.0f, 0.0f, 0.0f, -INFINITY, -INFINITY};
  for (int n = lo + tid; n < hi; n += blockDim.x) {
    int l;
    const FullArgs& g = view_at<SH>(a, views, ax.nl, n, l);
    float base = 0.0f, sraw = 0.0f, ipraw = 0.0f;
    const bool f = ktt::node_feasible(g, p, ps, l, base, sraw, ipraw);
    feas_r[n] = f;
    if (!f) continue;
    base_r[n] = base;
    sraw_r[n] = sraw;
    ipraw_r[n] = ipraw;
    const int64_t pn = ps.prow * g.N + l;
    if (a.taint) mx[0] = fmaxf(mx[0], ktt::bf(g.traw, pn));
    if (a.nap) mx[1] = fmaxf(mx[1], ktt::bf(g.naraw, pn));
    mx[2] = fmaxf(mx[2], sraw);
    mx[3] = fmaxf(mx[3], ipraw);
    mx[4] = fmaxf(mx[4], -ipraw);
  }
  block_max_into(mx, 5, m.red, m.part5);
  KTT_PHASE(PH_FEAS);
  cl.sync();
  KTT_PHASE(PH_CLUSTER);
  if (tid < 5) {
    float v = -INFINITY;
    for (int r = 0; r < kc; ++r) v = fmaxf(v, cl.map_shared_rank(m.part5, r)[tid]);
    m.mx5[tid] = v;
  }
  __syncthreads();
  const float mv[5] = {m.mx5[0], m.mx5[1], m.mx5[2], m.mx5[3], m.mx5[4]};
  const RowScalars sc = ktt::row_scalars(mv);
  if (tid == 0) m.rs = sc;
  for (int n = lo + tid; n < hi; n += blockDim.x) {
    float total = -INFINITY;
    if (feas_r[n]) {
      int l;
      const FullArgs& g = view_at<SH>(a, views, ax.nl, n, l);
      total = ktt::node_total(g, sc, ps.prow * g.N + l, base_r[n], sraw_r[n], ipraw_r[n]);
    }
    total_r[n] = total;
  }
  KTT_PHASE(PH_TOTAL);
  ktt::block_top32(total_r + lo, hi > lo ? hi - lo : 0, m.topk_keys);  // ids local to the run
  KTT_PHASE(PH_TOPK);
}

// A3's merge on the cluster's leader, warp 0: the kc blocks' top-32 keys
// (each list in key order; a key holds its node id, so keys are distinct;
// block r's ids shifted by its run's first id) folded pairwise into the
// top-zr of the pod's row in the scratch's [C, ZR_MAX] row b, and its
// argmax c0 (the first entry: the highest score, ties to the lower node)
__device__ void merge_top(ClusterSmem& m, cg::cluster_group& cl, int kc, const RoundsScratch& s, int b, int zr) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  unsigned long long keys[MAX_KC];
#pragma unroll
  for (int r = 0; r < MAX_KC; ++r)
    keys[r] = r < kc ? cl.map_shared_rank(m.topk_keys, r)[lane] : 0ull;
#pragma unroll
  for (int r = 0; r < MAX_KC; ++r)
    if (r < kc && keys[r] != 0ull)
      keys[r] = ktt::topk_key(ktt::key_value(keys[r]), ktt::topk_index(keys[r]) + m.rlo[r]);
#pragma unroll
  for (int w = 1; w < MAX_KC; w <<= 1)
#pragma unroll
    for (int r = 0; r + w < MAX_KC; r += 2 * w)
      if (r + w < kc) keys[r] = ktt::warp_fold(keys[r], keys[r + w]);
  if (lane < zr) {
    const float v = ktt::key_value(keys[0]);
    const int id = ktt::topk_index(keys[0]);
    s.topv[b * ZR_MAX + lane] = v;
    s.topi[b * ZR_MAX + lane] = id;
    if (lane == 0) s.c0[b] = (v > -INFINITY && m.ps.valid) ? id : -1;
  }
}

// B, every block alike: each pod's argmax and its rank among the earlier
// uncommitted pods sharing it; the pod takes its rank-th best node
__device__ void speculate(ClusterSmem& m, const RoundsScratch& s, int C, int zr) {
  const int i = threadIdx.x;
  if (i < C) m.c0[i] = m.committed[i] ? -1 : __ldcg(s.c0 + i);
  __syncthreads();
  if (i < C) {
    const int c0 = m.c0[i];
    int rank = 0;
    for (int j = 0; j < i; ++j)
      if (!m.committed[j] && m.c0[j] == c0 && c0 >= 0) ++rank;
    int c = c0;
    if (!m.committed[i] && c0 >= 0 && rank > 0 && rank < zr) {
      if (__ldcg(s.topv + i * ZR_MAX + rank) > -INFINITY) c = __ldcg(s.topi + i * ZR_MAX + rank);
    }
    m.c[i] = c;
  }
  __syncthreads();
}

__device__ __forceinline__ bool active(const ClusterSmem& m, int j) { return !m.committed[j] && m.c[j] >= 0; }

// C for pod i = b on the run [lo, hi): on the leader, lane 0 of warp j
// rescoring the candidate column c_j of each earlier active pod j under the
// exact prefix usage (a warp each, so the candidates' branches do not
// serialise one warp; the column read through its owner's view), every
// block the best unpicked round-start score of its run -> the exchange
template <bool SH>
__device__ void slice_repair(const FullArgs& a, const FullArgs* views, const Axis& ax, ClusterSmem& m,
                             const RoundsScratch& s, const RepairX& x, int c0p, int i, int q, int lo, int hi,
                             int par KTT_PH_PARAM) {
  const int tid = threadIdx.x, j = tid >> 5;
  const int64_t row = (int64_t)i * a.N;
  if (q == 0 && (tid & 31) == 0 && j < i) {  // lane 0 of warp j: no two candidates share a warp
    float mj = -INFINITY;
    int bn = ktt::PW_IMAX;
    int hard = 0;
    if (active(m, j)) {
      const int cn = m.c[j];
      int cl;
      const FullArgs& g = view_at<SH>(a, views, ax.nl, cn, cl);
      auto same = [&](int k) { return active(m, k) && m.c[k] == cn; };
      if (a.R <= RESCORE_R)
        rescore_regs(a, g, m.rs, m.ps, m.share[j], s.feas + row, s.sraw + row, s.ipraw + row, c0p, i, cl, cn,
                     same, mj, bn, hard);
      else
        rescore(a, g, m.rs, m.ps, m.share[j], s.feas + row, s.sraw + row, s.ipraw + row, c0p, i, cl, cn, same,
                mj, bn, hard);
    }
    m.rv[j] = mj;
    m.rn[j] = bn;
    m.rh[j] = hard;
  }
  KTT_PHASE(PH_RESCORE);
  float av = -INFINITY;
  int an = ktt::PW_IMAX;
  const float* total_i = s.total + row;
  for (int n = lo + tid; n < hi; n += blockDim.x) {
    bool picked = false;
    for (int k = 0; k < i && !picked; ++k) picked = active(m, k) && m.c[k] == n;
    if (picked) continue;
    const float v = total_i[n];
    if (ktt::pw_better(v, n, av, an)) {
      av = v;
      an = n;
    }
  }
  ktt::block_argmax(av, an, m.red, m.redi);  // its barriers also publish the candidates' results
  if (tid == 0) {
    int32_t* o = x.best(par, i, q);
    o[0] = __float_as_int(av);
    o[1] = an;
    if (q == 0) {  // the candidates' best (a strict order: any order of the max) and their hazards
      float vb = -INFINITY;
      int bn = ktt::PW_IMAX, hard = 0;
      for (int k = 0; k < i; ++k) {
        if (ktt::pw_better(m.rv[k], m.rn[k], vb, bn)) {
          vb = m.rv[k];
          bn = m.rn[k];
        }
        hard |= m.rh[k];
      }
      int32_t* c = x.cand(par, i);
      c[0] = __float_as_int(vb);
      c[1] = bn;
      c[2] = hard;
    }
  }
}

// every block alike, after the repair's barrier: pod i's repaired node t
// and its hazard from the exchange
__device__ void repaired(const FullArgs& a, ClusterSmem& m, const RepairX& x, int c0p, int C, int kc, int par) {
  const int i = threadIdx.x;
  if (i < C && !m.committed[i]) {
    const int32_t* o = x.cand(par, i);
    const float vb = __int_as_float(__ldcg(o));
    const int bn = __ldcg(o + 1);
    const int hard = __ldcg(o + 2);
    float av = -INFINITY;
    int an = ktt::PW_IMAX;
    for (int q = 0; q < kc; ++q) {
      const int32_t* w = x.best(par, i, q);
      const float v = __int_as_float(__ldcg(w));
      const int n = __ldcg(w + 1);
      if (ktt::pw_better(v, n, av, an)) {
        av = v;
        an = n;
      }
    }
    const float t_val = fmaxf(av, vb);
    const int t_n = vb > av ? bn : (av > vb ? an : min(an, bn));
    m.t[i] = (t_val > -INFINITY && a.pvalid[c0p + i]) ? t_n : -1;
    m.hard[i] = hard;
  }
  __syncthreads();
}

// D, every block alike: the longest confirmed prefix plus the first
// divergence-only pod (warp 0, one lane a pod), then the round's commit
// entries in shared memory, warp i writing pod i's.  Their order is the
// JAX package's absorb (ops/assign.py:2133-2180: one scatter-add a plane
// section, its rows the (pod, slot) flattening): the matched terms of
// every pod in pod order (cnt; total_t where the key is present), then
// the anti terms (anti), then with the interpod score the preferred terms
// and, at hardPodAffinityWeight, the required-affinity terms (pref), each
// pod's valid slots in slot order; the slots come from an exclusive prefix
// over the (section, pod) counts.  Only the f32 adds to one address need
// that order, and entries of one plane and term keep it.  The domain
// column of an entry comes from the chosen node's view (its owner shard's
// dbt in shard mode).
template <bool SH>
__device__ void commit(const FullArgs& a, const FullArgs* views, const Axis& ax, ClusterSmem& m, CommitEnt* ents,
                       int c0p, int C) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  if (tid < 32) {
    const int i = lane;
    const bool in = i < C;
    const bool unc = in && !m.committed[i];
    const unsigned bad = __ballot_sync(ktt::PW_FULL, unc && (m.hard[i] || m.t[i] != m.c[i]));
    const int firstbad = bad ? __ffs(bad) - 1 : C;
    const bool fb = unc && i == firstbad && !m.hard[i];
    const bool com = unc && (i < firstbad || fb);
    if (in) {
      m.newly[i] = com;
      if (com) {
        const int cf = fb ? m.t[i] : m.c[i];
        m.cf[i] = cf;
        m.out[i] = cf;
        m.ord[i] = m.nrounds;
        m.committed[i] = 1;
      }
    }
    const unsigned left = __ballot_sync(ktt::PW_FULL, in && !m.committed[i]);
    if (lane == 0) {
      ++m.nrounds;
      m.cont = left && m.nrounds < C;
      if (left && !m.cont) m.status = 1;  // the round cap: never on state the algorithm admits
      m.n_lead = 0;
    }
  }
  __syncthreads();
  const bool mine = a.pw && w < C && m.newly[w] && m.cf[w] >= 0;
  const int64_t p = c0p + w;
  unsigned sec[4] = {0u, 0u, 0u, 0u};  // the pod's valid slots: matched, anti, preferred, required affinity
  if (mine) {
    sec[0] = __ballot_sync(ktt::PW_FULL, lane < a.M && a.mt[p * a.M + lane] >= 0);
    sec[1] = __ballot_sync(ktt::PW_FULL, lane < a.A2 && a.anti[p * a.A2 + lane] >= 0);
    if (a.ips) {
      sec[2] = __ballot_sync(ktt::PW_FULL, lane < a.B && a.pref_t[p * a.B + lane] >= 0);
      if (a.hpaw != 0.0f) sec[3] = __ballot_sync(ktt::PW_FULL, lane < a.A1 && a.aff[p * a.A1 + lane] >= 0);
    }
  }
  if (w < C && lane < 4) m.cnt[lane * MAXC + w] = __popc(sec[lane]);
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int k = 0; k < 4 * MAXC; ++k) {
      if (k % MAXC >= C) continue;
      m.off[k] = n;
      n += m.cnt[k];
    }
    m.n_ents = n;
  }
  __syncthreads();
  if (mine) {
    int cl;
    const FullArgs& g = view_at<SH>(a, views, ax.nl, m.cf[w], cl);
    const unsigned lt = (1u << lane) - 1u;
    for (int k = 0; k < 4; ++k) {
      if (!((sec[k] >> lane) & 1u)) continue;
      int t;
      float wt;
      if (k == 0) {
        t = a.mt[p * a.M + lane];
        wt = a.mv[p * a.M + lane];
      } else if (k == 1) {
        t = a.anti[p * a.A2 + lane];
        wt = 1.0f;
      } else if (k == 2) {
        t = a.pref_t[p * a.B + lane];
        wt = a.pref_w[p * a.B + lane];
      } else {
        t = a.aff[p * a.A1 + lane];
        wt = a.hpaw;
      }
      ents[m.off[k * MAXC + w] + __popc(sec[k] & lt)] =
          CommitEnt{k < 2 ? k : 2, t, g.dbt[(int64_t)t * g.N + cl], wt};
    }
  }
  __syncthreads();
}

// D's writes to the shared state, one writer each: block i adds pod i's
// request to its node's usage (atomically: two pods of a round may share a
// node; the usage is indexed by global id in both modes) and sets its host
// ports; block 0's warp 1 + s adds the matched weights to view s's total_t
// (one device: the launch's), lane l the terms t = l mod 32, each term's
// adds in entry order
template <bool SH>
__device__ void commit_state(const FullArgs& a, const FullArgs* views, const Axis& ax, const ClusterSmem& m,
                             const CommitEnt* ents, int c0p, int C) {
  const int tid = threadIdx.x;
  const int i = blockIdx.x;
  if (i < C && m.newly[i] && m.cf[i] >= 0) {
    const int64_t p = c0p + i, cf = m.cf[i];
    if (tid < a.R) atomicAdd(a.used + cf * a.R + tid, a.preq[p * a.R + tid]);
    if (a.ports && tid < a.PT && a.pod_ports[p * a.PT + tid]) {
      int cl;
      const FullArgs& g = view_at<SH>(a, views, ax.nl, (int)cf, cl);
      g.ports_used[(int64_t)cl * a.PT + tid] = 1;
    }
  }
  const int w = tid >> 5;
  if (i == 0 && w >= 1 && w <= ax.S) {
    float* tt = SH ? views[w - 1].total_t : a.total_t;
    const int l = tid & 31;
    for (int k = 0; k < m.n_ents; ++k) {
      const CommitEnt e = ents[k];
      if (e.plane == 0 && e.dcol < a.D && (e.t & 31) == l) tt[e.t] = __ldcg(tt + e.t) + e.w;
    }
  }
}

// E: the entries applied to this block's columns of the [T, N] planes.
// Only entries of one (plane, term) touch one address, so each item is a
// (column, first entry of a (plane, term)) pair that adds that group's
// weights in entry order where the column shares the entry's domain
template <bool SH>
__device__ void apply(const FullArgs& a, const FullArgs* views, const Axis& ax, ClusterSmem& m,
                      const CommitEnt* ents, int* nxt, int* lead) {
  const int tid = threadIdx.x, n_ents = m.n_ents;
  for (int k = tid; k < n_ents; k += blockDim.x) {
    const CommitEnt e = ents[k];
    int nx = -1;
    for (int k2 = k + 1; k2 < n_ents; ++k2)
      if (ents[k2].plane == e.plane && ents[k2].t == e.t) {
        nx = k2;
        break;
      }
    nxt[k] = nx;
    bool first = true;
    for (int k2 = 0; k2 < k && first; ++k2) first = !(ents[k2].plane == e.plane && ents[k2].t == e.t);
    if (first) lead[atomicAdd(&m.n_lead, 1)] = k;
  }
  __syncthreads();
  const int n_lead = m.n_lead;
  const int G = gridDim.x;
  const int ew = (a.N + G - 1) / G;
  const int elo = blockIdx.x * ew;
  const int ncol = min(a.N, elo + ew) - elo;
  if (ncol <= 0 || n_lead == 0) return;
  for (int it = tid; it < ncol * n_lead; it += blockDim.x) {
    int cl;
    const FullArgs& g = view_at<SH>(a, views, ax.nl, elo + it / n_lead, cl);
    const int k0 = lead[it % n_lead];
    const CommitEnt e0 = ents[k0];
    const int64_t i = (int64_t)e0.t * g.N + cl;
    const int d = g.dbt[i];
    float* plane = e0.plane == 0 ? g.cnt : (e0.plane == 1 ? g.antin : g.pref);
    bool has = false;
    float v = 0.0f;
    for (int k = k0; k >= 0; k = nxt[k]) {
      if (ents[k].dcol != d) continue;
      if (!has) {
        v = __ldcg(plane + i);
        has = true;
      }
      v = v + ents[k].w;
    }
    if (has) plane[i] = v;
  }
}

// one device (SH false: `a` holds every node, tab is not read) or shard
// mode (SH true: `a` the pod side with N the global node count, tab the S
// shards' node-side pointers)
template <bool SH>
__global__ void __launch_bounds__(ktt::PW_NT) rounds_kernel(FullArgs a, ktt::ShardTable tab, RoundsScratch s, int C,
                                                            int iters, int32_t* choices, int32_t* ordinals,
                                                            int32_t* scal) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cl = cg::this_cluster();
  __shared__ ClusterSmem m;
  __shared__ FullArgs views[SH ? ktt::PW_MAX_SHARDS : 1];  // shard mode: each shard's view
  extern __shared__ int4 dyn[];
  const int tid = threadIdx.x;
  const int kc = (int)cl.num_blocks(), q = (int)cl.block_rank();
  const int b = blockIdx.x / kc;  // the cluster's pod of the chunk
  const int zr = a.N < ZR_MAX ? a.N : ZR_MAX;  // Zr = min(32, N) over the global N
  Axis ax;
  ax.N = a.N;
  ax.S = SH ? tab.S : 1;
  ax.nl = SH ? tab.sh[0].nl : a.N;
  // the block's run of the node axis
  const int lo = ax.run_lo(q, kc), hi = ax.run_lo(q + 1, kc);
  const int ent_cap = C * MAX_ENT;
  CommitEnt* ents = reinterpret_cast<CommitEnt*>(dyn);
  int* nxt = reinterpret_cast<int*>(ents + ent_cap);
  int* lead = nxt + ent_cap;
  const RepairX x{s.x, C, kc};
  // the gated mode: every block reads the same word, written by an earlier
  // launch in stream order, so the whole grid leaves before its first
  // barrier; a launch that passes writes its own start state
  if (a.done != nullptr && __ldcg(a.done)) return;
#ifdef KTT_ROUNDS_PHASES
  int bar_i = 0;
#endif
  const int64_t gt = (int64_t)blockIdx.x * blockDim.x + tid, gs = (int64_t)gridDim.x * blockDim.x;
  if constexpr (SH) {
    if (tid < ax.S) ktt::shard_view(a, tab.sh[tid], views[tid]);
    __syncthreads();
    for (int sh = 0; sh < ax.S; ++sh) ktt::copy_start_state(views[sh], gt, gs);
  } else {
    ktt::copy_start_state(a, gt, gs);
  }
  if (tid == 0) {
    m.base_rounds = 0;
    m.status = 0;
  }
  if (tid < kc) m.rlo[tid] = ax.run_lo(tid, kc);
  KTT_GRID_SYNC(BS_START);
#ifdef KTT_ROUNDS_PHASES
  long long ph_t = clock64();
#endif
  for (int c0p = 0; c0p < a.P; c0p += C) {
    const int p = c0p + b;
    load_pod_warps(a, p, m.ps);
    if (tid < C) {
      m.committed[tid] = 0;
      m.out[tid] = -1;
      m.ord[tid] = 0;
      m.share[tid] = share_of(a, p, c0p + tid);
    }
    if (tid == 0) m.nrounds = 0;
    __syncthreads();
    KTT_PHASE(PH_CHUNK);
    for (;;) {
      // A. the exact re-hoist of pod b over the cluster's runs (the
      // cluster's blocks see the same committed flag: all or none)
      if (!m.committed[b]) {
        const int64_t row = (int64_t)b * a.N;
        if (a.pw) {
          slice_spread<SH>(a, views, ax, m, lo, hi);
          KTT_PHASE(PH_SPREAD);
          cl.sync();
          KTT_PHASE(PH_CLUSTER);
          if (tid < m.ps.n_sp) {
            float v = -INFINITY;
            for (int r = 0; r < kc; ++r) v = fmaxf(v, cl.map_shared_rank(m.part, r)[tid]);
            const float mm = -v;  // the min over the cluster, inf -> 0
            m.ps.sp_mm[tid] = isinf(mm) ? 0.0f : mm;
          }
          __syncthreads();
          KTT_PHASE(PH_SPREAD);
        }
        slice_rows<SH>(a, views, ax, m, cl, kc, p, lo, hi, s.feas + row, s.base + row, s.sraw + row, s.ipraw + row,
                       s.total + row KTT_PH_ARG);
        cl.sync();
        KTT_PHASE(PH_CLUSTER);
        if (q == 0) merge_top(m, cl, kc, s, b, zr);
        KTT_PHASE(PH_MERGE);
      }
      KTT_GRID_SYNC(BS_ROWS);
      KTT_PHASE(PH_BARRIER);
      // B. the dispersal speculation, alike in every block
      speculate(m, s, C, zr);
      KTT_PHASE(PH_SPECULATE);
      // C. the exact repair (and its iterations)
      for (int it = 0; it < iters; ++it) {
        const int par = it & 1;
        if (!m.committed[b]) slice_repair<SH>(a, views, ax, m, s, x, c0p, b, q, lo, hi, par KTT_PH_ARG);
        KTT_PHASE(PH_REPAIR);
        KTT_GRID_SYNC(BS_REPAIRED);
        KTT_PHASE(PH_BARRIER);
        repaired(a, m, x, c0p, C, kc, par);
        if (it + 1 < iters) {
          if (tid < C && !m.committed[tid]) m.c[tid] = m.t[tid];
          __syncthreads();
        }
        KTT_PHASE(PH_REPAIR);
      }
      // D. commit, alike; the shared state's writes, one writer each
      commit<SH>(a, views, ax, m, ents, c0p, C);
      commit_state<SH>(a, views, ax, m, ents, c0p, C);
      KTT_PHASE(PH_COMMIT);
      // E. the count planes, every block on its share of the nodes
      apply<SH>(a, views, ax, m, ents, nxt, lead);
      KTT_PHASE(PH_APPLY);
      KTT_GRID_SYNC(BS_ROUND);
      KTT_PHASE(PH_BARRIER);
      if (!m.cont) break;
    }
    if (blockIdx.x == 0 && tid < C) {
      choices[c0p + tid] = m.out[tid];
      ordinals[c0p + tid] = m.base_rounds + m.ord[tid];
    }
    __syncthreads();
    if (tid == 0) m.base_rounds += m.nrounds;
  }
  if (blockIdx.x == 0 && tid == 0) {
    scal[0] = m.base_rounds;
    scal[1] |= m.status;  // a cap hit in any launch over one pair survives
  }
}

// the dynamic shared memory of rounds_kernel: the round's commit entries,
// their next-of-the-same-(plane, term) links and the group leaders
inline size_t rounds_dyn_smem(int C) { return (size_t)C * MAX_ENT * (sizeof(CommitEnt) + 2 * sizeof(int)); }

// the scratch from ktt_rounds' sp (sp[8..12] and sp[14] are not read)
RoundsScratch read_scratch(void* const* sp) {
  RoundsScratch s;
  s.feas = static_cast<uint8_t*>(sp[0]);
  s.base = static_cast<float*>(sp[1]);
  s.sraw = static_cast<float*>(sp[2]);
  s.ipraw = static_cast<float*>(sp[3]);
  s.total = static_cast<float*>(sp[4]);
  s.topv = static_cast<float*>(sp[5]);
  s.topi = static_cast<int32_t*>(sp[6]);
  s.c0 = static_cast<int32_t*>(sp[7]);
  s.x = static_cast<int32_t*>(sp[13]);
  return s;
}

// the cooperative launch of C clusters: the widest cluster (<= 8 blocks,
// <= one per 32 nodes of the node axis) of which the card holds all C at
// once, as the cooperative launch needs (with one block
// an SM, an H100's GPCs hold fewer than 16 clusters of 8)
template <bool SH>
int launch_rounds(const FullArgs& a, const ktt::ShardTable& tab, const RoundsScratch& s, int C, int iters,
                  void* choices, void* ordinals, void* scal, void* stream) {
  int dev = 0, nsm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t dyn = rounds_dyn_smem(C);
  err = cudaFuncSetAttribute(rounds_kernel<SH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[1].id = cudaLaunchAttributeCooperative;
  at[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(ktt::PW_NT);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = at;
  int kc = 0;
  for (int k = MAX_KC; k >= 1 && kc == 0; --k) {
    if (k > 1 && (k > (a.N + 31) / 32 || C * k > nsm)) continue;
    at[0].val.clusterDim.x = k;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(C * k);
    cfg.numAttrs = 1;
    int clusters = 0;
    if (cudaOccupancyMaxActiveClusters(&clusters, (void*)rounds_kernel<SH>, &cfg) == cudaSuccess && clusters >= C)
      kc = k;
    cudaGetLastError();  // a refused query leaves no error behind
  }
  if (kc == 0) return (int)cudaErrorInvalidConfiguration;
  at[0].val.clusterDim.x = kc;
  cfg.gridDim = dim3(C * kc);
  cfg.numAttrs = 2;
  err = cudaLaunchKernelEx(&cfg, rounds_kernel<SH>, a, tab, s, C, iters, static_cast<int32_t*>(choices),
                           static_cast<int32_t*>(ordinals), static_cast<int32_t*>(scal));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs, dims, sw, wp, ip, fp: as ktt_full_scan's, and ptrs[26] the class of
// each pod row i32[P] (class-row mode: the plane pointers are the class
// planes [U1, *]) or NULL (dense mode); ptrs[27..33] done and the start state
// (pairwise.cuh read_gate); scal[1] is ORed into, not written; sp: the scratch pointers
// of ops/kernels.py _rounds_scratch (feas, base, sraw, ipraw, total, topv,
// topi, c0, four [C] and a [2] word array the kernel does not read, the
// [C * 80, 4] exchange, a word it does not read); C: pods per chunk (<= 32,
// dividing P); iters: repair iterations per round
extern "C" int ktt_rounds(const void* const* ptrs, const int* dims, const int* sw, const float* wp, const int* ip,
                          const float* fp, void* choices, void* ordinals, void* scal, void* const* sp, int C,
                          int iters, void* stream) {
  FullArgs a;
  const int bad = ktt::read_full_args(ptrs, dims, sw, wp, ip, fp, a);
  if (bad) return bad;
  if (C < 1 || C > MAXC || a.P % C != 0 || iters < 1) return (int)cudaErrorInvalidValue;
  const ktt::ShardTable tab{};
  return launch_rounds<false>(a, tab, read_scratch(sp), C, iters, choices, ordinals, scal, stream);
}

#ifdef KTT_ROUNDS_PHASES
// cycles, hits: host arrays of PH_N; reads block 0's phase counters, then
// zeroes them
extern "C" int ktt_rounds_phases(unsigned long long* cycles, unsigned long long* hits) {
  const unsigned long long zero[PH_N] = {};
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(hits, g_phase_hits, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_hits, zero, sizeof(zero));
  return (int)err;
}

// cycles: a host array [PH_N, PH_MAX_BLOCKS]; reads every block's phase
// cycles, then zeroes them
extern "C" int ktt_rounds_blocks(unsigned long long* cycles) {
  static const unsigned long long zero[PH_N * PH_MAX_BLOCKS] = {};
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_block_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_block_cycles, zero, sizeof(zero));
  return (int)err;
}

// log: device memory [blocks, cap] of u64 (or NULL: no log); each later
// launch writes its barriers' waits from column 0
extern "C" int ktt_rounds_log(void* log, int cap) {
  cudaError_t err = cudaMemcpyToSymbol(g_bar_log, &log, sizeof(log));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_bar_cap, &cap, sizeof(cap));
  return (int)err;
}
#endif

// shard mode: ptrs / dims / sw / wp / ip / fp as ktt_rounds' for shard 0's
// arrays (the pod side; dims[1] = nl; ptrs[19] and [28] the replicated usage
// and its start [N, R]; done NULL); shard_ptrs: S rows of pairwise.cuh
// ShardPtrs' 18 pointers (their used / used0: the shard's slice of the
// replicated usage); n_glob = S * nl, the global (padded) node count; sp:
// ktt_rounds' scratch at the global node count.  rounds_kernel<true>: the
// same cooperative launch of C clusters as one device's.
extern "C" int ktt_rounds_shard(const void* const* ptrs, const int* dims, const int* sw, const float* wp,
                                const int* ip, const float* fp, const void* const* shard_ptrs, int S, int n_glob,
                                void* choices, void* ordinals, void* scal, void* const* sp, int C, int iters,
                                void* stream) {
  FullArgs a;
  const int bad = ktt::read_full_args(ptrs, dims, sw, wp, ip, fp, a);
  if (bad) return bad;
  if (C < 1 || C > MAXC || a.P % C != 0 || iters < 1 || S < 1 || S > ktt::PW_MAX_SHARDS || a.done != nullptr ||
      n_glob != S * a.N)
    return (int)cudaErrorInvalidValue;
  const ktt::ShardTable tab = ktt::make_shard_table(shard_ptrs, S, a.N);
  a.N = n_glob;
  a.W = (n_glob + 31) / 32;
  // every node-side read goes through a shard's view: the launch keeps the
  // replicated usage (global ids) and shard 0's total_t (the waiver's)
  a.sfs = a.eligs = nullptr;
  a.traw = a.naraw = a.img_s = nullptr;
  a.alloc = a.dbt = nullptr;
  a.cnt = a.antin = a.pref = nullptr;
  a.ports_used = nullptr;
  a.cnt0 = a.anti0 = a.pref0 = nullptr;
  a.ports0 = nullptr;
  return launch_rounds<true>(a, tab, read_scratch(sp), C, iters, choices, ordinals, scal, stream);
}
