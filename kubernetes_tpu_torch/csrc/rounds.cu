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
// Design: one cooperative persistent launch of C blocks of 1024 threads
// walks the P / C chunks in order, with no host synchronisation per chunk or
// per round.  Block b holds pod b of the chunk (its slots, its share row and
// its round scalars stay in its shared memory across the rounds):
//   A. block b re-hoists its pod's row (pairwise.cuh row_pass: feasibility,
//      raws, normalisation scalars, the masked total row in a [C, N]
//      scratch) and selects its top-Zr (topk.cuh, lax.top_k's order);
//   B. block 0 ranks the pods sharing an argmax and speculates;
//   C. block b repairs its pod: one thread per earlier pod j rescoring the
//      candidate column c_j under the exact int32 prefix usage, the block
//      the best unpicked node of the round-start row;
//   D. block 0 commits the prefix: usage, ports, total_t, and a list of
//      (plane, term, domain, weight) commit entries;
//   E. every block applies the entries to its share of the [T, N] planes.
// Five grid barriers a round; every cross-block read goes through L2
// (__ldcg).  A chunk that does not finish in C rounds (every round commits
// a pod, so the algorithm rules it out) stops and reports it in the
// status, which the wrapper's caller raises on.
//
// SHARD MODE (rounds_shard_kernel; the JAX package's schedule_scan_rounds
// under shard_map, axis_name set: ops/assign.py:1464, collectives at
// :1586-1592, :1803-1812, :1864-1911, :1933, :1966-2034, :2115-2145), dense
// and class-row: a cooperative grid of C * S blocks, block (b, s) = blockIdx
// s * C + b holding pod b of the chunk on node shard s, through that
// shard's pointers (pairwise.cuh shard_view: its planes, count planes,
// ports, its own copy of total_t and its rows [C, nl] of the row scratch).
// The usage is replicated, one copy [N, R] (the JAX package all-gathers it
// once per step and carries it replicated); every block keeps the chunk
// state (committed, out, ordinals, the speculation and the repair) in its
// shared memory, all alike.  The only memory the shards share is the
// exchange RoundsX, one slot per (pod, shard) per quantity, each written by
// its block only; after a grid barrier the readers combine the S slots in
// shard order.  A round:
//   A1. (pairwise) each slot's partial max of -count -> barrier -> the max
//       over shards, inf -> 0 (the JAX pmin taken first);
//   A2. row_feas -> the five partial maxima -> barrier -> their max;
//   A3. row_total (the shard's best (score, global id)) and block_topk over
//       the shard's nl nodes: kl = min(Zr, nl) entries with global ids ->
//       barrier;
//   B.  every block alike: each pod's argmax from the S slots (_rmax, then
//       _rmin of the ids), the rank, and the rank-th entry of the S * kl
//       candidates merged in shard order (ties: the lower global id, i.e.
//       the lower position, as _global_top_k's lax.top_k);
//   C.  block (i, s) repairs pod i on its shard: warp 0 rescoring the
//       candidate columns c_j that shard s owns (the owner's feasibility,
//       raws and allocatable; the replicated usage), the block the best
//       unpicked node among its nodes -> barrier (slots by iteration
//       parity) -> every block combines (t, hard) per pod;
//   D.  every block alike: the commit prefix; block (0, 0) adds the picks
//       to the replicated usage, block (0, s) writes the ports and the
//       commit entries (the domain columns from its dbt) of the picks on
//       its nodes -> barrier;
//   E.  every block applies all shards' entries to its share of its shard's
//       columns, block (0, s) to its total_t copy -> barrier.
// Six grid barriers a round (five without the pairwise stages).  With one
// shard the launch is rounds_kernel above.  The gated mode is refused here.
//
// Bounds on an H100 at config 3 (640 chunks, 1691 rounds in the JAX run):
// the bytes are the packed static and eligibility planes and the pod
// arrays read once (~16 MB, >= 5 us at 3.35 TB/s); the operations are each
// round's re-hoist, ~60 f32 per (pod, node) feasible for it.  Neither sets
// the time: the chain of rounds, five grid barriers and the block-wide
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

struct RoundsScratch {
  uint8_t* feas;  // [C, N]
  float* base;    // [C, N]
  float* sraw;    // [C, N]
  float* ipraw;   // [C, N]
  float* total;   // [C, N]
  float* topv;    // [C, ZR_MAX]
  int32_t* topi;  // [C, ZR_MAX]
  int32_t* c0;    // [C] each pod's argmax this round
  int32_t* c;     // [C] the speculation
  int32_t* t;     // [C] the repair
  int32_t* hard;  // [C]
  int32_t* unc;   // [C] not yet committed
  int32_t* ctrl;  // [2] continue flag, by round parity
  CommitEnt* ents;  // [C * max entries per pod]
  int32_t* n_ents;  // [1]
};

#ifdef KTT_ROUNDS_PHASES
// A build with -DKTT_ROUNDS_PHASES (kubernetes_tpu_torch/bench/rounds_phases.py)
// makes thread 0 of block 0 add the SM cycles between the round loop's
// phase boundaries into g_phase_cycles and count each boundary in
// g_phase_hits.  A phase's cycles are block 0's own work in it; the waits
// at the grid barriers that close the phases are PH_BARRIER.
enum { PH_CHUNK, PH_REHOIST, PH_SPECULATE, PH_REPAIR, PH_COMMIT, PH_APPLY, PH_BARRIER, PH_N };
__device__ unsigned long long g_phase_cycles[PH_N];
__device__ unsigned long long g_phase_hits[PH_N];
#define KTT_PHASE(k)                                          \
  do {                                                        \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                \
      const long long now = clock64();                        \
      g_phase_cycles[k] += (unsigned long long)(now - ph_t);  \
      g_phase_hits[k] += 1;                                   \
      ph_t = now;                                             \
    }                                                         \
  } while (0)
#else
#define KTT_PHASE(k) ((void)0)
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

struct BlockSmem {
  PodSlots ps;
  RowScalars rs;
  float red[5 * 32];
  int redi[32];
  ktt::TopkScratch tks;
  int share[MAXC];  // share(b, j)
  int cj[MAXC];
  int actj[MAXC];
  // block 0's chunk state
  int committed[MAXC];
  int out[MAXC];
  int ord[MAXC];
  int nrounds, base_rounds, status;
  float vb;
  int bn, hard;
};

// warp 0's lane for candidate column c_j in the repair of pod i: node cl
// of the block's view (global id `id`) rescored under the exact prefix
// usage (the int32 adds of the earlier active pods that picked it,
// same(k)), with pod i's round-start raws and scalars -> (mj, bn = id,
// hard: a shared term, or a fit drop at a normalisation extreme)
template <class Same>
__device__ __forceinline__ void rescore(const FullArgs& a, const RowScalars& rs, const PodSlots& ps, int share_j,
                                        const uint8_t* feas_i, const float* sraw_i, const float* ipraw_i, int c0p,
                                        int i, int cl, int id, Same same, float& mj, int& bn, int& hard) {
  int uij[ktt::SCORE_MAX_R];
  for (int r = 0; r < a.R; ++r) uij[r] = __ldcg(a.used + (int64_t)cl * a.R + r);
  for (int k = 0; k < i; ++k)
    if (same(k))
      for (int r = 0; r < a.R; ++r) uij[r] = ktt::wadd(uij[r], a.preq[(c0p + k) * a.R + r]);
  const int64_t nr = (int64_t)cl * a.R;
  const int* req = ps.req;
  const bool fit = ktt::fit_ok(a.R, [&](int r) { return req[r]; }, [&](int r) { return uij[r]; },
                               [&](int r) { return a.alloc[nr + r]; });
  const float baseij = ktt::score_flat(a.sp, [&](int r) { return ktt::wadd(uij[r], req[r]); },
                                       [&](int r) { return a.alloc[nr + r]; });
  const bool f0 = __ldcg(feas_i + cl);
  const float sr = f0 ? __ldcg(sraw_i + cl) : 0.0f;
  const float ir = f0 ? __ldcg(ipraw_i + cl) : 0.0f;
  const int64_t pn = ps.prow * a.N + cl;
  const float nt = ktt::node_total(a, rs, pn, baseij, sr, ir);
  mj = (f0 && fit) ? nt : -INFINITY;
  bn = id;
  bool extreme = false;
  if (a.taint) extreme = extreme || (rs.t_mx > 0.0f && ktt::bf(a.traw, pn) == rs.t_mx);
  if (a.nap) extreme = extreme || (rs.na_mx > 0.0f && ktt::bf(a.naraw, pn) == rs.na_mx);
  if (a.pw) extreme = extreme || (rs.s_mx > 0.0f && sr == rs.s_mx);
  if (a.ips) extreme = extreme || (rs.ip_mx > rs.ip_mn && (ir == rs.ip_mx || ir == rs.ip_mn));
  hard = share_j || (f0 && !fit && extreme);
}

// phase C for pod i = blockIdx.x of the chunk starting at pod c0p
__device__ void repair(const FullArgs& a, const RoundsScratch& s, BlockSmem& m, int c0p, int C) {
  const int i = blockIdx.x, tid = threadIdx.x;
  const int64_t p = c0p + i;
  if (tid < C) {
    const int c = __ldcg(s.c + tid);
    m.cj[tid] = c;
    m.actj[tid] = __ldcg(s.unc + tid) && c >= 0;
  }
  __syncthreads();
  if (!__ldcg(s.unc + i)) return;  // uniform: every thread reads the same flag
  const uint8_t* feas_i = s.feas + (int64_t)i * a.N;
  const float* sraw_i = s.sraw + (int64_t)i * a.N;
  const float* ipraw_i = s.ipraw + (int64_t)i * a.N;
  const float* total_i = s.total + (int64_t)i * a.N;
  const RowScalars rs = m.rs;
  if (tid < 32) {  // warp 0: lane j rescored the candidate column c_j
    float mj = -INFINITY;
    int bn = ktt::PW_IMAX;
    int hard = 0;
    const int j = tid;
    if (j < i && m.actj[j]) {
      const int cn = m.cj[j];
      rescore(a, rs, m.ps, m.share[j], feas_i, sraw_i, ipraw_i, c0p, i, cn, cn,
              [&](int k) { return m.actj[k] && m.cj[k] == cn; }, mj, bn, hard);
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(ktt::PW_FULL, mj, off);
      const int on = __shfl_xor_sync(ktt::PW_FULL, bn, off);
      if (ktt::pw_better(ov, on, mj, bn)) {
        mj = ov;
        bn = on;
      }
      hard |= __shfl_xor_sync(ktt::PW_FULL, hard, off);
    }
    if (tid == 0) {
      m.vb = mj;
      m.bn = bn;
      m.hard = hard;
    }
  }
  // the best round-start score over the nodes no earlier active pod picked
  float av = -INFINITY;
  int an = ktt::PW_IMAX;
  for (int n = tid; n < a.N; n += blockDim.x) {
    bool picked = false;
    for (int j = 0; j < i && !picked; ++j) picked = m.actj[j] && m.cj[j] == n;
    if (picked) continue;
    const float v = __ldcg(total_i + n);
    if (ktt::pw_better(v, n, av, an)) {
      av = v;
      an = n;
    }
  }
  ktt::block_argmax(av, an, m.red, m.redi);
  if (tid == 0) {
    const float vb = m.vb;
    const int bn = m.bn;
    const float t_val = fmaxf(av, vb);
    const int t_n = vb > av ? bn : (av > vb ? an : min(an, bn));
    s.t[i] = (t_val > -INFINITY && m.ps.valid) ? t_n : -1;
    s.hard[i] = m.hard;
  }
}

// phase D (block 0, thread 0): commit the longest confirmed prefix plus
// the first divergence-only pod; returns whether the chunk goes on
__device__ int commit_round(const FullArgs& a, const RoundsScratch& s, BlockSmem& m, int c0p, int C) {
  int firstbad = C;
  for (int i = 0; i < C; ++i) {
    if (m.committed[i]) continue;
    if (__ldcg(s.hard + i) || __ldcg(s.t + i) != __ldcg(s.c + i)) {
      firstbad = i;
      break;
    }
  }
  int n_ents = 0;
  for (int i = 0; i < C; ++i) {
    if (m.committed[i]) continue;
    const int hard = __ldcg(s.hard + i);
    const bool fb = i == firstbad && !hard;
    const int cf = fb ? __ldcg(s.t + i) : __ldcg(s.c + i);
    if (!(i < firstbad || fb)) continue;
    m.out[i] = cf;
    m.ord[i] = m.nrounds;
    m.committed[i] = 1;
    if (cf < 0) continue;
    const int64_t p = c0p + i;
    for (int r = 0; r < a.R; ++r) {
      int32_t* u = a.used + (int64_t)cf * a.R + r;
      *u = ktt::wadd(__ldcg(u), a.preq[p * a.R + r]);
    }
    if (a.ports)
      for (int q = 0; q < a.PT; ++q)
        if (a.pod_ports[p * a.PT + q]) a.ports_used[(int64_t)cf * a.PT + q] = 1;
    n_ents += ktt::commit_entries(a, (int)p, cf, s.ents + n_ents, a.total_t);
  }
  *s.n_ents = n_ents;
  ++m.nrounds;
  int any = 0;
  for (int i = 0; i < C; ++i) {
    s.unc[i] = !m.committed[i];
    any |= !m.committed[i];
  }
  const int cont = any && m.nrounds < C;
  if (any && !cont) m.status = 1;  // the round cap: never on state the algorithm admits
  return cont;
}

__global__ void __launch_bounds__(ktt::PW_NT) rounds_kernel(FullArgs a, RoundsScratch s, int C, int iters,
                                                            int32_t* choices, int32_t* ordinals, int32_t* scal) {
  cg::grid_group grid = cg::this_grid();
  __shared__ BlockSmem m;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int zr = a.N < ZR_MAX ? a.N : ZR_MAX;
  const bool mine = b < C;
  // the gated mode: every block reads the same word, written by an earlier
  // launch in stream order, so the whole grid leaves before its first
  // barrier; a launch that passes writes its own start state
  if (a.done != nullptr && __ldcg(a.done)) return;
  ktt::copy_start_state(a, (int64_t)b * blockDim.x + tid, (int64_t)gridDim.x * blockDim.x);
  grid.sync();
#ifdef KTT_ROUNDS_PHASES
  long long ph_t = clock64();
#endif
  if (b == 0 && tid == 0) {
    m.base_rounds = 0;
    m.status = 0;
  }
  for (int c0p = 0; c0p < a.P; c0p += C) {
    const int p = c0p + b;
    if (mine) ktt::load_pod(a, p, m.ps);
    if (b == 0 && tid < C) {
      m.committed[tid] = 0;
      m.out[tid] = -1;
      m.ord[tid] = 0;
      s.unc[tid] = 1;
    }
    if (b == 0 && tid == 0) m.nrounds = 0;
    if (mine && tid < C) m.share[tid] = share_of(a, p, c0p + tid);
    __syncthreads();
    KTT_PHASE(PH_CHUNK);
    grid.sync();
    KTT_PHASE(PH_BARRIER);
    for (int rnd = 0;; ++rnd) {
      // A. the exact re-hoist of each uncommitted pod
      if (mine) {
        if (__ldcg(s.unc + b)) {
          ktt::pod_scalars(a, p, m.ps, m.red);
          const int64_t row = (int64_t)b * a.N;
          ktt::row_pass(a, p, m.ps, s.feas + row, s.base + row, s.sraw + row, s.ipraw + row, s.total + row,
                        m.rs, m.red, m.redi);
          ktt::block_topk(s.total + row, a.N, zr, s.topv + b * ZR_MAX, s.topi + b * ZR_MAX, m.tks);
          if (tid == 0) s.c0[b] = (m.rs.best > -INFINITY && m.ps.valid) ? m.rs.best_n : -1;
        } else if (tid == 0) {
          s.c0[b] = -1;
        }
      }
      KTT_PHASE(PH_REHOIST);
      grid.sync();
      KTT_PHASE(PH_BARRIER);
      // B. dispersal speculation: pod i takes its rank-th best node, rank =
      // earlier uncommitted pods sharing its argmax
      if (b == 0 && tid < C) {
        const int i = tid;
        const int c0 = __ldcg(s.c0 + i);
        int rank = 0;
        for (int j = 0; j < i; ++j)
          if (!m.committed[j] && __ldcg(s.c0 + j) == c0 && c0 >= 0) ++rank;
        int c = c0;
        if (!m.committed[i] && c0 >= 0 && rank > 0 && rank < zr) {
          if (__ldcg(s.topv + i * ZR_MAX + rank) > -INFINITY) c = __ldcg(s.topi + i * ZR_MAX + rank);
        }
        s.c[i] = c;
      }
      KTT_PHASE(PH_SPECULATE);
      grid.sync();
      KTT_PHASE(PH_BARRIER);
      // C. the exact repair (and its iterations)
      for (int it = 0; it < iters; ++it) {
        if (mine) repair(a, s, m, c0p, C);
        KTT_PHASE(PH_REPAIR);
        grid.sync();
        KTT_PHASE(PH_BARRIER);
        if (it + 1 < iters) {
          if (b == 0 && tid < C && !m.committed[tid]) s.c[tid] = __ldcg(s.t + tid);
          grid.sync();
        }
      }
      // D. commit
      if (b == 0 && tid == 0) s.ctrl[rnd & 1] = commit_round(a, s, m, c0p, C);
      KTT_PHASE(PH_COMMIT);
      grid.sync();
      KTT_PHASE(PH_BARRIER);
      // E. the count planes, every block on its share of the nodes
      const int cont = __ldcg(s.ctrl + (rnd & 1));
      const int n_ents = __ldcg(s.n_ents);
      for (int n = b * blockDim.x + tid; n < a.N; n += gridDim.x * blockDim.x)
        for (int k = 0; k < n_ents; ++k) ktt::apply_entry(a, ktt::load_ent(s.ents + k), n);
      KTT_PHASE(PH_APPLY);
      grid.sync();
      KTT_PHASE(PH_BARRIER);
      if (!cont) break;
    }
    if (b == 0) {
      if (tid < C) {
        choices[c0p + tid] = m.out[tid];
        ordinals[c0p + tid] = m.base_rounds + m.ord[tid];
      }
      __syncthreads();
      if (tid == 0) m.base_rounds += m.nrounds;
    }
  }
  if (b == 0 && tid == 0) {
    scal[0] = m.base_rounds;
    scal[1] |= m.status;  // a cap hit in any launch over one pair survives
  }
}


// the exchange of shard mode: slot q = b * S + s of pod b on shard s
struct RoundsX {
  float* mm;        // [C * S, PW_MAX_S] partial spread maxima of -count
  float* sc;        // [C * S, 5] partial normalisation maxima
  float* bv;        // [C * S] the shard's best total
  int32_t* bn;      // [C * S] its global id
  float* tv;        // [C * S, ZR_MAX] the shard's top-kl values
  int32_t* ti;      // [C * S, ZR_MAX] their global ids
  float* rv;        // [2, C * S, 2] the repair's vb, av (by iteration parity)
  int32_t* ri;      // [2, C * S, 3] its bn, an, hard
  CommitEnt* ents;  // [S, C * MAX_ENT] the commit entries of each shard's nodes
  int32_t* n_ents;  // [S]
};

// the row scratch of shard mode: [S, C, nl] per row
struct ShardRows {
  uint8_t* feas;
  float* base;
  float* sraw;
  float* ipraw;
  float* total;
};

constexpr int MAX_ENT = ktt::PW_MAX_M + 3 * ktt::PW_MAX_S;

struct ShardSmem {
  FullArgs a;  // this block's shard view
  PodSlots ps;
  RowScalars rs;
  float red[5 * 32];
  int redi[32];
  ktt::TopkScratch tks;
  int share[MAXC];
  // the chunk state, alike in every block
  int committed[MAXC];
  int out[MAXC];
  int ord[MAXC];
  int c0[MAXC];
  int c[MAXC];
  int t[MAXC];
  int hard[MAXC];
  int nrounds, base_rounds, status, cont;
  float vb;
  int bn, hardw;
};

// phase C on shard s for pod i = b (uncommitted): the partials of its repair
__device__ void repair_shard(const FullArgs& g, ShardSmem& m, const RoundsX& x, const uint8_t* feas_i,
                             const float* sraw_i, const float* ipraw_i, const float* total_i, int c0p, int S, int s,
                             int i, int base, int par) {
  const FullArgs& a = m.a;
  const int tid = threadIdx.x, nl = a.N;
  const RowScalars rs = m.rs;
  if (tid < 32) {  // warp 0: lane j rescored the candidate column c_j, if this shard owns it
    float mj = -INFINITY;
    int bn = ktt::PW_IMAX;
    int hard = 0;
    const int j = tid;
    const int cn = j < MAXC ? m.c[j] : -1;
    if (j < i && !m.committed[j] && cn >= base && cn < base + nl)  // this shard owns c_j
      rescore(a, rs, m.ps, m.share[j], feas_i, sraw_i, ipraw_i, c0p, i, cn - base, cn,
              [&](int k) { return !m.committed[k] && m.c[k] == cn; }, mj, bn, hard);
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(ktt::PW_FULL, mj, off);
      const int on = __shfl_xor_sync(ktt::PW_FULL, bn, off);
      if (ktt::pw_better(ov, on, mj, bn)) {
        mj = ov;
        bn = on;
      }
      hard |= __shfl_xor_sync(ktt::PW_FULL, hard, off);
    }
    if (tid == 0) {
      m.vb = mj;
      m.bn = bn;
      m.hardw = hard;
    }
  }
  // the best round-start score over this shard's nodes no earlier active pod picked
  float av = -INFINITY;
  int an = ktt::PW_IMAX;
  for (int n = tid; n < nl; n += blockDim.x) {
    const int gid = base + n;
    bool picked = false;
    for (int j = 0; j < i && !picked; ++j) picked = !m.committed[j] && m.c[j] >= 0 && m.c[j] == gid;
    if (picked) continue;
    const float v = __ldcg(total_i + n);
    if (ktt::pw_better(v, gid, av, an)) {
      av = v;
      an = gid;
    }
  }
  ktt::block_argmax(av, an, m.red, m.redi);
  if (tid == 0) {
    const int64_t q = (int64_t)par * gridDim.x + (int64_t)i * S + s;
    x.rv[q * 2] = m.vb;
    x.rv[q * 2 + 1] = av;
    x.ri[q * 3] = m.bn;
    x.ri[q * 3 + 1] = an;
    x.ri[q * 3 + 2] = m.hardw;
  }
}

// phase D (thread 0 of every block, alike): the commit prefix into the
// block's chunk state; block (0, 0) adds the picks to the replicated usage,
// block (0, s) writes the ports and the commit entries of the picks on its
// nodes
__device__ void commit_shard(const FullArgs& g, ShardSmem& m, const RoundsX& x, int c0p, int C, int s, int b,
                             int base) {
  const FullArgs& a = m.a;
  const int nl = a.N;
  int firstbad = C;
  for (int i = 0; i < C; ++i) {
    if (m.committed[i]) continue;
    if (m.hard[i] || m.t[i] != m.c[i]) {
      firstbad = i;
      break;
    }
  }
  int n_ents = 0;
  for (int i = 0; i < C; ++i) {
    if (m.committed[i]) continue;
    const bool fb = i == firstbad && !m.hard[i];
    const int cf = fb ? m.t[i] : m.c[i];
    if (!(i < firstbad || fb)) continue;
    m.out[i] = cf;
    m.ord[i] = m.nrounds;
    m.committed[i] = 1;
    if (cf < 0) continue;
    const int64_t p = c0p + i;
    if (b == 0 && s == 0)
      for (int r = 0; r < a.R; ++r) {
        int32_t* u = g.used + (int64_t)cf * a.R + r;
        *u = ktt::wadd(__ldcg(u), a.preq[p * a.R + r]);
      }
    if (b == 0 && cf >= base && cf < base + nl) {
      const int cl = cf - base;
      if (a.ports)
        for (int q = 0; q < a.PT; ++q)
          if (a.pod_ports[p * a.PT + q]) a.ports_used[(int64_t)cl * a.PT + q] = 1;
      n_ents += ktt::commit_entries(a, (int)p, cl, x.ents + (int64_t)s * C * MAX_ENT + n_ents, nullptr);
    }
  }
  if (b == 0) x.n_ents[s] = n_ents;
  ++m.nrounds;
  int any = 0;
  for (int i = 0; i < C; ++i) any |= !m.committed[i];
  m.cont = any && m.nrounds < C;
  if (any && !m.cont) m.status = 1;  // the round cap: never on state the algorithm admits
}

__global__ void __launch_bounds__(ktt::PW_NT) rounds_shard_kernel(FullArgs g, ktt::ShardTable tab, ShardRows rows,
                                                                  RoundsX x, int C, int iters, int n_glob,
                                                                  int32_t* choices, int32_t* ordinals,
                                                                  int32_t* scal) {
  cg::grid_group grid = cg::this_grid();
  __shared__ ShardSmem m;
  const int S = tab.S;
  const int s = blockIdx.x / C, b = blockIdx.x % C, tid = threadIdx.x;
  const int base = tab.sh[s].base, nl = tab.sh[s].nl;
  const int zr = n_glob < ZR_MAX ? n_glob : ZR_MAX;  // Zr = min(32, N) over the global N
  const int kl = nl < zr ? nl : zr;
  if (tid == 0) ktt::shard_view(g, tab.sh[s], m.a);
  __syncthreads();
  const FullArgs& a = m.a;
  // the start state: the C blocks of shard s copy its share (its slice of
  // the replicated usage included)
  ktt::copy_start_state(a, (int64_t)b * blockDim.x + tid, (int64_t)C * blockDim.x);
  if (tid == 0) {
    m.base_rounds = 0;
    m.status = 0;
  }
  grid.sync();
  const int64_t row = ((int64_t)s * C + b) * nl;
  uint8_t* feas_b = rows.feas + row;
  float* base_b = rows.base + row;
  float* sraw_b = rows.sraw + row;
  float* ipraw_b = rows.ipraw + row;
  float* total_b = rows.total + row;
  const int q = b * S + s;
  for (int c0p = 0; c0p < a.P; c0p += C) {
    const int p = c0p + b;
    ktt::load_pod(a, p, m.ps);
    if (tid < C) {
      m.committed[tid] = 0;
      m.out[tid] = -1;
      m.ord[tid] = 0;
      m.share[tid] = share_of(a, p, c0p + tid);
    }
    if (tid == 0) m.nrounds = 0;
    __syncthreads();
    for (int rnd = 0;; ++rnd) {
      const bool unc = !m.committed[b];
      // A1. the spread minMatch
      if (a.pw) {
        if (unc) {
          ktt::pod_scalars_partial(a, p, m.ps, m.red);
          if (tid < m.ps.n_sp) x.mm[q * ktt::PW_MAX_S + tid] = m.ps.sp_mm[tid];
        }
        grid.sync();
        if (unc) {
          if (tid < m.ps.n_sp) {
            float v = -INFINITY;
            for (int s2 = 0; s2 < S; ++s2) v = fmaxf(v, __ldcg(x.mm + (b * S + s2) * ktt::PW_MAX_S + tid));
            m.ps.sp_mm[tid] = v;
          }
          __syncthreads();
          if (tid == 0) ktt::pod_scalars_finish(m.ps);
          __syncthreads();
        }
      }
      // A2. the normalisation scalars
      float mx[5];
      if (unc) {
        ktt::row_feas(a, p, m.ps, feas_b, base_b, sraw_b, ipraw_b, mx, m.red);
        if (tid == 0)
          for (int k = 0; k < 5; ++k) x.sc[q * 5 + k] = mx[k];
      }
      grid.sync();
      // A3. the total row, its argmax and its top-kl
      if (unc) {
        for (int k = 0; k < 5; ++k) {
          float v = -INFINITY;
          for (int s2 = 0; s2 < S; ++s2) v = fmaxf(v, __ldcg(x.sc + (b * S + s2) * 5 + k));
          mx[k] = v;
        }
        ktt::row_total(a, m.ps, ktt::row_scalars(mx), feas_b, base_b, sraw_b, ipraw_b, total_b, base, m.rs, m.red,
                       m.redi);
        ktt::block_topk(total_b, nl, kl, x.tv + q * ZR_MAX, x.ti + q * ZR_MAX, m.tks);
        if (tid < kl) x.ti[q * ZR_MAX + tid] += base;  // this thread's own entry
        if (tid == 0) {
          x.bv[q] = m.rs.best;
          x.bn[q] = m.rs.best_n;
        }
      }
      grid.sync();
      // B. the argmax of every pod, then the dispersal speculation
      if (tid < C) {
        int c0 = -1;
        if (!m.committed[tid]) {
          float v = -INFINITY;
          int n = ktt::PW_IMAX;
          for (int s2 = 0; s2 < S; ++s2) {
            const float v2 = __ldcg(x.bv + tid * S + s2);
            const int n2 = __ldcg(x.bn + tid * S + s2);
            if (ktt::pw_better(v2, n2, v, n)) {
              v = v2;
              n = n2;
            }
          }
          c0 = (v > -INFINITY && a.pvalid[c0p + tid]) ? n : -1;
        }
        m.c0[tid] = c0;
      }
      __syncthreads();
      if (tid < C) {
        const int i = tid;
        const int c0 = m.c0[i];
        int rank = 0;
        for (int j = 0; j < i; ++j)
          if (!m.committed[j] && m.c0[j] == c0 && c0 >= 0) ++rank;
        int c = c0;
        if (!m.committed[i] && c0 >= 0 && rank > 0 && rank < zr) {
          int ptr[ktt::PW_MAX_SHARDS];
          for (int s2 = 0; s2 < S; ++s2) ptr[s2] = 0;
          float v = -INFINITY;
          int id = -1;
          for (int k = 0; k <= rank; ++k) {  // the merge, in shard order
            int bs = -1;
            unsigned long long bk = 0;
            for (int s2 = 0; s2 < S; ++s2) {
              if (ptr[s2] >= kl) continue;
              const int64_t o = (int64_t)(i * S + s2) * ZR_MAX + ptr[s2];
              const unsigned long long key = ktt::topk_key(__ldcg(x.tv + o), __ldcg(x.ti + o));
              if (bs < 0 || key > bk) {
                bk = key;
                bs = s2;
              }
            }
            const int64_t o = (int64_t)(i * S + bs) * ZR_MAX + ptr[bs];
            v = __ldcg(x.tv + o);
            id = __ldcg(x.ti + o);
            ++ptr[bs];
          }
          if (v > -INFINITY) c = id;
        }
        m.c[i] = c;
      }
      __syncthreads();
      // C. the exact repair (and its iterations)
      for (int it = 0; it < iters; ++it) {
        const int par = it & 1;
        if (unc) repair_shard(g, m, x, feas_b, sraw_b, ipraw_b, total_b, c0p, S, s, b, base, par);
        grid.sync();
        if (tid < C && !m.committed[tid]) {
          float vb = -INFINITY, av = -INFINITY;
          int bn = ktt::PW_IMAX, an = ktt::PW_IMAX, hard = 0;
          for (int s2 = 0; s2 < S; ++s2) {
            const int64_t q2 = (int64_t)par * gridDim.x + (int64_t)tid * S + s2;
            const float v1 = __ldcg(x.rv + q2 * 2), v2 = __ldcg(x.rv + q2 * 2 + 1);
            const int n1 = __ldcg(x.ri + q2 * 3), n2 = __ldcg(x.ri + q2 * 3 + 1);
            hard |= __ldcg(x.ri + q2 * 3 + 2);
            if (ktt::pw_better(v1, n1, vb, bn)) {
              vb = v1;
              bn = n1;
            }
            if (ktt::pw_better(v2, n2, av, an)) {
              av = v2;
              an = n2;
            }
          }
          const float t_val = fmaxf(av, vb);
          const int t_n = vb > av ? bn : (av > vb ? an : min(an, bn));
          m.t[tid] = (t_val > -INFINITY && a.pvalid[c0p + tid]) ? t_n : -1;
          m.hard[tid] = hard;
        }
        __syncthreads();
        if (it + 1 < iters) {
          if (tid < C && !m.committed[tid]) m.c[tid] = m.t[tid];
          __syncthreads();
        }
      }
      // D. commit
      if (tid == 0) commit_shard(g, m, x, c0p, C, s, b, base);
      grid.sync();
      // E. the count planes: every block on its share of its shard's nodes
      for (int s2 = 0; s2 < S; ++s2) {
        const int ne = __ldcg(x.n_ents + s2);
        const CommitEnt* ents = x.ents + (int64_t)s2 * C * MAX_ENT;
        for (int n = b * blockDim.x + tid; n < nl; n += C * blockDim.x)
          for (int k = 0; k < ne; ++k) ktt::apply_entry(a, ktt::load_ent(ents + k), n);
        if (b == 0 && tid == 0)
          for (int k = 0; k < ne; ++k) {  // this shard's copy of total_t
            const CommitEnt e = ktt::load_ent(ents + k);
            if (e.plane == 0 && e.dcol < a.D) a.total_t[e.t] = __ldcg(a.total_t + e.t) + e.w;
          }
      }
      grid.sync();
      if (!m.cont) break;
    }
    if (s == 0 && b == 0 && tid < C) {
      choices[c0p + tid] = m.out[tid];
      ordinals[c0p + tid] = m.base_rounds + m.ord[tid];
    }
    __syncthreads();
    if (tid == 0) m.base_rounds += m.nrounds;
    __syncthreads();
  }
  if (s == 0 && b == 0 && tid == 0) {
    scal[0] = m.base_rounds;
    scal[1] |= m.status;
  }
}

}  // namespace

// ptrs, dims, sw, wp, ip, fp: as ktt_full_scan's, and ptrs[26] the class of
// each pod row i32[P] (class-row mode: the plane pointers are the class
// planes [U1, *]) or NULL (dense mode); ptrs[27..33] done and the start state
// (pairwise.cuh read_gate); scal[1] is ORed into, not written; sp: the scratch pointers
// (feas, base, sraw, ipraw, total, topv, topi, c0, c, t, hard, unc, ctrl,
// ents, n_ents); C: pods per chunk (<= 32, dividing P); iters: repair
// iterations per round
extern "C" int ktt_rounds(const void* const* ptrs, const int* dims, const int* sw, const float* wp, const int* ip,
                          const float* fp, void* choices, void* ordinals, void* scal, void* const* sp, int C,
                          int iters, void* stream) {
  FullArgs a;
  const int bad = ktt::read_full_args(ptrs, dims, sw, wp, ip, fp, a);
  if (bad) return bad;
  if (C < 1 || C > MAXC || a.P % C != 0 || iters < 1) return (int)cudaErrorInvalidValue;
  RoundsScratch s;
  s.feas = static_cast<uint8_t*>(sp[0]);
  s.base = static_cast<float*>(sp[1]);
  s.sraw = static_cast<float*>(sp[2]);
  s.ipraw = static_cast<float*>(sp[3]);
  s.total = static_cast<float*>(sp[4]);
  s.topv = static_cast<float*>(sp[5]);
  s.topi = static_cast<int32_t*>(sp[6]);
  s.c0 = static_cast<int32_t*>(sp[7]);
  s.c = static_cast<int32_t*>(sp[8]);
  s.t = static_cast<int32_t*>(sp[9]);
  s.hard = static_cast<int32_t*>(sp[10]);
  s.unc = static_cast<int32_t*>(sp[11]);
  s.ctrl = static_cast<int32_t*>(sp[12]);
  s.ents = static_cast<CommitEnt*>(sp[13]);
  s.n_ents = static_cast<int32_t*>(sp[14]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int dev = 0, nsm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rounds_kernel, ktt::PW_NT, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1 || nsm * per_sm < C) return (int)cudaErrorInvalidConfiguration;
  int32_t* ch = static_cast<int32_t*>(choices);
  int32_t* od = static_cast<int32_t*>(ordinals);
  int32_t* sc = static_cast<int32_t*>(scal);
  void* args[] = {&a, &s, &C, &iters, &ch, &od, &sc};
  err = cudaLaunchCooperativeKernel((void*)rounds_kernel, dim3(C), dim3(ktt::PW_NT), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef KTT_ROUNDS_PHASES
// cycles, hits: host arrays of PH_N; reads the phase counters, then zeroes them
extern "C" int ktt_rounds_phases(unsigned long long* cycles, unsigned long long* hits) {
  const unsigned long long zero[PH_N] = {};
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(hits, g_phase_hits, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_hits, zero, sizeof(zero));
  return (int)err;
}
#endif

// shard mode: ptrs / dims / sw / wp / ip / fp as ktt_rounds' for shard 0's
// arrays (the pod side; dims[1] = nl; ptrs[19] and [28] the replicated usage
// and its start [N, R]; done NULL); shard_ptrs: S rows of pairwise.cuh
// ShardPtrs' 18 pointers (their used / used0: the shard's slice of the
// replicated usage); rows: the row scratch (feas [S, C, nl] bytes; base,
// sraw, ipraw, total [S, C, nl] f32); xs: the exchange (RoundsX's order);
// n_glob: the global (padded) node count.  A cooperative launch of C * S
// blocks.
extern "C" int ktt_rounds_shard(const void* const* ptrs, const int* dims, const int* sw, const float* wp,
                                const int* ip, const float* fp, const void* const* shard_ptrs, int S, int n_glob,
                                void* choices, void* ordinals, void* scal, void* const* rows, void* const* xs, int C,
                                int iters, void* stream) {
  FullArgs g;
  const int bad = ktt::read_full_args(ptrs, dims, sw, wp, ip, fp, g);
  if (bad) return bad;
  if (C < 1 || C > MAXC || g.P % C != 0 || iters < 1 || S < 1 || S > ktt::PW_MAX_SHARDS || g.done != nullptr ||
      n_glob != S * g.N)
    return (int)cudaErrorInvalidValue;
  ktt::ShardTable tab = ktt::make_shard_table(shard_ptrs, S, g.N);
  ShardRows r{static_cast<uint8_t*>(rows[0]), static_cast<float*>(rows[1]), static_cast<float*>(rows[2]),
              static_cast<float*>(rows[3]), static_cast<float*>(rows[4])};
  RoundsX x{static_cast<float*>(xs[0]),   static_cast<float*>(xs[1]),   static_cast<float*>(xs[2]),
            static_cast<int32_t*>(xs[3]), static_cast<float*>(xs[4]),   static_cast<int32_t*>(xs[5]),
            static_cast<float*>(xs[6]),   static_cast<int32_t*>(xs[7]), static_cast<CommitEnt*>(xs[8]),
            static_cast<int32_t*>(xs[9])};
  int dev = 0, nsm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rounds_shard_kernel, ktt::PW_NT, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1 || nsm * per_sm < C * S) return (int)cudaErrorInvalidConfiguration;
  int32_t* ch = static_cast<int32_t*>(choices);
  int32_t* od = static_cast<int32_t*>(ordinals);
  int32_t* sc = static_cast<int32_t*>(scal);
  void* args[] = {&g, &tab, &r, &x, &C, &iters, &n_glob, &ch, &od, &sc};
  err = cudaLaunchCooperativeKernel((void*)rounds_shard_kernel, dim3(C * S), dim3(ktt::PW_NT), args, 0,
                                    reinterpret_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
