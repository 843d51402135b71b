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

__device__ __forceinline__ CommitEnt load_ent(const CommitEnt* e) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(e));
  return CommitEnt{v.x, v.y, v.z, __int_as_float(v.w)};
}

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
      int uij[ktt::SCORE_MAX_R];
      for (int r = 0; r < a.R; ++r) uij[r] = __ldcg(a.used + (int64_t)cn * a.R + r);
      for (int k = 0; k < i; ++k)  // the exact prefix usage of node c_j: the int32 adds of k < i
        if (m.actj[k] && m.cj[k] == cn)
          for (int r = 0; r < a.R; ++r) uij[r] = ktt::wadd(uij[r], a.preq[(c0p + k) * a.R + r]);
      const int64_t nr = (int64_t)cn * a.R;
      const int* req = m.ps.req;
      const bool fit = ktt::fit_ok(a.R, [&](int r) { return req[r]; }, [&](int r) { return uij[r]; },
                                   [&](int r) { return a.alloc[nr + r]; });
      const float baseij = ktt::score_flat(a.sp, [&](int r) { return ktt::wadd(uij[r], req[r]); },
                                           [&](int r) { return a.alloc[nr + r]; });
      const bool f0 = __ldcg(feas_i + cn);
      const float sr = f0 ? __ldcg(sraw_i + cn) : 0.0f;
      const float ir = f0 ? __ldcg(ipraw_i + cn) : 0.0f;
      const int64_t pn = m.ps.prow * a.N + cn;
      const float nt = ktt::node_total(a, rs, pn, baseij, sr, ir);
      mj = (f0 && fit) ? nt : -INFINITY;
      bn = cn;
      bool extreme = false;
      if (a.taint) extreme = extreme || (rs.t_mx > 0.0f && ktt::bf(a.traw, pn) == rs.t_mx);
      if (a.nap) extreme = extreme || (rs.na_mx > 0.0f && ktt::bf(a.naraw, pn) == rs.na_mx);
      if (a.pw) extreme = extreme || (rs.s_mx > 0.0f && sr == rs.s_mx);
      if (a.ips) extreme = extreme || (rs.ip_mx > rs.ip_mn && (ir == rs.ip_mx || ir == rs.ip_mn));
      hard = m.share[j] || (f0 && !fit && extreme);
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
    n_ents += ktt::commit_entries(a, (int)p, cf, s.ents + n_ents);
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
        for (int k = 0; k < n_ents; ++k) ktt::apply_entry(a, load_ent(s.ents + k), n);
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
    scal[1] = m.status;
  }
}

}  // namespace

// ptrs, dims, sw, wp, ip, fp: as ktt_full_scan's, and ptrs[26] the class of
// each pod row i32[P] (class-row mode: the plane pointers are the class
// planes [U1, *]) or NULL (dense mode); sp: the scratch pointers
// (feas, base, sraw, ipraw, total, topv, topi, c0, c, t, hard, unc, ctrl,
// ents, n_ents); C: pods per chunk (<= 32, dividing P); iters: repair
// iterations per round
extern "C" int ktt_rounds(const void* const* ptrs, const int* dims, const int* sw, const float* wp, const int* ip,
                          const float* fp, void* choices, void* ordinals, void* scal, void* const* sp, int C,
                          int iters, void* stream) {
  FullArgs a;
  a.sp = ktt::make_score_params(ip, fp);
  a.P = dims[0];
  a.N = dims[1];
  a.R = dims[2];
  a.T = dims[3];
  a.D = dims[4];
  a.PT = dims[5];
  a.CS = dims[6];
  a.A1 = dims[7];
  a.A2 = dims[8];
  a.B = dims[9];
  a.M = dims[10];
  a.W = (a.N + 31) / 32;
  a.pw = sw[0];
  a.ips = sw[1];
  a.ports = sw[2];
  a.taint = sw[3];
  a.nap = sw[4];
  a.img = sw[5];
  a.tw = wp[0];
  a.naw = wp[1];
  a.sw = wp[2];
  a.ipw = wp[3];
  a.iw = wp[4];
  a.hpaw = wp[5];
  if (!ktt::score_params_ok(a.sp, a.R) || a.N <= 0 || a.P < 0 || a.T < 1 || C < 1 || C > MAXC || a.P % C != 0 ||
      iters < 1 || a.CS > ktt::PW_MAX_S || a.A1 > ktt::PW_MAX_S || a.A2 > ktt::PW_MAX_S || a.B > ktt::PW_MAX_S ||
      a.M > ktt::PW_MAX_M || a.PT > ktt::PW_MAX_PT)
    return (int)cudaErrorInvalidValue;
  const void* const* q = ptrs;
  a.preq = static_cast<const int32_t*>(q[0]);
  a.pvalid = static_cast<const uint8_t*>(q[1]);
  a.sfs = static_cast<const uint32_t*>(q[2]);
  a.eligs = static_cast<const uint32_t*>(q[3]);
  a.traw = static_cast<const __nv_bfloat16*>(q[4]);
  a.naraw = static_cast<const __nv_bfloat16*>(q[5]);
  a.img_s = static_cast<const __nv_bfloat16*>(q[6]);
  a.spread_t = static_cast<const int32_t*>(q[7]);
  a.skew = static_cast<const int32_t*>(q[8]);
  a.hard = static_cast<const uint8_t*>(q[9]);
  a.aff = static_cast<const int32_t*>(q[10]);
  a.aself = static_cast<const uint8_t*>(q[11]);
  a.anti = static_cast<const int32_t*>(q[12]);
  a.mt = static_cast<const int32_t*>(q[13]);
  a.mv = static_cast<const float*>(q[14]);
  a.pref_t = static_cast<const int32_t*>(q[15]);
  a.pref_w = static_cast<const float*>(q[16]);
  a.pod_ports = static_cast<const uint8_t*>(q[17]);
  a.alloc = static_cast<const int32_t*>(q[18]);
  a.used = static_cast<int32_t*>(const_cast<void*>(q[19]));
  a.dbt = static_cast<const int32_t*>(q[20]);
  a.cnt = static_cast<float*>(const_cast<void*>(q[21]));
  a.antin = static_cast<float*>(const_cast<void*>(q[22]));
  a.pref = static_cast<float*>(const_cast<void*>(q[23]));
  a.total_t = static_cast<float*>(const_cast<void*>(q[24]));
  a.ports_used = static_cast<uint8_t*>(const_cast<void*>(q[25]));
  a.cls = static_cast<const int32_t*>(q[26]);
  if ((a.taint && !a.traw) || (a.nap && !a.naraw) || (a.img && !a.img_s) || (a.pw && !a.eligs))
    return (int)cudaErrorInvalidValue;
  if (a.P == 0) return (int)cudaGetLastError();
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
