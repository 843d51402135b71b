// Per-node pieces of the full stage set, shared by full_scan.cu (K11) and
// rounds.cu (K12): one pod's row over the nodes — static and fit
// feasibility, NodePorts, PodTopologySpread and InterPodAffinity against
// the per-node count state, the per-pod normalisation scalars, the total
// score and its argmax — and the commit of a placed pod into that state.
//
// The port of the JAX package's ops/pairwise.py:33-151 (B9: _rows,
// spread_step, interpod_required_ok, interpod_pref_raw, ports_ok,
// commit_counts) and of the step body of ops/assign.py:258-334
// (schedule_scan), in the op order of kubernetes_tpu_torch/ops/pairwise.py
// and ops/assign.py schedule_scan_plain.  Every pairwise sum is an
// integer-valued f32 (counts times integer weights), exact below 2^24 in
// any order, so each thread sums its slots in its own order; the score
// arithmetic keeps the plain version's op order and the build passes
// -fmad=false.  The state planes are [T, N] f32 in global memory (L2
// resident at config 3: 3 x 80 x 6144 x 4 B = 5.9 MB) and every read of
// mutable state goes through __ldcg: other blocks of a cooperative grid
// write it between grid barriers.  K11 (one cluster) and K12's re-hoist
// (a cluster a pod) walk a block's run of the node axis with the per-node
// functions below, load a pod's slots a warp a section (load_pod_warps) and
// combine each block's maxima across the cluster (block_max_into).
//
// Class-row mode (K12 on the resident class state, the JAX package's
// schedule_scan_rounds(inc=), ops/assign.py:1613-1619, :1722-1753): with
// `cls` set, the static, eligibility, taint, node-affinity and image planes
// have one row per pod CLASS, and pod p reads row cls[p] of each
// (PodSlots::prow).  The class static plane leaves pod_valid out; the
// node_feasible test folds it back in per pod (ps.valid, :1741), as it
// does in dense mode, where the plane already holds it.
//
// Shard mode (K11 and K12 on a node mesh, parallel/sharded.py; the JAX
// package's sharded scans, ops/assign.py:56-110): a block's run of the
// global node ids may span shards; a node is seen through its shard's
// shard_view -- a copy of the launch's FullArgs whose node-side pointers
// and N are the shard's (ShardPtrs) -- picked by view_at, so every device
// function below runs on the shard's local node ids 0..nl and reads
// node-axis data only through that shard's pointers.

#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"

namespace ktt {

constexpr int PW_MAX_S = 16;  // spread / affinity / anti / preferred / port slots per pod
constexpr int PW_MAX_M = 32;  // matched-term slots per pod
constexpr int PW_MAX_PT = 64;  // host ports in the vocabulary
constexpr int PW_NT = 1024;   // threads per block of K11 and K12
constexpr int PW_NWARP = PW_NT / 32;
constexpr unsigned PW_FULL = 0xffffffffu;
constexpr int PW_IMAX = 0x7fffffff;

struct FullArgs {
  int P, N, R, W, T, D, PT;
  int CS, A1, A2, B, M;  // slot widths of the per-pod arrays
  int pw, ips, ports, taint, nap, img;  // stage switches
  int f32;  // the score planes are f32 (KTPU_SCORE_DTYPE=f32), else bf16
  float tw, naw, sw, ipw, iw, hpaw;    // stage weights
  ScoreParams sp;
  // pod side
  const int32_t* preq;    // [P, R]
  const uint8_t* pvalid;  // [P]
  // the plane rows: pods, or classes when cls is set
  const int32_t* cls;     // [P] class of each pod row, or NULL (dense mode)
  const uint32_t* sfs;    // [rows, W] packed static feasibility (dense: pod_valid included)
  const uint32_t* eligs;  // [rows, W] packed nodesel & node_valid (spread's minMatch)
  // the score planes, bf16 or f32 (f32), read through bf()
  const void* traw;   // [rows, N] PreferNoSchedule counts, or NULL
  const void* naraw;  // [rows, N] preferred node-affinity weights, or NULL
  const void* img_s;  // [rows, N] image scores, or NULL
  const int32_t* spread_t;  // [P, CS]
  const int32_t* skew;      // [P, CS]
  const uint8_t* hard;      // [P, CS]
  const int32_t* aff;       // [P, A1]
  const uint8_t* aself;     // [P, A1]
  const int32_t* anti;      // [P, A2]
  const int32_t* mt;        // [P, M]
  const float* mv;          // [P, M]
  const int32_t* pref_t;    // [P, B]
  const float* pref_w;      // [P, B]
  const uint8_t* pod_ports;  // [P, PT]
  // node side
  const int32_t* alloc;  // [N, R]
  int32_t* used;         // [N, R] the running usage
  const int32_t* dbt;    // [T, N] node_dom[term_key]
  float* cnt;            // [T, N] the running per-node state
  float* antin;
  float* pref;
  float* total_t;        // [T]
  uint8_t* ports_used;   // [N, PT]
  // the start state (used0 ... ports0), which a launch copies into the
  // running state above itself, and the gang fixpoint's gated mode
  // (ops/gang.py; NULL outside it): a launch returns at entry once *done is
  // set, so the running state of the last real launch survives every
  // gated one
  const int32_t* done;   // [1]
  const int32_t* used0;  // [N, R]
  const float* cnt0;     // [T, N]
  const float* anti0;    // [T, N]
  const float* pref0;    // [T, N]
  const float* total0;   // [T]
  const uint8_t* ports0;  // [N, PT]
};

constexpr int PW_MAX_SHARDS = 8;  // node shards of a shard-mode launch

// one node shard's node-axis pointers (shard mode): its planes, state and
// start state, its first global node id and its node count
struct ShardPtrs {
  const uint32_t* sfs;
  const uint32_t* eligs;
  const void* traw;
  const void* naraw;
  const void* img_s;
  const int32_t* alloc;
  int32_t* used;
  const int32_t* dbt;
  float* cnt;
  float* antin;
  float* pref;
  float* total_t;  // the shard's own copy of the replicated [T]
  uint8_t* ports_used;
  const int32_t* used0;
  const float* cnt0;
  const float* anti0;
  const float* pref0;
  const uint8_t* ports0;
  int base, nl;
};
constexpr int PW_SHARD_PTRS = 18;  // pointers per shard in the host table

struct ShardTable {
  int S;
  ShardPtrs sh[PW_MAX_SHARDS];
};

// host side: the table from S rows of PW_SHARD_PTRS pointers (ShardPtrs'
// order); shard s owns the global ids [s * nl, (s + 1) * nl)
inline ShardTable make_shard_table(const void* const* q, int S, int nl) {
  ShardTable t{};
  t.S = S;
  for (int s = 0; s < S; ++s) {
    const void* const* r = q + (int64_t)s * PW_SHARD_PTRS;
    ShardPtrs& p = t.sh[s];
    p.sfs = static_cast<const uint32_t*>(r[0]);
    p.eligs = static_cast<const uint32_t*>(r[1]);
    p.traw = r[2];
    p.naraw = r[3];
    p.img_s = r[4];
    p.alloc = static_cast<const int32_t*>(r[5]);
    p.used = static_cast<int32_t*>(const_cast<void*>(r[6]));
    p.dbt = static_cast<const int32_t*>(r[7]);
    p.cnt = static_cast<float*>(const_cast<void*>(r[8]));
    p.antin = static_cast<float*>(const_cast<void*>(r[9]));
    p.pref = static_cast<float*>(const_cast<void*>(r[10]));
    p.total_t = static_cast<float*>(const_cast<void*>(r[11]));
    p.ports_used = static_cast<uint8_t*>(const_cast<void*>(r[12]));
    p.used0 = static_cast<const int32_t*>(r[13]);
    p.cnt0 = static_cast<const float*>(r[14]);
    p.anti0 = static_cast<const float*>(r[15]);
    p.pref0 = static_cast<const float*>(r[16]);
    p.ports0 = static_cast<const uint8_t*>(r[17]);
    p.base = s * nl;
    p.nl = nl;
  }
  return t;
}

// the launch's arguments as shard p sees them (thread 0 writes `a`, the
// caller syncs): N is the shard's node count, the node-side pointers its own
__device__ __forceinline__ void shard_view(const FullArgs& g, const ShardPtrs& p, FullArgs& a) {
  a = g;
  a.N = p.nl;
  a.W = (p.nl + 31) / 32;
  a.sfs = p.sfs;
  a.eligs = p.eligs;
  a.traw = p.traw;
  a.naraw = p.naraw;
  a.img_s = p.img_s;
  a.alloc = p.alloc;
  a.used = p.used;
  a.dbt = p.dbt;
  a.cnt = p.cnt;
  a.antin = p.antin;
  a.pref = p.pref;
  a.total_t = p.total_t;
  a.ports_used = p.ports_used;
  a.used0 = p.used0;
  a.cnt0 = p.cnt0;
  a.anti0 = p.anti0;
  a.pref0 = p.pref0;
  a.ports0 = p.ports0;
}

// node n's view (the launch's arguments on one device, its shard's in
// shard mode, views[s] the shard_view of shard s) and its id l there; shard
// s holds the global ids [s * nl, (s + 1) * nl)
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

// one pod's slots, compacted to the valid entries (a -1 slot adds nothing)
struct PodSlots {
  int64_t prow;  // the pod's row of the static and score planes
  int req[SCORE_MAX_R];
  int sp_t[PW_MAX_S], sp_skew[PW_MAX_S];
  uint8_t sp_hard[PW_MAX_S];
  float sp_mm[PW_MAX_S];  // spread minMatch per slot, this round's
  int af_t[PW_MAX_S];
  int an_t[PW_MAX_S];
  int m_t[PW_MAX_M];
  float m_v[PW_MAX_M];
  int pf_t[PW_MAX_S];
  float pf_w[PW_MAX_S];
  int port[PW_MAX_PT];
  int n_sp, n_af, n_an, n_m, n_pf, n_port;
  int valid, self_all;
  int waiver;
};

struct RowScalars {
  float t_mx, na_mx, s_mx, ip_mx, ip_mn;
};

// a commit-list entry: plane (0 cnt, 1 anti, 2 pref), term row, the chosen
// node's domain under the term's key, the weight
struct CommitEnt {
  int plane, t, dcol;
  float w;
};

// the start state, copied by the threads i0, i0 + step, ... (the caller
// synchronises before anything reads it)
__device__ void copy_start_state(const FullArgs& a, int64_t i0, int64_t step) {
  const int64_t nr = (int64_t)a.N * a.R, tn = (int64_t)a.T * a.N, np = (int64_t)a.N * a.PT;
  for (int64_t i = i0; i < nr; i += step) a.used[i] = a.used0[i];
  for (int64_t i = i0; i < tn; i += step) {
    a.cnt[i] = a.cnt0[i];
    a.antin[i] = a.anti0[i];
    a.pref[i] = a.pref0[i];
  }
  for (int64_t i = i0; i < a.T; i += step) a.total_t[i] = a.total0[i];
  for (int64_t i = i0; i < np; i += step) a.ports_used[i] = a.ports0[i];
}

// the pointer array of ktt_full_scan / ktt_rounds past the running state:
// [26] the class index (K12), [27] done (NULL outside the gated mode),
// [28..33] used0, cnt0, anti0, pref0, total0, ports0
inline void read_gate(FullArgs& a, const void* const* q) {
  a.done = static_cast<const int32_t*>(q[27]);
  a.used0 = static_cast<const int32_t*>(q[28]);
  a.cnt0 = static_cast<const float*>(q[29]);
  a.anti0 = static_cast<const float*>(q[30]);
  a.pref0 = static_cast<const float*>(q[31]);
  a.total0 = static_cast<const float*>(q[32]);
  a.ports0 = static_cast<const uint8_t*>(q[33]);
}

// host side: the FullArgs of the C entries of K11 and K12 from their host
// arrays (ptrs: see read_gate; ptrs[26] the class index or NULL) -> 0, or
// the CUDA error of an argument the kernels do not take
inline int read_full_args(const void* const* ptrs, const int* dims, const int* sw, const float* wp, const int* ip,
                          const float* fp, FullArgs& a) {
  a.sp = make_score_params(ip, fp);
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
  a.f32 = sw[6];
  a.tw = wp[0];
  a.naw = wp[1];
  a.sw = wp[2];
  a.ipw = wp[3];
  a.iw = wp[4];
  a.hpaw = wp[5];
  if (!score_params_ok(a.sp, a.R) || a.N <= 0 || a.P < 0 || a.T < 1 || a.CS > PW_MAX_S ||
      a.A1 > PW_MAX_S || a.A2 > PW_MAX_S || a.B > PW_MAX_S || a.M > PW_MAX_M ||
      a.PT > PW_MAX_PT)
    return (int)cudaErrorInvalidValue;
  a.preq = static_cast<const int32_t*>(ptrs[0]);
  a.pvalid = static_cast<const uint8_t*>(ptrs[1]);
  a.sfs = static_cast<const uint32_t*>(ptrs[2]);
  a.eligs = static_cast<const uint32_t*>(ptrs[3]);
  a.traw = ptrs[4];
  a.naraw = ptrs[5];
  a.img_s = ptrs[6];
  a.spread_t = static_cast<const int32_t*>(ptrs[7]);
  a.skew = static_cast<const int32_t*>(ptrs[8]);
  a.hard = static_cast<const uint8_t*>(ptrs[9]);
  a.aff = static_cast<const int32_t*>(ptrs[10]);
  a.aself = static_cast<const uint8_t*>(ptrs[11]);
  a.anti = static_cast<const int32_t*>(ptrs[12]);
  a.mt = static_cast<const int32_t*>(ptrs[13]);
  a.mv = static_cast<const float*>(ptrs[14]);
  a.pref_t = static_cast<const int32_t*>(ptrs[15]);
  a.pref_w = static_cast<const float*>(ptrs[16]);
  a.pod_ports = static_cast<const uint8_t*>(ptrs[17]);
  a.alloc = static_cast<const int32_t*>(ptrs[18]);
  a.used = static_cast<int32_t*>(const_cast<void*>(ptrs[19]));
  a.dbt = static_cast<const int32_t*>(ptrs[20]);
  a.cnt = static_cast<float*>(const_cast<void*>(ptrs[21]));
  a.antin = static_cast<float*>(const_cast<void*>(ptrs[22]));
  a.pref = static_cast<float*>(const_cast<void*>(ptrs[23]));
  a.total_t = static_cast<float*>(const_cast<void*>(ptrs[24]));
  a.ports_used = static_cast<uint8_t*>(const_cast<void*>(ptrs[25]));
  a.cls = static_cast<const int32_t*>(ptrs[26]);
  read_gate(a, ptrs);
  if ((a.taint && !a.traw) || (a.nap && !a.naraw) || (a.img && !a.img_s) || (a.pw && !a.eligs) ||
      !(a.used0 && a.cnt0 && a.anti0 && a.pref0 && a.total0 && a.ports0))
    return (int)cudaErrorInvalidValue;
  return 0;
}

__device__ __forceinline__ bool pw_bit(const uint32_t* plane, int64_t row, int W, int n) {
  return (plane[row * W + (n >> 5)] >> (n & 31)) & 1u;
}

__device__ __forceinline__ bool pw_better(float v, int i, float v2, int i2) {
  return v > v2 || (v == v2 && i < i2);
}

// block-wide (value desc, index asc) best; every thread gets it
__device__ void block_argmax(float& v, int& i, float* redv, int* redi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(PW_FULL, v, off);
    const int oi = __shfl_xor_sync(PW_FULL, i, off);
    if (pw_better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
  __syncthreads();
  if (lane == 0) {
    redv[warp] = v;
    redi[warp] = i;
  }
  __syncthreads();
  v = -INFINITY;
  i = PW_IMAX;
  for (int w = 0; w < nw; ++w)
    if (pw_better(redv[w], redi[w], v, i)) {
      v = redv[w];
      i = redi[w];
    }
}

// load_pod's slots of pod p, a warp a section (lanes over the slots, a
// ballot's prefix keeping the slot order), warps w0 .. w0 + 6 of the block:
// the request and flags, spread, required affinity (and whether the pod
// matches all of it), anti, matched terms, preferred terms, host ports.
// The caller synchronises.
__device__ void load_pod_warps(const FullArgs& a, int p, PodSlots& ps, int w0 = 0) {
  const int lane = threadIdx.x & 31, w = (int)(threadIdx.x >> 5) - w0;
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
    const unsigned b = __ballot_sync(PW_FULL, t >= 0);
    if (t >= 0) {
      const int k = __popc(b & lt);
      ps.sp_t[k] = t;
      ps.sp_skew[k] = a.skew[q * a.CS + lane];
      ps.sp_hard[k] = a.hard[q * a.CS + lane];
    }
    if (lane == 0) ps.n_sp = __popc(b);
  } else if (a.pw && w == 2) {
    const int t = lane < a.A1 ? a.aff[q * a.A1 + lane] : -1;
    const unsigned b = __ballot_sync(PW_FULL, t >= 0);
    const unsigned other = __ballot_sync(PW_FULL, t >= 0 && !a.aself[q * a.A1 + lane]);
    if (t >= 0) ps.af_t[__popc(b & lt)] = t;
    if (lane == 0) {
      ps.n_af = __popc(b);
      ps.self_all = other == 0u;
    }
  } else if (a.pw && w == 3) {
    const int t = lane < a.A2 ? a.anti[q * a.A2 + lane] : -1;
    const unsigned b = __ballot_sync(PW_FULL, t >= 0);
    if (t >= 0) ps.an_t[__popc(b & lt)] = t;
    if (lane == 0) ps.n_an = __popc(b);
  } else if (a.pw && w == 4) {
    const int t = lane < a.M ? a.mt[q * a.M + lane] : -1;
    const unsigned b = __ballot_sync(PW_FULL, t >= 0);
    if (t >= 0) {
      const int k = __popc(b & lt);
      ps.m_t[k] = t;
      ps.m_v[k] = a.mv[q * a.M + lane];
    }
    if (lane == 0) ps.n_m = __popc(b);
  } else if (a.pw && a.ips && w == 5) {
    const int t = lane < a.B ? a.pref_t[q * a.B + lane] : -1;
    const unsigned b = __ballot_sync(PW_FULL, t >= 0);
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
      const unsigned b = __ballot_sync(PW_FULL, on);
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
    for (int off = 16; off > 0; off >>= 1) v[k] = fmaxf(v[k], __shfl_xor_sync(PW_FULL, v[k], off));
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

// node n's feasibility for the loaded pod (fit against the running usage,
// ports, spread, inter-pod required), with its base score, spread raw and
// inter-pod preferred raw.  After the static bit no load waits on another
// test's outcome (every test is folded into one flag, every load issued
// unconditionally): a node costs about two L2 round trips instead of one a
// test, where one node a thread leaves the row pass latency-bound (K11's
// feasibility pass took 7.9 -> 4.7 us a pod at config 3).  The values, and
// the op order of every sum, are the early-exit form's.
__device__ __forceinline__ bool node_feasible(const FullArgs& a, int p, const PodSlots& ps, int n,
                                              float& base, float& sraw, float& ipraw) {
  if (!ps.valid || !pw_bit(a.sfs, ps.prow, a.W, n)) return false;
  const int64_t nr = (int64_t)n * a.R;
  const int* req = ps.req;
  bool ok = true;
  for (int r = 0; r < a.R; ++r)  // fit_ok
    ok &= req[r] == 0 || req[r] <= wsub(a.alloc[nr + r], __ldcg(a.used + nr + r));
  for (int k = 0; k < ps.n_port; ++k) ok &= !__ldcg(a.ports_used + (int64_t)n * a.PT + ps.port[k]);
  sraw = 0.0f;
  ipraw = 0.0f;
  if (a.pw) {
    const int N = a.N, D = a.D;
    for (int c = 0; c < ps.n_sp; ++c) {
      const int64_t i = (int64_t)ps.sp_t[c] * N + n;
      const bool hk = a.dbt[i] < D;
      const float cnt = __ldcg(a.cnt + i);
      if (ps.sp_hard[c]) ok &= hk && cnt + 1.0f - ps.sp_mm[c] <= (float)ps.sp_skew[c];
      sraw += hk ? cnt : 0.0f;
    }
    bool aff_all = true;
    for (int k = 0; k < ps.n_af; ++k) {
      const int64_t i = (int64_t)ps.af_t[k] * N + n;
      const bool hk = a.dbt[i] < D;
      const float cnt = __ldcg(a.cnt + i);
      aff_all = aff_all && hk && cnt > 0.0f;
    }
    ok &= aff_all || ps.waiver;
    for (int k = 0; k < ps.n_an; ++k) {
      const int64_t i = (int64_t)ps.an_t[k] * N + n;
      const bool hk = a.dbt[i] < D;
      const float cnt = __ldcg(a.cnt + i);
      ok &= !(hk && cnt > 0.0f);
    }
    float blocked = 0.0f;
    for (int k = 0; k < ps.n_m; ++k) {
      const int64_t i = (int64_t)ps.m_t[k] * N + n;
      const bool hk = a.dbt[i] < D;
      const float x = __ldcg(a.antin + i);
      blocked += (hk ? x : 0.0f) * ps.m_v[k];
    }
    ok &= blocked == 0.0f;
    if (a.ips) {
      float own = 0.0f, sym = 0.0f;
      for (int k = 0; k < ps.n_pf; ++k) {
        const int64_t i = (int64_t)ps.pf_t[k] * N + n;
        const bool hk = a.dbt[i] < D;
        const float x = __ldcg(a.cnt + i);
        own += (hk ? x : 0.0f) * ps.pf_w[k];
      }
      for (int k = 0; k < ps.n_m; ++k) {
        const int64_t i = (int64_t)ps.m_t[k] * N + n;
        const bool hk = a.dbt[i] < D;
        const float x = __ldcg(a.pref + i);
        sym += (hk ? x : 0.0f) * ps.m_v[k];
      }
      ipraw = own + sym;
    }
  }
  if (!ok) return false;
  base = score_flat(a.sp, [&](int r) { return wadd(__ldcg(a.used + nr + r), req[r]); },
                    [&](int r) { return a.alloc[nr + r]; });
  return true;
}

// element i of a score plane as f32: every read of traw, naraw and img_s
// goes through here; f32 (FullArgs::f32) is uniform across the launch
__device__ __forceinline__ float bf(const void* x, int64_t i, int f32) {
  return f32 ? static_cast<const float*>(x)[i] : __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i]);
}

// the total score of a feasible node from its base and raws: fit +
// balanced, taint, node affinity, spread, inter-pod, image, in that order
__device__ __forceinline__ float node_total(const FullArgs& a, const RowScalars& s, int64_t pn, float base,
                                            float sraw, float ipraw) {
  float total = base;
  if (a.taint) {
    const float c = bf(a.traw, pn, a.f32);
    total = total + a.tw * ((s.t_mx > 0.0f) ? (100.0f - (100.0f * c) / s.t_mx) : 100.0f);
  }
  if (a.nap) {
    const float c = bf(a.naraw, pn, a.f32);
    total = total + a.naw * ((s.na_mx > 0.0f) ? (c * 100.0f) / s.na_mx : 0.0f);
  }
  if (a.pw) total = total + a.sw * ((s.s_mx > 0.0f) ? (100.0f - (100.0f * sraw) / s.s_mx) : 100.0f);
  if (a.ips) {
    const float x = (s.ip_mx > s.ip_mn) ? (100.0f * (ipraw - s.ip_mn)) / (s.ip_mx - s.ip_mn) : 0.0f;
    total = total + a.ipw * x;
  }
  if (a.img) total = total + a.iw * bf(a.img_s, pn, a.f32);
  return total;
}

// the normalisation scalars from the (combined) maxima of row_feas
__device__ __forceinline__ RowScalars row_scalars(const float (&m)[5]) {
  RowScalars sc;
  sc.t_mx = m[0];
  sc.na_mx = m[1];
  sc.s_mx = m[2];
  sc.ip_mx = m[3];
  sc.ip_mn = -m[4];
  return sc;
}

// apply one commit entry at node n: its row gains the weight where the node
// shares the chosen node's domain
__device__ __forceinline__ void apply_entry(const FullArgs& a, const CommitEnt e, int n) {
  const int64_t i = (int64_t)e.t * a.N + n;
  if (a.dbt[i] != e.dcol) return;
  float* plane = e.plane == 0 ? a.cnt : (e.plane == 1 ? a.antin : a.pref);
  plane[i] = __ldcg(plane + i) + e.w;
}

}  // namespace ktt
