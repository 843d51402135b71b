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
// write it between grid barriers.
//
// Class-row mode (K12 on the resident class state, the JAX package's
// schedule_scan_rounds(inc=), ops/assign.py:1613-1619, :1722-1753): with
// `cls` set, the static, eligibility, taint, node-affinity and image planes
// have one row per pod CLASS, and pod p reads row cls[p] of each
// (PodSlots::prow).  The class static plane leaves pod_valid out; the
// node_feasible test folds it back in per pod (ps.valid, :1741), as it
// does in dense mode, where the plane already holds it.
//
// Shard mode (K2, K11 and K12 on a node mesh, parallel/sharded.py; the JAX
// package's sharded scans, ops/assign.py:56-110): K2 and K11 give a block
// one node shard, K12 a run of nodes that may span shards; either sees a
// shard through shard_view -- a copy of the launch's FullArgs whose
// node-side pointers and N are the shard's (ShardPtrs), so every device
// function below runs on the shard's local node ids 0..nl and reads
// node-axis data only through that shard's pointers.  The pieces a
// shard contributes to a cross-shard reduction are split out:
// pod_scalars_partial / pod_scalars_finish (the spread minMatch: the
// partial maxima of -count, combined across shards before inf -> 0, as the
// JAX package takes the pmin before it, pairwise.py:54-58), row_feas /
// row_scalars / row_total (the normalisation maxima, then the total row and
// its argmax with the global ids id_base + n) and commit_entries with no
// total_t (each shard keeps its own copy and adds the winner's entries).

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
  float tw, naw, sw, ipw, iw, hpaw;    // stage weights
  ScoreParams sp;
  // pod side
  const int32_t* preq;    // [P, R]
  const uint8_t* pvalid;  // [P]
  // the plane rows: pods, or classes when cls is set
  const int32_t* cls;     // [P] class of each pod row, or NULL (dense mode)
  const uint32_t* sfs;    // [rows, W] packed static feasibility (dense: pod_valid included)
  const uint32_t* eligs;  // [rows, W] packed nodesel & node_valid (spread's minMatch)
  const __nv_bfloat16* traw;   // [rows, N] PreferNoSchedule counts, or NULL
  const __nv_bfloat16* naraw;  // [rows, N] preferred node-affinity weights, or NULL
  const __nv_bfloat16* img_s;  // [rows, N] image scores, or NULL
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
  const __nv_bfloat16* traw;
  const __nv_bfloat16* naraw;
  const __nv_bfloat16* img_s;
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
    p.traw = static_cast<const __nv_bfloat16*>(r[2]);
    p.naraw = static_cast<const __nv_bfloat16*>(r[3]);
    p.img_s = static_cast<const __nv_bfloat16*>(r[4]);
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
  float best;
  int best_n;
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
  a.traw = static_cast<const __nv_bfloat16*>(ptrs[4]);
  a.naraw = static_cast<const __nv_bfloat16*>(ptrs[5]);
  a.img_s = static_cast<const __nv_bfloat16*>(ptrs[6]);
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

// block-wide max of KR values (every thread gets the results); red holds
// KR * 32 floats; begins and ends with a barrier-safe use of red
template <int KR>
__device__ void block_max(float (&v)[KR], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < KR; ++k)
    for (int off = 16; off > 0; off >>= 1) v[k] = fmaxf(v[k], __shfl_xor_sync(PW_FULL, v[k], off));
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < KR; ++k) red[k * 32 + warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < KR; ++k) {
    float x = -INFINITY;
    for (int w = 0; w < nw; ++w) x = fmaxf(x, red[k * 32 + w]);
    v[k] = x;
  }
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

// load pod p's request and slots into ps (thread 0); the caller syncs
__device__ void load_pod(const FullArgs& a, int p, PodSlots& ps) {
  if (threadIdx.x != 0) return;
  for (int r = 0; r < a.R; ++r) ps.req[r] = a.preq[(int64_t)p * a.R + r];
  ps.valid = a.pvalid[p];
  ps.prow = a.cls != nullptr ? (int64_t)a.cls[p] : (int64_t)p;
  ps.n_sp = ps.n_af = ps.n_an = ps.n_m = ps.n_pf = ps.n_port = 0;
  ps.self_all = 1;
  if (a.pw) {
    for (int c = 0; c < a.CS; ++c) {
      const int t = a.spread_t[(int64_t)p * a.CS + c];
      if (t < 0) continue;
      ps.sp_t[ps.n_sp] = t;
      ps.sp_skew[ps.n_sp] = a.skew[(int64_t)p * a.CS + c];
      ps.sp_hard[ps.n_sp] = a.hard[(int64_t)p * a.CS + c];
      ++ps.n_sp;
    }
    for (int c = 0; c < a.A1; ++c) {
      const int t = a.aff[(int64_t)p * a.A1 + c];
      if (t < 0) continue;
      ps.af_t[ps.n_af++] = t;
      if (!a.aself[(int64_t)p * a.A1 + c]) ps.self_all = 0;
    }
    for (int c = 0; c < a.A2; ++c) {
      const int t = a.anti[(int64_t)p * a.A2 + c];
      if (t >= 0) ps.an_t[ps.n_an++] = t;
    }
    for (int c = 0; c < a.M; ++c) {
      const int t = a.mt[(int64_t)p * a.M + c];
      if (t < 0) continue;
      ps.m_t[ps.n_m] = t;
      ps.m_v[ps.n_m] = a.mv[(int64_t)p * a.M + c];
      ++ps.n_m;
    }
    if (a.ips) {
      for (int c = 0; c < a.B; ++c) {
        const int t = a.pref_t[(int64_t)p * a.B + c];
        if (t < 0) continue;
        ps.pf_t[ps.n_pf] = t;
        ps.pf_w[ps.n_pf] = a.pref_w[(int64_t)p * a.B + c];
        ++ps.n_pf;
      }
    }
  }
  if (a.ports)
    for (int q = 0; q < a.PT; ++q)
      if (a.pod_ports[(int64_t)p * a.PT + q]) ps.port[ps.n_port++] = q;
}

// the round-start pairwise scalars of the loaded pod, partial: the
// required-affinity waiver (no match anywhere and the pod matches its own
// terms) and, per spread slot, the block's max of -count over the keyed
// eligible nodes into ps.sp_mm (-inf: none; min as -max(-x), the inf
// sentinel kept).  Every thread calls it; it ends with a barrier.
__device__ void pod_scalars_partial(const FullArgs& a, int p, PodSlots& ps, float* red) {
  if (!a.pw) return;
  if (threadIdx.x == 0) {
    float total_any = 0.0f;
    for (int k = 0; k < ps.n_af; ++k) total_any += __ldcg(a.total_t + ps.af_t[k]);
    ps.waiver = ps.n_af > 0 && total_any == 0.0f && ps.self_all;
  }
  for (int c = 0; c < ps.n_sp; ++c) {
    const int t = ps.sp_t[c];
    float v[1] = {-INFINITY};
    for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
      if (pw_bit(a.eligs, ps.prow, a.W, n) && a.dbt[(int64_t)t * a.N + n] < a.D)
        v[0] = fmaxf(v[0], -__ldcg(a.cnt + (int64_t)t * a.N + n));
    }
    block_max<1>(v, red);
    if (threadIdx.x == 0) ps.sp_mm[c] = v[0];
  }
  __syncthreads();
}

// thread 0: each slot's minMatch from the (combined) max of -count, inf -> 0
__device__ __forceinline__ void pod_scalars_finish(PodSlots& ps) {
  for (int c = 0; c < ps.n_sp; ++c) {
    const float mm = -ps.sp_mm[c];
    ps.sp_mm[c] = isinf(mm) ? 0.0f : mm;
  }
}

// the round-start pairwise scalars of the loaded pod on one device.  Every
// thread calls it.
__device__ void pod_scalars(const FullArgs& a, int p, PodSlots& ps, float* red) {
  if (!a.pw) return;
  pod_scalars_partial(a, p, ps, red);
  if (threadIdx.x == 0) pod_scalars_finish(ps);
  __syncthreads();
}

// node n's feasibility for the loaded pod (fit against the running usage,
// ports, spread, inter-pod required), with its base score, spread raw and
// inter-pod preferred raw
__device__ __forceinline__ bool node_feasible(const FullArgs& a, int p, const PodSlots& ps, int n,
                                              float& base, float& sraw, float& ipraw) {
  if (!ps.valid || !pw_bit(a.sfs, ps.prow, a.W, n)) return false;
  const int64_t nr = (int64_t)n * a.R;
  const int* req = ps.req;
  if (!fit_ok(a.R, [&](int r) { return req[r]; }, [&](int r) { return __ldcg(a.used + nr + r); },
              [&](int r) { return a.alloc[nr + r]; }))
    return false;
  for (int k = 0; k < ps.n_port; ++k)
    if (__ldcg(a.ports_used + (int64_t)n * a.PT + ps.port[k])) return false;
  sraw = 0.0f;
  ipraw = 0.0f;
  if (a.pw) {
    const int N = a.N, D = a.D;
    for (int c = 0; c < ps.n_sp; ++c) {
      const int64_t i = (int64_t)ps.sp_t[c] * N + n;
      const bool hk = a.dbt[i] < D;
      const float cnt = __ldcg(a.cnt + i);
      if (ps.sp_hard[c] && !(hk && cnt + 1.0f - ps.sp_mm[c] <= (float)ps.sp_skew[c])) return false;
      sraw += hk ? cnt : 0.0f;
    }
    bool aff_all = true;
    for (int k = 0; k < ps.n_af; ++k) {
      const int64_t i = (int64_t)ps.af_t[k] * N + n;
      aff_all = aff_all && a.dbt[i] < D && __ldcg(a.cnt + i) > 0.0f;
    }
    if (!(aff_all || ps.waiver)) return false;
    for (int k = 0; k < ps.n_an; ++k) {
      const int64_t i = (int64_t)ps.an_t[k] * N + n;
      if (a.dbt[i] < D && __ldcg(a.cnt + i) > 0.0f) return false;
    }
    float blocked = 0.0f;
    for (int k = 0; k < ps.n_m; ++k) {
      const int64_t i = (int64_t)ps.m_t[k] * N + n;
      blocked += (a.dbt[i] < D ? __ldcg(a.antin + i) : 0.0f) * ps.m_v[k];
    }
    if (blocked != 0.0f) return false;
    if (a.ips) {
      float own = 0.0f, sym = 0.0f;
      for (int k = 0; k < ps.n_pf; ++k) {
        const int64_t i = (int64_t)ps.pf_t[k] * N + n;
        own += (a.dbt[i] < D ? __ldcg(a.cnt + i) : 0.0f) * ps.pf_w[k];
      }
      for (int k = 0; k < ps.n_m; ++k) {
        const int64_t i = (int64_t)ps.m_t[k] * N + n;
        sym += (a.dbt[i] < D ? __ldcg(a.pref + i) : 0.0f) * ps.m_v[k];
      }
      ipraw = own + sym;
    }
  }
  base = score_flat(a.sp, [&](int r) { return wadd(__ldcg(a.used + nr + r), req[r]); },
                    [&](int r) { return a.alloc[nr + r]; });
  return true;
}

__device__ __forceinline__ float bf(const __nv_bfloat16* x, int64_t i) { return __bfloat162float(x[i]); }

// the total score of a feasible node from its base and raws: fit +
// balanced, taint, node affinity, spread, inter-pod, image, in that order
__device__ __forceinline__ float node_total(const FullArgs& a, const RowScalars& s, int64_t pn, float base,
                                            float sraw, float ipraw) {
  float total = base;
  if (a.taint) {
    const float c = bf(a.traw, pn);
    total = total + a.tw * ((s.t_mx > 0.0f) ? (100.0f - (100.0f * c) / s.t_mx) : 100.0f);
  }
  if (a.nap) {
    const float c = bf(a.naraw, pn);
    total = total + a.naw * ((s.na_mx > 0.0f) ? (c * 100.0f) / s.na_mx : 0.0f);
  }
  if (a.pw) total = total + a.sw * ((s.s_mx > 0.0f) ? (100.0f - (100.0f * sraw) / s.s_mx) : 100.0f);
  if (a.ips) {
    const float x = (s.ip_mx > s.ip_mn) ? (100.0f * (ipraw - s.ip_mn)) / (s.ip_mx - s.ip_mn) : 0.0f;
    total = total + a.ipw * x;
  }
  if (a.img) total = total + a.iw * bf(a.img_s, pn);
  return total;
}

// one pod's row, first pass (pod_scalars already run): feasibility and
// raws per node into the row scratch, and in m[5] the block's maxima of the
// taint, node-affinity and spread raws and of +-the inter-pod raw over the
// feasible nodes (every thread gets them).  Every thread calls it.
__device__ void row_feas(const FullArgs& a, int p, const PodSlots& ps, uint8_t* feas_r, float* base_r,
                         float* sraw_r, float* ipraw_r, float (&m)[5], float* red) {
  m[0] = 0.0f;
  m[1] = 0.0f;
  m[2] = 0.0f;
  m[3] = -INFINITY;
  m[4] = -INFINITY;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    float base = 0.0f, sraw = 0.0f, ipraw = 0.0f;
    const bool f = node_feasible(a, p, ps, n, base, sraw, ipraw);
    feas_r[n] = f;
    if (!f) continue;
    base_r[n] = base;
    sraw_r[n] = sraw;
    ipraw_r[n] = ipraw;
    const int64_t pn = ps.prow * a.N + n;
    if (a.taint) m[0] = fmaxf(m[0], bf(a.traw, pn));
    if (a.nap) m[1] = fmaxf(m[1], bf(a.naraw, pn));
    m[2] = fmaxf(m[2], sraw);
    m[3] = fmaxf(m[3], ipraw);
    m[4] = fmaxf(m[4], -ipraw);
  }
  block_max<5>(m, red);
}

// the normalisation scalars from the (combined) maxima of row_feas
__device__ __forceinline__ RowScalars row_scalars(const float (&m)[5]) {
  RowScalars sc;
  sc.t_mx = m[0];
  sc.na_mx = m[1];
  sc.s_mx = m[2];
  sc.ip_mx = m[3];
  sc.ip_mn = -m[4];
  sc.best = -INFINITY;
  sc.best_n = PW_IMAX;
  return sc;
}

// one pod's row, second pass: the masked total row and its argmax (value
// desc, lowest id) into s, with s.best_n the global id id_base + n.  Every
// thread calls it; it ends with a barrier.
__device__ void row_total(const FullArgs& a, const PodSlots& ps, RowScalars sc, const uint8_t* feas_r,
                          const float* base_r, const float* sraw_r, const float* ipraw_r, float* total_r, int id_base,
                          RowScalars& s, float* red, int* redi) {
  float best = -INFINITY;
  int best_n = PW_IMAX;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    float total = -INFINITY;
    if (feas_r[n]) total = node_total(a, sc, ps.prow * a.N + n, base_r[n], sraw_r[n], ipraw_r[n]);
    total_r[n] = total;
    if (total > best) {  // nodes ascend per thread: keeps the lowest index
      best = total;
      best_n = n;
    }
  }
  block_argmax(best, best_n, red, redi);
  if (threadIdx.x == 0) {
    sc.best = best;
    sc.best_n = best_n == PW_IMAX ? PW_IMAX : id_base + best_n;
    s = sc;
  }
  __syncthreads();
}

// one pod's row on one device (pod_scalars already run): row_feas, the
// scalars, row_total.  Every thread calls it.
__device__ void row_pass(const FullArgs& a, int p, const PodSlots& ps, uint8_t* feas_r, float* base_r,
                         float* sraw_r, float* ipraw_r, float* total_r, RowScalars& s, float* red, int* redi) {
  float m[5];
  row_feas(a, p, ps, feas_r, base_r, sraw_r, ipraw_r, m, red);
  row_total(a, ps, row_scalars(m), feas_r, base_r, sraw_r, ipraw_r, total_r, 0, s, red, redi);
}

// commit entries of pod p placed on node `choice` (thread 0 only):
// matched terms into cnt (and into total_t where the key is present, unless
// total_t is NULL), its own anti terms into anti, with the interpod score
// its preferred terms and, at hardPodAffinityWeight, its required-affinity
// terms into pref
__device__ int commit_entries(const FullArgs& a, int p, int choice, CommitEnt* out, float* total_t) {
  int n = 0;
  if (!a.pw) return 0;
  for (int c = 0; c < a.M; ++c) {
    const int t = a.mt[(int64_t)p * a.M + c];
    if (t < 0) continue;
    const int d = a.dbt[(int64_t)t * a.N + choice];
    const float w = a.mv[(int64_t)p * a.M + c];
    out[n++] = CommitEnt{0, t, d, w};
    if (total_t != nullptr && d < a.D) total_t[t] = __ldcg(total_t + t) + w;
  }
  for (int c = 0; c < a.A2; ++c) {
    const int t = a.anti[(int64_t)p * a.A2 + c];
    if (t >= 0) out[n++] = CommitEnt{1, t, a.dbt[(int64_t)t * a.N + choice], 1.0f};
  }
  if (a.ips) {
    for (int c = 0; c < a.B; ++c) {
      const int t = a.pref_t[(int64_t)p * a.B + c];
      if (t >= 0) out[n++] = CommitEnt{2, t, a.dbt[(int64_t)t * a.N + choice], a.pref_w[(int64_t)p * a.B + c]};
    }
    if (a.hpaw != 0.0f)
      for (int c = 0; c < a.A1; ++c) {
        const int t = a.aff[(int64_t)p * a.A1 + c];
        if (t >= 0) out[n++] = CommitEnt{2, t, a.dbt[(int64_t)t * a.N + choice], a.hpaw};
      }
  }
  return n;
}

// a commit entry written by another block, read through L2 as one int4
__device__ __forceinline__ CommitEnt load_ent(const CommitEnt* e) {
  const int4 v = __ldcg(reinterpret_cast<const int4*>(e));
  return CommitEnt{v.x, v.y, v.z, __int_as_float(v.w)};
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
