// K8 chunk_rounds_dense: the dense mode of the chunked commit scan.
//
// Replaces the lax.scan(chunk, used_init, (reqs, sfs, valids)) of the JAX
// package's ops/assign.py:1418-1420 with its body in dense mode: per chunk
// of C = 128 pods (:1126-1168) the masked hoist total0 [C, N] against the
// usage the earlier chunks left (the unpacked static words sfs & the fit
// test, the fit + BalancedAllocation score), the exact top-K list of each
// pod (K = min(C + 1, N), lax.top_k's order), the prefix-commit round loop
// (:1170-1347; stat_at reads total0 > -inf), the usage update, and the
// ordinals of :1422-1444 (the rounds of the earlier chunks plus the pod's
// own round).  The round loop is the one of ops/assign.py _round_loop,
// which the plain version shares with the inc mode.
//
// Design: one cooperative persistent launch walks the P / C chunks in
// order, with no host synchronisation per chunk or per round.  Per chunk c:
//   1. block 0 runs chunk c's round loop with the chunk's state in shared
//      memory, while the other blocks hoist chunk c + 1 (a block a pod row:
//      total0 against the usage before chunk c, into the second of two
//      [C, N] buffers) and select each row's top-(K + C) list; grid.sync();
//   2. block 0 adds chunk c's requests to the usage, and the whole grid
//      patches chunk c + 1's rows at the nodes chunk c committed to (its
//      dirty slots, which block 0 leaves with their usage): those columns
//      of total0 are rescored and the stale lists, less their dirty
//      entries, merged with them into the exact top-K lists; grid.sync().
// So the hoist and the selection, ~100 us a chunk at the north star, run
// behind the round loop; the first chunk is hoisted on the whole grid.
// The round loop (the part that sets the time: a chain of ~2000 dependent
// rounds at the north star) has no per-thread scan over the chunk's pods.
// Every "is there an earlier pod j with c[j] == node" of the plain version
// is an O(1) lookup in a node table in shared memory: open addressing keyed
// by node, holding the pods keyed to the node as a 128-bit mask (the list
// heads; the round's pass-1 picks, whose masks also give the next same-node
// pick, the same-node usage prefix, the first committed picker and the
// dirty-slot increments) or their least index (the speculation's claims).
// Ranks of new dirty slots are ballot/popc prefixes.  M2, the pods rescored
// at the dirty slots, is kept current column by column: a round rescores
// only the slots the last round created or changed (at most C per chunk in
// all), and a new slot's static bits are read from total0 once.  Pass 2's
// static bits at the earlier picks' nodes are one parallel read of total0
// (16 loads a thread); its pods are revalidated in order, 32 at a time,
// stopping after the batch that holds the first mismatch (later pods
// cannot commit this round).  The tie orders and every comparison are the
// plain version's.  Every block reads what other blocks wrote through L2
// (__ldcg).  Inputs are never written; used, choices and ordinals are fresh
// buffers.
//
// Bounds on an H100 at the north star (400 chunks, 2027 rounds): the hoist
// scores 128 x 20480 (pod, node) pairs per chunk, ~1.05 G in all at ~45
// f32 operations each (>= 0.7 ms at 67 TFLOP/s); the bytes are the 131 MB
// of static words plus the usage rows and the [C, N] scratch of each chunk
// (>= 0.04 ms for the words alone at 3.35 TB/s).  Neither sets the time:
// the chain of 2027 dependent rounds in block 0, ~15 block barriers each,
// and two grid barriers a chunk do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"
#include "topk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;
constexpr int NWARP = NT / 32;
constexpr int MAXC = 128;
constexpr int CW = MAXC / 32;  // words of a pod mask
constexpr int MAXK = MAXC + 1;
constexpr int MAXKW = (MAXK + 31) / 32;
constexpr int MAXZ = 16;
constexpr int MAXR = ktt::SCORE_MAX_R;
constexpr int HBITS = 8;
constexpr int HT = 1 << HBITS;  // slots of a node table, >= 2 MAXC
constexpr int BLOOM = 256;      // words of the committed-node filter
constexpr int TOPK_L = 512;     // the stale lists' selection buffer (KL <= MAXK + MAXC)
constexpr int IMAX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

struct DenseArgs {
  const int32_t* preq;    // [P, R]
  const uint8_t* pvalid;  // [P]
  const int32_t* alloc;   // [N, R]
  const int32_t* used_in; // [N, R]: the cycle start's usage
  const uint32_t* sfs;    // [P, W]: K7's packed static plane
  int32_t* choices;       // [P] out
  int32_t* used;          // [N, R] out: the running usage
  int32_t* ordinals;      // [P] out
  int32_t* scal;          // [2] out: sweeps, status (1: round cap hit; OR-ed into scal[1])
  const int32_t* done;    // [1] or NULL: return at entry once set (the gang fixpoint's device loop)
  float* total0;          // [2, C, N] scratch: the masked scores of a chunk and of the next (by chunk parity)
  float* topv;            // [C, K] scratch: the chunk's lists
  int32_t* topi;          // [C, K]
  float* stv;             // [C, KL] scratch: the next chunk's lists against the usage before this chunk
  int32_t* sti;           // [C, KL]
  int32_t* nf;            // [C] scratch: finite entries of each list
  int32_t* dn;            // [1] scratch: the nodes this chunk committed to (its dirty slots) ...
  int32_t* dnode;         // [C]   ... their ids
  int32_t* dused;         // [C, R] ... and their usage after the chunk
  ktt::ScoreParams sp;
  int P, N, R, W, C, K, KL, Z, spec_iters;
};

#ifdef KTT_DENSE_PHASES
// A build with -DKTT_DENSE_PHASES (kubernetes_tpu_torch/bench/dense_phases.py)
// makes thread 0 of block 0 add the SM cycles between the phase boundaries
// into g_phase_cycles and count each boundary it passes in g_phase_hits
// (wave_commit.cu's method).  Each boundary follows a block or grid barrier
// (KTT_PHASE_SYNC adds a block barrier in this build only), so a phase's
// cycles are block 0's whole time in it.
enum {
  PH_SETUP, PH_HOIST, PH_PATCH, PH_RESCORE, PH_LIST, PH_SPEC, PH_PICK, PH_P2SETUP, PH_P2EVAL, PH_PREFIX,
  PH_ABSORB, PH_USAGE, PH_BARRIER, PH_N
};
__device__ unsigned long long g_phase_cycles[PH_N];
__device__ unsigned long long g_phase_hits[PH_N];
__device__ long long g_phase_t;
#define KTT_PHASE(k)                                                     \
  do {                                                                   \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                           \
      const long long now = clock64();                                   \
      g_phase_cycles[k] += (unsigned long long)(now - g_phase_t);        \
      g_phase_hits[k] += 1;                                              \
      g_phase_t = now;                                                   \
    }                                                                    \
  } while (0)
#define KTT_PHASE_SYNC(k) \
  do {                    \
    __syncthreads();      \
    KTT_PHASE(k);         \
  } while (0)
#else
#define KTT_PHASE(k) ((void)0)
#define KTT_PHASE_SYNC(k) ((void)0)
#endif

// Node tables: open addressing over HT slots keyed by node id (-1: free),
// at most MAXC keys each, so a probe ends after a slot or two.  A mask
// table keeps the pods keyed to each node as a C-bit mask; a min table
// keeps the least pod index.  They answer "is there an earlier pod j with
// c[j] == node" and its same-node prefixes in O(1) shared-memory reads.
struct MaskTable {
  int key[HT];
  uint32_t m[HT][CW];
};
struct MinTable {
  int key[HT];
  int v[HT];
};

// block 0's state for one chunk (dynamic shared memory, ~215 KB)
struct DenseSmem {
  float M2[MAXC][MAXC];  // pod i rescored at dirty slot d (columns kept current, rows of uncommitted pods)
  int topi[MAXC][MAXK];
  int creq[MAXC][MAXR];
  int dsu[MAXC][MAXR];   // live usage of each dirty slot
  int uj[MAXC][MAXR];    // usage at c[j] after pod j's pick (round-start usage + earlier picks + j)
  uint32_t cleank[MAXC][MAXKW];
  uint8_t upos[MAXC][MAXZ];  // the first Z usable list positions, then the unusable ones
  uint32_t statd[MAXC][CW];  // pod i's static bit at dirty slot d
  uint32_t statp[MAXC][CW];  // pod i's static bit at pick j's node, this round
  MaskTable heads, acts;     // the round's list heads; its pass-1 picks
  MinTable claims[3];        // the speculation's claims, rotating
  uint32_t bloom[BLOOM];     // the nodes the committed prefix picked, by node & (32 BLOOM - 1)
  int cvalid[MAXC], committed[MAXC], out[MAXC], ord[MAXC], nfv[MAXC], dlist[MAXC];
  int c[MAXC], nus[MAXC], ptr[MAXC], okr[MAXC], head[MAXC];
  int act[MAXC], hasslot[MAXC], sl[MAXC], fd[MAXC], nxt[MAXC], ent[MAXC];
  int updlist[MAXC], updnew[MAXC];  // the slots the last round created or changed
  uint32_t uncm[CW], ownm[CW], newm[CW];
  int nd, nd_next, nupd, nrounds, done, status, firstbad;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int hslot(int node) { return (int)(((uint32_t)node * 2654435761u) >> (32 - HBITS)); }

// the slot of `node`, or -1; the table is read-only in this phase
template <class T>
__device__ __forceinline__ int tfind(const T& t, int node) {
  for (int e = hslot(node);; e = (e + 1) & (HT - 1)) {
    const int k = t.key[e];
    if (k == node) return e;
    if (k < 0) return -1;
  }
}

// the slot of `node`, inserted when missing (threads insert concurrently)
template <class T>
__device__ __forceinline__ int tinsert(T& t, int node) {
  for (int e = hslot(node);; e = (e + 1) & (HT - 1)) {
    const int k = *reinterpret_cast<volatile int*>(&t.key[e]);
    if (k == node) return e;
    if (k < 0) {
      const int old = atomicCAS(&t.key[e], -1, node);
      if (old < 0 || old == node) return e;
    }
  }
}

__device__ __forceinline__ void tclear(MaskTable& t, int tid) {
  for (int e = tid; e < HT; e += NT) {
    t.key[e] = -1;
#pragma unroll
    for (int w = 0; w < CW; ++w) t.m[e][w] = 0u;
  }
}

__device__ __forceinline__ void tclear(MinTable& t, int tid) {
  for (int e = tid; e < HT; e += NT) {
    t.key[e] = -1;
    t.v[e] = IMAX;
  }
}

// word w of the mask of pods below i
__device__ __forceinline__ uint32_t below(int i, int w) {
  const int b = i - 32 * w;
  return b <= 0 ? 0u : (b >= 32 ? FULL : ((1u << b) - 1u));
}

__device__ __forceinline__ bool pbit(const uint32_t* m, int j) { return (m[j >> 5] >> (j & 31)) & 1u; }

// stat_at: pod i's hoisted entry at node n (tot: the chunk's total0) is feasible
__device__ __forceinline__ bool stat_at(const float* tot, int N, int i, int n) {
  return __ldcg(tot + (int64_t)i * N + n) > -INFINITY;
}

__device__ __forceinline__ float topv_at(const DenseArgs& a, const DenseSmem& s, int i, int k) {
  return s.cvalid[i] ? __ldcg(a.topv + (int64_t)i * a.K + k) : -INFINITY;
}

// step 1: row i of total0 (pod c0 + i) against the running usage; one
// block a row, so a block can select the row's list at once
__device__ void hoist_row(const DenseArgs& a, int c0, int i, float* tot) {
  const int N = a.N, R = a.R;
  const ktt::ScoreParams& sp = a.sp;
  const int p = c0 + i;
  const int32_t* rq = a.preq + (int64_t)p * R;
  const uint32_t* sf = a.sfs + (int64_t)p * a.W;
  for (int n = threadIdx.x; n < N; n += NT) {
    const int32_t* un = a.used + (int64_t)n * R;
    const int32_t* an = a.alloc + (int64_t)n * R;
    auto us = [&](int r) { return __ldcg(un + r); };
    auto al = [&](int r) { return __ldg(an + r); };
    float v = -INFINITY;
    if (((sf[n >> 5] >> (n & 31)) & 1u) && ktt::fit_ok(R, [&](int r) { return __ldg(rq + r); }, us, al))
      v = ktt::score_flat(sp, [&](int r) { return ktt::wadd(us(r), __ldg(rq + r)); }, al);
    tot[(int64_t)i * N + n] = v;
  }
}

// step 2: the lists of the chunk starting at pod c0 on blocks >= b0: a
// block hoists its rows and selects each row's top-KL (KL = K + C, fewer
// when N is smaller) into the stale lists
__device__ void hoist_lists(const DenseArgs& a, int c0, float* tot, int b0, ktt::TopkScratchT<TOPK_L>& tks) {
  for (int i = blockIdx.x - b0; i < a.C; i += gridDim.x - b0) {
    hoist_row(a, c0, i, tot);
    ktt::block_topk(tot + (int64_t)i * a.N, a.N, a.KL, a.stv + (int64_t)i * a.KL, a.sti + (int64_t)i * a.KL, tks);
  }
}

struct PatchSmem {
  int dn[MAXC];
  float dv[MAXC];
  unsigned long long dk[MAXC];
  unsigned long long ck[MAXK];
  int wcnt[NWARP];
  int nfin;
};

// step 4: row i of a chunk hoisted against the usage before the chunk just
// committed (its D dirty nodes) -> its exact top-K list.  Clean columns did
// not change, so the stale top-KL list less its dirty entries keeps >= K
// clean entries, and they are exactly the top-K clean columns in order (any
// clean column outside the list is below all of it); the dirty columns are
// rescored against the new usage (total0 too) and merged in by the same
// (value, -index) key.  The dirty-column argument of the JAX package's
// ops/incremental.py:214 _patch_hoist, per chunk.
__device__ void patch_row(const DenseArgs& a, PatchSmem& ps, int c0, int i, float* tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int N = a.N, R = a.R, K = a.K, KL = a.KL;
  const ktt::ScoreParams& sp = a.sp;
  const int D = __ldcg(a.dn);
  const int p = c0 + i;
  const int32_t* rq = a.preq + (int64_t)p * R;
  for (int d = tid; d < D; d += NT) {  // the dirty columns, rescored
    const int n = __ldcg(a.dnode + d);
    const int32_t* du = a.dused + (int64_t)d * R;
    const int32_t* an = a.alloc + (int64_t)n * R;
    auto us = [&](int r) { return __ldcg(du + r); };
    auto al = [&](int r) { return __ldg(an + r); };
    float v = -INFINITY;
    if (((a.sfs[(int64_t)p * a.W + (n >> 5)] >> (n & 31)) & 1u) &&
        ktt::fit_ok(R, [&](int r) { return __ldg(rq + r); }, us, al))
      v = ktt::score_flat(sp, [&](int r) { return ktt::wadd(us(r), __ldg(rq + r)); }, al);
    tot[(int64_t)i * N + n] = v;
    ps.dn[d] = n;
    ps.dv[d] = v;
    ps.dk[d] = ktt::topk_key(v, n);
  }
  if (tid == 0) ps.nfin = 0;
  __syncthreads();
  // the stale list's clean entries, ranked by a ballot prefix
  bool clean = false;
  float sv = 0.0f;
  int si = 0;
  if (tid < KL) {
    sv = __ldcg(a.stv + (int64_t)i * KL + tid);
    si = __ldcg(a.sti + (int64_t)i * KL + tid);
    clean = true;
    for (int d = 0; d < D; ++d) clean = clean && ps.dn[d] != si;
  }
  const unsigned cm = __ballot_sync(FULL, clean);
  if (lane == 0) ps.wcnt[warp] = __popc(cm);
  __syncthreads();
  int cr = __popc(cm & ((1u << lane) - 1u)), nclean = 0;
  for (int w = 0; w < NWARP; ++w) {
    cr += w < warp ? ps.wcnt[w] : 0;
    nclean += ps.wcnt[w];
  }
  const int kc = min(K, nclean);
  const bool cand = clean && cr < K;
  if (cand) ps.ck[cr] = ktt::topk_key(sv, si);
  __syncthreads();
  // each candidate's place in the merged order (the keys are distinct)
  int fin = 0;
  if (cand) {
    const unsigned long long key = ps.ck[cr];
    int rank = cr;
    for (int d = 0; d < D; ++d) rank += ps.dk[d] > key;
    if (rank < K) {
      a.topv[(int64_t)i * K + rank] = sv;
      a.topi[(int64_t)i * K + rank] = si;
      fin += sv > -INFINITY;
    }
  }
  for (int d = tid; d < D; d += NT) {
    const unsigned long long key = ps.dk[d];
    int rank = 0;
    for (int e = 0; e < D; ++e) rank += ps.dk[e] > key;
    for (int j = 0; j < kc; ++j) rank += ps.ck[j] > key;
    if (rank < K) {
      a.topv[(int64_t)i * K + rank] = ps.dv[d];
      a.topi[(int64_t)i * K + rank] = ps.dn[d];
      fin += ps.dv[d] > -INFINITY;
    }
  }
  if (fin) atomicAdd(&ps.nfin, fin);
  __syncthreads();
  if (tid == 0) a.nf[i] = ps.nfin;
  __syncthreads();
}

// step 3: one chunk's round loop and usage update; block 0 only.  Each
// phase ends at a block barrier; no thread scans the chunk's pods serially.
__device__ void dense_chunk(const DenseArgs& a, DenseSmem& s, int c0, int base, const float* tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, K = a.K, Z = a.Z, R = a.R;
  const int KW = (K + 31) / 32;
  const ktt::ScoreParams& sp = a.sp;
  for (int i = tid; i < C; i += NT) {
    const int p = c0 + i;
    s.cvalid[i] = a.pvalid[p] != 0;
    s.committed[i] = 0;
    s.out[i] = -1;
    s.ord[i] = 0;
    s.dlist[i] = -1;
    s.nfv[i] = s.cvalid[i] ? __ldcg(a.nf + i) : 0;
  }
  for (int idx = tid; idx < C * R; idx += NT) {
    const int i = idx / R, r = idx % R;
    s.creq[i][r] = a.preq[(int64_t)(c0 + i) * R + r];
  }
  for (int idx = tid; idx < C * KW; idx += NT) {
    const int i = idx / KW, w = idx % KW;
    const int nb = min(32, K - 32 * w);
    s.cleank[i][w] = nb == 32 ? FULL : ((1u << nb) - 1u);
  }
  for (int idx = tid; idx < C * CW; idx += NT) s.statd[idx / CW][idx % CW] = 0u;
  for (int idx = tid; idx < C * K; idx += NT) s.topi[idx / K][idx % K] = __ldcg(a.topi + idx);
  tclear(s.heads, tid);
  tclear(s.acts, tid);
  for (int q = 0; q < 3; ++q) tclear(s.claims[q], tid);
  for (int w = tid; w < BLOOM; w += NT) s.bloom[w] = 0u;
  if (tid == 0) {
    s.nd = 0;
    s.nd_next = 0;
    s.nupd = 0;
    s.nrounds = 0;
  }
  __syncthreads();
  KTT_PHASE(PH_SETUP);
  while (true) {
    // ---- the round's start: uncommitted pods, the round cap, fresh tables ----
    if (warp == 0) {
      unsigned any = 0;
#pragma unroll
      for (int w = 0; w < CW; ++w) {
        const int j = 32 * w + lane;
        const unsigned m = __ballot_sync(FULL, j < C && !s.committed[j]);
        if (lane == 0) s.uncm[w] = m;
        any |= m;
      }
      if (lane == 0) {
        s.done = any == 0;
        if (!s.done && s.nrounds > C) {  // every round commits >= 1 pod
          s.status = 1;
          s.done = 1;
        }
        s.nd = s.nd_next;
        s.firstbad = C;
      }
    } else {
      tclear(s.acts, tid - 32);
      for (int w = tid - 32; w < BLOOM; w += NT - 32) s.bloom[w] = 0u;
    }
    for (int d = tid; d < C; d += NT) s.fd[d] = C;
    __syncthreads();
    KTT_PHASE(PH_SETUP);
    if (s.done) break;
    const int nd = s.nd;
    // ---- pass 1: the dirty columns the last round changed, rescored (M2) ----
    {
      const int nu = s.nupd;
      for (int idx = tid; idx < C * nu; idx += NT) {
        const int i = idx / nu, u = idx % nu;
        if (!pbit(s.uncm, i)) continue;
        const int d = s.updlist[u], dl = s.dlist[d];
        bool st;
        if (s.updnew[u]) {
          st = stat_at(tot, a.N, i, dl);
          if (st) atomicOr(&s.statd[i][d >> 5], 1u << (d & 31));
        } else {
          st = pbit(s.statd[i], d);
        }
        float m2 = -INFINITY;
        const int* rqi = s.creq[i];
        const int* du = s.dsu[d];
        const int32_t* ar = a.alloc + (int64_t)dl * R;
        auto al = [&](int r) { return __ldg(ar + r); };
        if (st && ktt::fit_ok(R, [&](int r) { return rqi[r]; }, [&](int r) { return du[r]; }, al))
          m2 = ktt::score_flat(sp, [&](int r) { return ktt::wadd(du[r], rqi[r]); }, al);
        s.M2[i][d] = m2;
      }
    }
    KTT_PHASE_SYNC(PH_RESCORE);
    // the first Z usable list positions, then the unusable ones (the order
    // lax.top_k gives the keys K - k / 0); usable: clean and finite.  Each
    // pod with a usable head enters the head table.
    for (int i = warp; i < C; i += NWARP) {
      if (!pbit(s.uncm, i)) continue;
      unsigned um[MAXKW];
      int nus = 0;
#pragma unroll
      for (int h = 0; h < MAXKW; ++h) {
        const int k = lane + 32 * h;
        const bool us = h < KW && k < K && ((s.cleank[i][h] >> lane) & 1u) && k < s.nfv[i];
        um[h] = __ballot_sync(FULL, us);
        nus += __popc(um[h]);
      }
      int bel = 0;  // usable positions in earlier words
#pragma unroll
      for (int h = 0; h < MAXKW; ++h) {
        const int k = lane + 32 * h;
        if (h < KW && k < K) {
          const int ub = bel + __popc(um[h] & ((1u << lane) - 1u));
          const int slot = ((um[h] >> lane) & 1u) ? ub : nus + (k - ub);
          if (slot < Z) s.upos[i][slot] = (uint8_t)k;
        }
        bel += __popc(um[h]);
      }
      __syncwarp();
      if (lane == 0) {
        s.nus[i] = nus;
        const int hd = s.topi[i][s.upos[i][0]];
        s.head[i] = hd;
        if (nus > 0) {
          const int e = tinsert(s.heads, hd);
          atomicOr(&s.heads.m[e][i >> 5], 1u << (i & 31));
        }
      }
    }
    __syncthreads();
    KTT_PHASE(PH_LIST);
    // the first pointer: the earlier pods with the same usable head, and the
    // first claims
    for (int i = tid; i < C; i += NT) {
      if (!pbit(s.uncm, i)) {
        s.okr[i] = 0;
        continue;
      }
      const int e = tfind(s.heads, s.head[i]);
      int cnt = 0;
      if (e >= 0)
#pragma unroll
        for (int w = 0; w < CW; ++w) cnt += __popc(s.heads.m[e][w] & below(i, w));
      const int p = min(cnt, Z - 1);
      const int ok = p < s.nus[i];
      s.ptr[i] = p;
      s.okr[i] = ok;
      if (a.spec_iters > 0 && ok) {
        const int e2 = tinsert(s.claims[0], s.topi[i][s.upos[i][p]]);
        atomicMin(&s.claims[0].v[e2], i);
      }
    }
    __syncthreads();
    KTT_PHASE(PH_LIST);
    // the speculation: each pod jumps to its first usable entry no earlier
    // pod claims; 16 lanes a pod
    for (int it = 0; it < a.spec_iters; ++it) {
      const MinTable& cl = s.claims[it % 3];
      MinTable& nx = s.claims[(it + 1) % 3];
      tclear(s.claims[(it + 2) % 3], tid);
      for (int idx = tid; idx < ((C * 16 + 31) & ~31); idx += NT) {
        const int i = idx >> 4, z = idx & 15;
        const bool live = i < C && pbit(s.uncm, i);
        bool fr = false;
        if (live && z < Z && z < s.nus[i]) {
          const int e = tfind(cl, s.topi[i][s.upos[i][z]]);
          fr = !(e >= 0 && cl.v[e] < i);
        }
        const unsigned F = (__ballot_sync(FULL, fr) >> (lane & 16)) & 0xffffu;
        if (live && z == 0) {
          const int p = F ? __ffs(F) - 1 : Z - 1;
          s.ptr[i] = p;
          s.okr[i] = F != 0;
          if (it + 1 < a.spec_iters && F) {
            const int e2 = tinsert(nx, s.topi[i][s.upos[i][p]]);
            atomicMin(&nx.v[e2], i);
          }
        }
      }
      __syncthreads();
    }
    KTT_PHASE(PH_SPEC);
    // each pod's pick c: its dirty slots (M2) against the pointed list
    // entry.  Dirty nodes are committed nodes, which every list has dropped,
    // so a pick is a dirty slot's node exactly when it came from M2.
    for (int q = 0; q < 3; ++q) tclear(s.claims[q], tid);
    tclear(s.heads, tid);
    for (int i = warp; i < C; i += NWARP) {
      if (!pbit(s.uncm, i)) {
        if (lane == 0) {
          s.c[i] = -1;
          s.act[i] = 0;
        }
        continue;
      }
      const int sel = s.upos[i][s.ptr[i]];
      const float vu = s.okr[i] ? topv_at(a, s, i, sel) : -INFINITY;
      const int iu = s.topi[i][sel];
      float bm = -INFINITY;
      for (int d = lane; d < nd; d += 32) bm = fmaxf(bm, s.M2[i][d]);
      const float best = fmaxf(warp_max(bm), vu);
      int cd = IMAX, cdd = 0;
      for (int d = lane; d < nd; d += 32)
        if (s.M2[i][d] == best && s.dlist[d] < cd) {
          cd = s.dlist[d];
          cdd = d;
        }
      for (int off = 16; off > 0; off >>= 1) {
        const int ocd = __shfl_xor_sync(FULL, cd, off), ocdd = __shfl_xor_sync(FULL, cdd, off);
        if (ocd < cd) {
          cd = ocd;
          cdd = ocdd;
        }
      }
      const int cand = min(cd, vu == best ? iu : IMAX);
      if (lane == 0) {
        const int ci = (best > -INFINITY && s.cvalid[i]) ? cand : -1;
        const int hs = ci >= 0 && ci == cd;
        s.c[i] = ci;
        s.act[i] = ci >= 0;
        s.hasslot[i] = hs;
        s.sl[i] = hs ? cdd : 0;
        if (ci >= 0) {
          const int e = tinsert(s.acts, ci);
          atomicOr(&s.acts.m[e][i >> 5], 1u << (i & 31));
          s.ent[i] = e;
          if (hs) atomicMin(&s.fd[cdd], i);
        }
      }
    }
    __syncthreads();
    KTT_PHASE(PH_PICK);
    // ---- pass 2 set-up: the next same-node pick, the usage after each
    // pick, and each pod's static bit at the earlier picks' nodes ----
    for (int j = tid; j < C; j += NT) {
      int nxj = C;
      if (s.act[j]) {
        const uint32_t* m = s.acts.m[s.ent[j]];
#pragma unroll
        for (int w = CW - 1; w >= 0; --w) {
          const uint32_t after = m[w] & ~below(j + 1, w);
          if (after) nxj = 32 * w + __ffs(after) - 1;
        }
        const int cj = s.c[j];
        for (int r = 0; r < R; ++r) {
          int v = s.hasslot[j] ? s.dsu[s.sl[j]][r] : __ldcg(a.used + (int64_t)cj * R + r);
#pragma unroll
          for (int w = 0; w < CW; ++w) {
            uint32_t bits = m[w] & below(j + 1, w);
            while (bits) {
              const int k = 32 * w + __ffs(bits) - 1;
              bits &= bits - 1;
              v = ktt::wadd(v, s.creq[k][r]);
            }
          }
          s.uj[j][r] = v;
        }
      }
      s.nxt[j] = nxj;
    }
    {
      const int i = tid >> 3, jb = tid & 7;  // 8 blocks of 16 picks per pod (NT == 8 MAXC)
      uint32_t bits = 0;
      if (i < C && pbit(s.uncm, i)) {
        const float* row = tot + (int64_t)i * a.N;
        float v[16];
#pragma unroll
        for (int b = 0; b < 16; ++b) {
          const int j = jb * 16 + b;
          v[b] = (j < i && s.act[j]) ? __ldcg(row + s.c[j]) : -INFINITY;
        }
#pragma unroll
        for (int b = 0; b < 16; ++b) bits |= (uint32_t)(v[b] > -INFINITY) << b;
      }
      const uint32_t hi = __shfl_xor_sync(FULL, bits, 1);
      if ((jb & 1) == 0 && i < C) s.statp[i][jb >> 1] = bits | (hi << 16);
    }
    __syncthreads();
    KTT_PHASE(PH_P2SETUP);
    // ---- pass 2: revalidate under intra-round prefix commits, pods in
    // order a warp each, up to the batch that holds the first mismatch ----
    for (int b0 = 0; b0 < C; b0 += NWARP) {
      const int i = b0 + warp;
      bool bad = false;
      if (i < C && pbit(s.uncm, i)) {
        const int* rqi = s.creq[i];
        float vals[2 * CW];
        int nodes[2 * CW];
        float bm = -INFINITY;
#pragma unroll
        for (int h = 0; h < CW; ++h) {
          const int d = lane + 32 * h;  // d: a dirty slot, and j = d: a pick
          float m2x = -INFINITY, mij = -INFINITY;
          int nd2 = IMAX, nj = IMAX;
          if (d < nd) {
            nd2 = s.dlist[d];
            m2x = s.fd[d] < i ? -INFINITY : s.M2[i][d];  // superseded by an earlier pick
          }
          const int j = d;
          // pod i at node c_j under the usage of the earlier picks; the
          // same-node picks before the last one give the same entry
          if (j < i && s.act[j] && s.nxt[j] >= i && pbit(s.statp[i], j)) {
            const int cj = s.c[j];
            nj = cj;
            const int* u = s.uj[j];
            const int32_t* ar = a.alloc + (int64_t)cj * R;
            auto al = [&](int r) { return __ldg(ar + r); };
            if (ktt::fit_ok(R, [&](int r) { return rqi[r]; }, [&](int r) { return u[r]; }, al))
              mij = ktt::score_flat(sp, [&](int r) { return ktt::wadd(u[r], rqi[r]); }, al);
          }
          vals[2 * h] = m2x;
          nodes[2 * h] = nd2;
          vals[2 * h + 1] = mij;
          nodes[2 * h + 1] = nj;
          bm = fmaxf(bm, fmaxf(m2x, mij));
        }
        // the first clean list entry not picked by an earlier pod this round
        int jf2 = -1;
        for (int h = 0; h < KW && jf2 < 0; ++h) {
          const int k = lane + 32 * h;
          bool cl = false;
          if (k < K && ((s.cleank[i][h] >> lane) & 1u)) {
            const int e = tfind(s.acts, s.topi[i][k]);
            cl = true;
            if (e >= 0)
#pragma unroll
              for (int w = 0; w < CW; ++w) cl = cl && !(s.acts.m[e][w] & below(i, w));
          }
          const unsigned m = __ballot_sync(FULL, cl);
          if (m) jf2 = 32 * h + __ffs(m) - 1;
        }
        const float vu2 = jf2 >= 0 ? topv_at(a, s, i, jf2) : -INFINITY;
        const int iu2 = s.topi[i][jf2 >= 0 ? jf2 : 0];
        const float best = fmaxf(warp_max(bm), vu2);
        int cd = IMAX;
#pragma unroll
        for (int e = 0; e < 2 * CW; ++e)
          if (vals[e] == best) cd = min(cd, nodes[e]);
        cd = warp_min(cd);
        const int cand = min(cd, vu2 == best ? iu2 : IMAX);
        if (lane == 0) {
          const int ti = (best > -INFINITY && s.cvalid[i]) ? cand : -1;
          bad = ti != s.c[i];
          if (bad) atomicMin(&s.firstbad, i);
        }
      }
      // every thread leaves on the barrier's own result: a warp that went on
      // would write firstbad before a slower one had read it
      if (__syncthreads_or(bad)) break;
    }
    KTT_PHASE(PH_P2EVAL);
    // ---- commit the longest exact prefix; owners: the first committed
    // picker of each node; new dirty slots ranked by ballot ----
    const int fb = s.firstbad;
    uint32_t prefm[CW];
#pragma unroll
    for (int w = 0; w < CW; ++w) prefm[w] = s.uncm[w] & below(fb, w);
    if (warp < CW) {
      const int j = tid;
      bool own = false, isnew = false;
      if (j < C && pbit(prefm, j)) {
        const int cj = s.c[j];
        s.out[j] = cj;
        s.ord[j] = s.nrounds;
        s.committed[j] = 1;
        if (cj >= 0) {
          const uint32_t* m = s.acts.m[s.ent[j]];
          int first = C;
#pragma unroll
          for (int w = CW - 1; w >= 0; --w)
            if (m[w] & prefm[w]) first = 32 * w + __ffs(m[w] & prefm[w]) - 1;
          own = first == j;
          isnew = own && !s.hasslot[j];
          atomicOr(&s.bloom[(cj >> 5) & (BLOOM - 1)], 1u << (cj & 31));
        }
      }
      const unsigned om = __ballot_sync(FULL, own), nm = __ballot_sync(FULL, isnew);
      if (lane == 0) {
        s.ownm[warp] = om;
        s.newm[warp] = nm;
      }
    }
    __syncthreads();
    KTT_PHASE(PH_PREFIX);
    // ---- absorb: the dirty slots' usage, the stale list entries ----
    if (warp < CW) {
      const int j = tid;
      if (j < C && pbit(s.ownm, j)) {
        int rank = 0, urank = 0;
#pragma unroll
        for (int w = 0; w < CW; ++w) {
          rank += __popc(s.newm[w] & below(j, w));
          urank += __popc(s.ownm[w] & below(j, w));
        }
        const int isnew = pbit(s.newm, j);
        const int cj = s.c[j];
        const int slot = isnew ? nd + rank : s.sl[j];
        if (isnew) s.dlist[slot] = cj;
        const uint32_t* m = s.acts.m[s.ent[j]];
        for (int r = 0; r < R; ++r) {
          int add = 0;
#pragma unroll
          for (int w = 0; w < CW; ++w) {
            uint32_t bits = m[w] & prefm[w];
            while (bits) {
              const int k = 32 * w + __ffs(bits) - 1;
              bits &= bits - 1;
              add = ktt::wadd(add, s.creq[k][r]);
            }
          }
          s.dsu[slot][r] = ktt::wadd(isnew ? __ldcg(a.used + (int64_t)cj * R + r) : s.dsu[slot][r], add);
        }
        s.updlist[urank] = slot;
        s.updnew[urank] = isnew;
      }
    }
    for (int i = warp; i < C; i += NWARP) {  // entries the committed prefix picked
      if (s.committed[i]) continue;
      for (int h = 0; h < KW; ++h) {
        const int k = lane + 32 * h;
        bool hit = false;
        if (k < K && ((s.cleank[i][h] >> lane) & 1u)) {
          const int node = s.topi[i][k];
          if ((s.bloom[(node >> 5) & (BLOOM - 1)] >> (node & 31)) & 1u) {
            const int e = tfind(s.acts, node);
            if (e >= 0)
#pragma unroll
              for (int w = 0; w < CW; ++w) hit = hit || (s.acts.m[e][w] & prefm[w]);
          }
        }
        const unsigned m = __ballot_sync(FULL, hit);
        if (lane == 0) s.cleank[i][h] &= ~m;
      }
    }
    if (tid == 0) {
      int nn = 0, no = 0;
#pragma unroll
      for (int w = 0; w < CW; ++w) {
        nn += __popc(s.newm[w]);
        no += __popc(s.ownm[w]);
      }
      s.nd_next = nd + nn;
      s.nupd = no;
      s.nrounds += 1;
    }
    __syncthreads();
    KTT_PHASE(PH_ABSORB);
  }
  // ---- the chunk's outputs and its dirty slots: the nodes it committed to
  // and their usage after it, which the next chunk's lists are patched with ----
  for (int i = tid; i < C; i += NT) {
    a.choices[c0 + i] = s.out[i];
    a.ordinals[c0 + i] = base + s.ord[i];
  }
  for (int idx = tid; idx < s.nd * R; idx += NT) {
    const int d = idx / R, r = idx % R;
    if (r == 0) a.dnode[d] = s.dlist[d];
    a.dused[idx] = s.dsu[d][r];
  }
  if (tid == 0) *a.dn = s.nd;
  __syncthreads();
  KTT_PHASE(PH_USAGE);
}

// the chunk's usage update (block 0, after the next chunk's hoist has read
// the usage before it)
__device__ void usage_update(const DenseArgs& a, const DenseSmem& s) {
  for (int i = threadIdx.x; i < a.C; i += NT) {
    const int o = s.out[i];
    if (o >= 0)
      for (int r = 0; r < a.R; ++r) atomicAdd(a.used + (int64_t)o * a.R + r, s.creq[i][r]);
  }
}

__global__ void __launch_bounds__(NT, 1) chunk_rounds_dense_kernel(DenseArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ ktt::TopkScratchT<TOPK_L> tks;
  __shared__ PatchSmem ps;
  extern __shared__ __align__(16) unsigned char dsm[];
  DenseSmem& s = *reinterpret_cast<DenseSmem*>(dsm);
  const int tid = threadIdx.x;
  // every block reads the same word, written by an earlier launch: the
  // whole grid returns together, before any grid barrier
  if (a.done != nullptr && __ldcg(a.done)) return;
  const int64_t g0 = (int64_t)blockIdx.x * NT + tid, gs = (int64_t)gridDim.x * NT;
  for (int64_t i = g0; i < (int64_t)a.N * a.R; i += gs) a.used[i] = a.used_in[i];
  if (tid == 0) s.status = 0;
  if (blockIdx.x == 0 && tid == 0) *a.dn = 0;
#ifdef KTT_DENSE_PHASES
  if (blockIdx.x == 0 && tid == 0) g_phase_t = clock64();
#endif
  const int C = a.C, nch = a.P / C;
  const int64_t CN = (int64_t)C * a.N;
  // the blocks that hoist the next chunk while block 0 commits this one
  const int hb0 = gridDim.x > 1 ? 1 : 0;
  int base = 0;
  grid.sync();
  KTT_PHASE(PH_SETUP);
  // the first chunk's lists on the whole grid, against the cycle start
  hoist_lists(a, 0, a.total0, 0, tks);
  KTT_PHASE(PH_HOIST);
  grid.sync();
  KTT_PHASE(PH_BARRIER);
  for (int i = blockIdx.x; i < C; i += gridDim.x) patch_row(a, ps, 0, i, a.total0);
  KTT_PHASE(PH_PATCH);
  grid.sync();
  KTT_PHASE(PH_BARRIER);
  for (int c = 0; c < nch; ++c) {
    float* tot = a.total0 + (c & 1) * CN;
    float* nxt = a.total0 + ((c + 1) & 1) * CN;
    const int c0 = c * C;
    // block 0 commits chunk c; the others hoist chunk c + 1 against the
    // usage before chunk c (one SM alone does both in turn)
    if (blockIdx.x == 0) {
      dense_chunk(a, s, c0, base, tot);
      base += s.nrounds;
    }
    if (c + 1 < nch && blockIdx.x >= hb0) hoist_lists(a, c0 + C, nxt, hb0, tks);
    KTT_PHASE(PH_HOIST);
    grid.sync();
    KTT_PHASE(PH_BARRIER);
    // chunk c's usage, and chunk c + 1's lists patched at chunk c's nodes
    if (blockIdx.x == 0) usage_update(a, s);
    if (c + 1 < nch)
      for (int i = blockIdx.x; i < C; i += gridDim.x) patch_row(a, ps, c0 + C, i, nxt);
    KTT_PHASE(PH_PATCH);
    grid.sync();
    KTT_PHASE(PH_BARRIER);
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.scal[0] = base;
    a.scal[1] |= s.status;  // a cap hit in any launch over one pair survives
  }
}

}  // namespace

// ip / fp: the score parameters (score.cuh make_score_params), host memory.
// Scratch: total0 [2, C, N] floats; topv, topi [C, K + KL] each (the lists,
// then the stale lists); dirty >= 1 + C + C R int32 (a chunk's dirty slots).
extern "C" int ktt_chunk_rounds_dense(const void* preq, const void* pvalid, const void* alloc,
                                      const void* used_in, const void* sfs, void* choices, void* used,
                                      void* ordinals, void* scal, void* total0, void* topv, void* topi,
                                      void* nf, void* dirty, const void* done, const int* ip, const float* fp,
                                      int P, int N, int R, int C, int spec_iters, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  DenseArgs a;
  a.sp = ktt::make_score_params(ip, fp);
  const int K = C + 1 < N ? C + 1 : N;
  const int KL = K + C < N ? K + C : N;
  const int Z = MAXZ < K ? MAXZ : K;
  if (!ktt::score_params_ok(a.sp, R) || P <= 0 || N <= 0 || C < 1 || C > MAXC || P % C != 0 ||
      KL > TOPK_L || spec_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int W = (N + 31) / 32;
  a.preq = static_cast<const int32_t*>(preq);
  a.pvalid = static_cast<const uint8_t*>(pvalid);
  a.alloc = static_cast<const int32_t*>(alloc);
  a.used_in = static_cast<const int32_t*>(used_in);
  a.sfs = static_cast<const uint32_t*>(sfs);
  a.choices = static_cast<int32_t*>(choices);
  a.used = static_cast<int32_t*>(used);
  a.ordinals = static_cast<int32_t*>(ordinals);
  a.scal = static_cast<int32_t*>(scal);
  a.done = static_cast<const int32_t*>(done);
  a.total0 = static_cast<float*>(total0);
  a.topv = static_cast<float*>(topv);
  a.topi = static_cast<int32_t*>(topi);
  a.stv = a.topv + (int64_t)C * K;
  a.sti = a.topi + (int64_t)C * K;
  a.nf = static_cast<int32_t*>(nf);
  a.dn = static_cast<int32_t*>(dirty);
  a.dnode = a.dn + 1;
  a.dused = a.dnode + C;
  a.P = P;
  a.N = N;
  a.R = R;
  a.W = W;
  a.C = C;
  a.K = K;
  a.KL = KL;
  a.Z = Z;
  a.spec_iters = spec_iters;
  int dev = 0, nsm = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  const size_t smem = sizeof(DenseSmem);
  err = cudaFuncSetAttribute(chunk_rounds_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chunk_rounds_dense_kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = nsm * per_sm;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)chunk_rounds_dense_kernel, dim3(grid), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef KTT_DENSE_PHASES
// cycles, hits: host arrays of PH_N; reads the phase counters, then zeroes them
extern "C" int ktt_dense_phases(unsigned long long* cycles, unsigned long long* hits) {
  const unsigned long long zero[PH_N] = {};
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(hits, g_phase_hits, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_hits, zero, sizeof(zero));
  return (int)err;
}
#endif
