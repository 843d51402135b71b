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
// order, with no host synchronisation per chunk or per round:
//   1. the whole grid computes total0 into a global scratch (one thread
//      per (node, group of pods): the node's usage and allocation rows are
//      read once per group), then grid.sync();
//   2. block b selects the top-K list of pod row b (topk.cuh), then
//      grid.sync();
//   3. block 0 runs the round loop with the chunk's state in shared memory
//      and total0 read from L2, then adds the committed requests to the
//      usage (atomics: pods may share a node), then grid.sync().
// The round loop is written for C up to 128: per-pod work goes to a warp
// (four pods per warp), pairwise work to the block's threads, and the two
// lookups the plain version makes over [C, K, C] use node bitmaps in global
// memory (nodes picked this round, nodes the committed prefix picked) and
// one slot per pod of the last same-node pick before it.  Every block
// reads what other blocks wrote through L2 (__ldcg).  Inputs are never
// written; used, choices and ordinals are fresh buffers.
//
// Bounds on an H100 at the north star (400 chunks, 2027 rounds): the hoist
// scores 128 x 20480 (pod, node) pairs per chunk, ~1.05 G in all at ~45
// f32 operations each (>= 0.7 ms at 67 TFLOP/s); the bytes are the 131 MB
// of static words plus the usage rows and the [C, N] scratch of each chunk
// (>= 0.04 ms for the words alone at 3.35 TB/s).  Neither sets the time:
// the chain of 400 chunks, three grid barriers each, and 2027 dependent
// rounds in block 0 does.

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
constexpr int MAXK = MAXC + 1;
constexpr int MAXKW = (MAXK + 31) / 32;
constexpr int MAXZ = 16;
constexpr int MAXR = ktt::SCORE_MAX_R;
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
  float* total0;          // [C, N] scratch: the chunk's masked scores
  float* topv;            // [C, K] scratch
  int32_t* topi;          // [C, K] scratch
  int32_t* nf;            // [C] scratch: finite entries of each list
  uint32_t* actbits;      // [W] scratch: nodes picked this round (zero between rounds)
  uint32_t* pactbits;     // [W] scratch: nodes the committed prefix picked
  ktt::ScoreParams sp;
  int P, N, R, W, C, K, Z, spec_iters;
};

// block 0's state for one chunk (dynamic shared memory, ~206 KB)
struct DenseSmem {
  int creq[MAXC][MAXR];
  int dsu[MAXC][MAXR];   // live usage of each dirty slot
  int uj[MAXC][MAXR];    // usage at c[j] after pod j's pick (round-start usage + earlier picks + j)
  float M2[MAXC][MAXC];  // pod i rescored at dirty slot d
  int topi[MAXC][MAXK];
  uint32_t cleank[MAXC][MAXKW];
  int upos[MAXC][MAXZ];
  int nodesz[MAXC][MAXZ];
  int cvalid[MAXC], committed[MAXC], out[MAXC], ord[MAXC], nfv[MAXC], dlist[MAXC];
  int c[MAXC], t[MAXC], nus[MAXC], ptr[MAXC], okr[MAXC], claim[MAXC], head[MAXC];
  int act[MAXC], hasslot[MAXC], sl[MAXC], fd[MAXC], nxt[MAXC];
  int prefix[MAXC], pact[MAXC], owner[MAXC], isnew[MAXC];
  int nd, nrounds, done, status, firstbad;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ bool bit_of(const uint32_t* bits, int n) {
  return (__ldcg(bits + (n >> 5)) >> (n & 31)) & 1u;
}

// stat_at: pod i's hoisted entry at node n is feasible
__device__ __forceinline__ bool stat_at(const DenseArgs& a, int i, int n) {
  return __ldcg(a.total0 + (int64_t)i * a.N + n) > -INFINITY;
}

__device__ __forceinline__ float topv_at(const DenseArgs& a, const DenseSmem& s, int i, int k) {
  return s.cvalid[i] ? __ldcg(a.topv + (int64_t)i * a.K + k) : -INFINITY;
}

// step 1: total0[i, n] for the chunk's pods against the running usage
__device__ void hoist(const DenseArgs& a, int c0) {
  const int N = a.N, R = a.R, C = a.C;
  const int64_t gt = (int64_t)gridDim.x * NT;
  int G = (int)(gt / N);
  G = G < 1 ? 1 : (G > C ? C : G);
  const ktt::ScoreParams& sp = a.sp;
  for (int64_t w = (int64_t)blockIdx.x * NT + threadIdx.x; w < (int64_t)N * G; w += gt) {
    const int n = (int)(w % N), g = (int)(w / N);
    const int32_t* un = a.used + (int64_t)n * R;
    const int32_t* an = a.alloc + (int64_t)n * R;
    auto us = [&](int r) { return __ldcg(un + r); };
    auto al = [&](int r) { return an[r]; };
    for (int i = g; i < C; i += G) {
      const int p = c0 + i;
      const int32_t* rq = a.preq + (int64_t)p * R;
      float v = -INFINITY;
      if (((a.sfs[(int64_t)p * a.W + (n >> 5)] >> (n & 31)) & 1u) &&
          ktt::fit_ok(R, [&](int r) { return rq[r]; }, us, al))
        v = ktt::score_flat(sp, [&](int r) { return ktt::wadd(us(r), rq[r]); }, al);
      a.total0[(int64_t)i * N + n] = v;
    }
  }
}

// step 3: one chunk's round loop and usage update; block 0 only
__device__ void dense_chunk(const DenseArgs& a, DenseSmem& s, int c0, int base) {
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
    s.dsu[i][r] = 0;
  }
  for (int idx = tid; idx < C * KW; idx += NT) {
    const int i = idx / KW, w = idx % KW;
    const int nb = min(32, K - 32 * w);
    s.cleank[i][w] = nb == 32 ? FULL : ((1u << nb) - 1u);
  }
  for (int idx = tid; idx < C * K; idx += NT) s.topi[idx / K][idx % K] = __ldcg(a.topi + idx);
  if (tid == 0) {
    s.nd = 0;
    s.nrounds = 0;
  }
  __syncthreads();
  while (true) {
    if (warp == 0) {
      bool any = false;
      for (int j = lane; j < C; j += 32) any |= !s.committed[j];
      const unsigned m = __ballot_sync(FULL, any);
      if (lane == 0) {
        s.done = m == 0;
        if (!s.done && s.nrounds > C) {  // every round commits >= 1 pod
          s.status = 1;
          s.done = 1;
        }
      }
    }
    __syncthreads();
    if (s.done) break;
    // ---- pass 1: speculative choices vs live usage ----
    for (int idx = tid; idx < C * C; idx += NT) {  // M2[i][d]: dirty slot d rescored
      const int i = idx / C, d = idx % C;
      const int dl = s.dlist[d];
      float m2 = -INFINITY;
      if (dl >= 0 && stat_at(a, i, dl)) {
        const int* rqi = s.creq[i];
        const int* du = s.dsu[d];
        const int32_t* ar = a.alloc + (int64_t)dl * R;
        auto al = [&](int r) { return ar[r]; };
        if (ktt::fit_ok(R, [&](int r) { return rqi[r]; }, [&](int r) { return du[r]; }, al))
          m2 = ktt::score_flat(sp, [&](int r) { return ktt::wadd(du[r], rqi[r]); }, al);
      }
      s.M2[i][d] = m2;
    }
    for (int i = warp; i < C; i += NWARP) {
      // the first Z usable list positions, then the unusable ones (the order
      // lax.top_k gives the keys K - k / 0); usable: clean and finite
      unsigned um[MAXKW];
      int nus = 0;
#pragma unroll
      for (int h = 0; h < MAXKW; ++h) {
        const int k = lane + 32 * h;
        const bool us = h < KW && k < K && ((s.cleank[i][h] >> lane) & 1u) && k < s.nfv[i];
        um[h] = __ballot_sync(FULL, us);
        nus += __popc(um[h]);
      }
      int below = 0;  // usable positions in earlier words
#pragma unroll
      for (int h = 0; h < MAXKW; ++h) {
        const int k = lane + 32 * h;
        if (h < KW && k < K) {
          const int ub = below + __popc(um[h] & ((1u << lane) - 1u));
          const int slot = ((um[h] >> lane) & 1u) ? ub : nus + (k - ub);
          if (slot < Z) s.upos[i][slot] = k;
        }
        below += __popc(um[h]);
      }
      __syncwarp();
      if (lane == 0) {
        s.nus[i] = nus;
        s.head[i] = s.topi[i][s.upos[i][0]];
      }
    }
    __syncthreads();
    for (int i = warp; i < C; i += NWARP) {
      int cnt = 0;
      for (int j0 = 0; j0 < C; j0 += 32) {
        const int j = j0 + lane;
        const bool pr = j < i && s.head[j] == s.head[i] && s.nus[j] > 0 && !s.committed[j];
        cnt += __popc(__ballot_sync(FULL, pr));
      }
      if (lane < Z) s.nodesz[i][lane] = s.topi[i][s.upos[i][lane]];
      if (lane == 0) {
        const int ptr = min(cnt, Z - 1);
        s.ptr[i] = ptr;
        s.okr[i] = ptr < s.nus[i] && !s.committed[i];
      }
    }
    __syncthreads();
    for (int it = 0; it < a.spec_iters; ++it) {
      for (int i = tid; i < C; i += NT) s.claim[i] = s.okr[i] ? s.nodesz[i][s.ptr[i]] : -1;
      __syncthreads();
      for (int i = warp; i < C; i += NWARP) {
        bool fr = false;
        if (lane < Z) {
          const int node = s.nodesz[i][lane];
          bool cb = false;
          for (int j = 0; j < i; ++j) cb |= node == s.claim[j];
          fr = lane < s.nus[i] && !cb;
        }
        const unsigned F = __ballot_sync(FULL, fr);
        if (lane == 0) {
          s.ptr[i] = F ? __ffs(F) - 1 : Z - 1;
          s.okr[i] = F != 0 && !s.committed[i];
        }
      }
      __syncthreads();
    }
    for (int i = warp; i < C; i += NWARP) {
      const int sel = s.upos[i][s.ptr[i]];
      const float vu = s.okr[i] ? topv_at(a, s, i, sel) : -INFINITY;
      const int iu = s.topi[i][sel];
      float bm = -INFINITY;
      for (int d = lane; d < C; d += 32) bm = fmaxf(bm, s.M2[i][d]);
      const float best = fmaxf(warp_max(bm), vu);
      int cd = IMAX;
      for (int d = lane; d < C; d += 32)
        if (s.M2[i][d] == best) cd = min(cd, max(s.dlist[d], 0));
      cd = warp_min(cd);
      const int cand = min(cd, vu == best ? iu : IMAX);
      if (lane == 0) s.c[i] = (best > -INFINITY && !s.committed[i] && s.cvalid[i]) ? cand : -1;
    }
    __syncthreads();
    // ---- pass 2: revalidate under intra-round prefix commits ----
    for (int j = tid; j < C; j += NT) {
      const int cj = s.c[j];
      const bool act = !s.committed[j] && cj >= 0;
      s.act[j] = act;
      int hs = 0, slot = 0;
      for (int d = 0; d < s.nd; ++d)
        if (s.dlist[d] == cj) {
          hs = 1;
          slot = d;
          break;
        }
      s.hasslot[j] = hs;
      s.sl[j] = slot;
      s.fd[j] = C;  // the first picker of dirty slot j, below
      if (act) atomicOr(a.actbits + (cj >> 5), 1u << (cj & 31));
    }
    __syncthreads();
    for (int j = tid; j < C; j += NT) {
      int nxt = C;
      if (s.act[j]) {
        const int cj = s.c[j];
        // the usage pod i > j sees at c[j] when j is the last earlier pick of
        // that node: round-start usage + the picks k <= j of the same node
        for (int r = 0; r < R; ++r) {
          int v = s.hasslot[j] ? s.dsu[s.sl[j]][r] : __ldcg(a.used + (int64_t)cj * R + r);
          for (int k = 0; k <= j; ++k)
            if (s.act[k] && s.c[k] == cj) v = ktt::wadd(v, s.creq[k][r]);
          s.uj[j][r] = v;
        }
        for (int k = j + 1; k < C; ++k)
          if (s.act[k] && s.c[k] == cj) {
            nxt = k;
            break;
          }
        if (s.hasslot[j]) atomicMin(&s.fd[s.sl[j]], j);
      }
      s.nxt[j] = nxt;
    }
    __syncthreads();
    for (int i = warp; i < C; i += NWARP) {
      const int* rqi = s.creq[i];
      float vals[2 * (MAXC / 32)];
      int nodes[2 * (MAXC / 32)];
      float bm = -INFINITY;
#pragma unroll
      for (int h = 0; h < MAXC / 32; ++h) {
        const int d = lane + 32 * h;  // d: a dirty slot, and j = d: a pick
        float m2x = -INFINITY, mij = -INFINITY;
        int nd2 = IMAX, nj = IMAX;
        if (d < C) {
          nd2 = max(s.dlist[d], 0);
          m2x = s.fd[d] < i ? -INFINITY : s.M2[i][d];  // superseded by an earlier pick
          const int j = d, cj = s.c[j];
          nj = max(cj, 0);
          // pod i at node c_j under the usage of the earlier picks; the
          // same-node picks before the last one give the same entry
          if (s.act[j] && j < i && s.nxt[j] >= i && stat_at(a, i, cj)) {
            const int* u = s.uj[j];
            const int32_t* ar = a.alloc + (int64_t)cj * R;
            auto al = [&](int r) { return ar[r]; };
            if (ktt::fit_ok(R, [&](int r) { return rqi[r]; }, [&](int r) { return u[r]; }, al))
              mij = ktt::score_flat(sp, [&](int r) { return ktt::wadd(u[r], rqi[r]); }, al);
          }
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
          const int node = s.topi[i][k];
          cl = true;
          if (bit_of(a.actbits, node)) {
            for (int j = 0; j < i; ++j)
              if (s.act[j] && s.c[j] == node) {
                cl = false;
                break;
              }
          }
        }
        const unsigned m = __ballot_sync(FULL, cl);
        if (m) jf2 = 32 * h + __ffs(m) - 1;
      }
      const float vu2 = jf2 >= 0 ? topv_at(a, s, i, jf2) : -INFINITY;
      const int iu2 = s.topi[i][jf2 >= 0 ? jf2 : 0];
      const float best = fmaxf(warp_max(bm), vu2);
      int cd = IMAX;
#pragma unroll
      for (int e = 0; e < 2 * (MAXC / 32); ++e)
        if (vals[e] == best) cd = min(cd, nodes[e]);
      cd = warp_min(cd);
      const int cand = min(cd, vu2 == best ? iu2 : IMAX);
      if (lane == 0) s.t[i] = (best > -INFINITY && !s.committed[i] && s.cvalid[i]) ? cand : -1;
    }
    __syncthreads();
    // ---- commit the longest exact prefix ----
    if (warp == 0) {
      int fb = C;
      for (int j0 = 0; j0 < C; j0 += 32) {
        const int j = j0 + lane;
        const unsigned m = __ballot_sync(FULL, j < C && !s.committed[j] && s.t[j] != s.c[j]);
        if (m && fb == C) fb = j0 + __ffs(m) - 1;
      }
      if (lane == 0) s.firstbad = fb;
    }
    __syncthreads();
    for (int j = tid; j < C; j += NT) {
      const bool pre = !s.committed[j] && j < s.firstbad;
      s.prefix[j] = pre;
      s.pact[j] = pre && s.c[j] >= 0;
      if (s.pact[j]) atomicOr(a.pactbits + (s.c[j] >> 5), 1u << (s.c[j] & 31));
    }
    __syncthreads();
    for (int i = warp; i < C; i += NWARP) {  // stale list entries, then the commit
      for (int h = 0; h < KW; ++h) {
        const int k = lane + 32 * h;
        const unsigned hit = __ballot_sync(FULL, k < K && bit_of(a.pactbits, s.topi[i][k]));
        if (lane == 0) s.cleank[i][h] &= ~hit;
      }
      if (lane == 0 && s.prefix[i]) {
        s.out[i] = s.c[i];
        s.ord[i] = s.nrounds;
        s.committed[i] = 1;
      }
    }
    for (int j = tid; j < C; j += NT) {  // owners: the first committed picker of each node
      bool own = s.pact[j];
      for (int k = 0; own && k < j; ++k) own = !(s.pact[k] && s.c[k] == s.c[j]);
      s.owner[j] = own;
      s.isnew[j] = own && !s.hasslot[j];
    }
    __syncthreads();
    for (int j = tid; j < C; j += NT) {  // the dirty list: new slots, live usage
      if (!s.owner[j]) continue;
      const int cj = s.c[j];
      int rank = 0;
      for (int k = 0; k < j; ++k) rank += s.isnew[k];
      const int slot = s.isnew[j] ? s.nd + rank : s.sl[j];
      if (s.isnew[j]) s.dlist[slot] = cj;
      for (int r = 0; r < R; ++r) {
        int add = 0;
        for (int k = 0; k < C; ++k)
          if (s.pact[k] && s.c[k] == cj) add = ktt::wadd(add, s.creq[k][r]);
        s.dsu[slot][r] = ktt::wadd(s.isnew[j] ? __ldcg(a.used + (int64_t)cj * R + r) : s.dsu[slot][r], add);
      }
    }
    __syncthreads();
    for (int j = tid; j < C; j += NT) {  // clear the bitmaps for the next round
      const int cj = s.c[j];
      if (s.act[j]) atomicAnd(a.actbits + (cj >> 5), ~(1u << (cj & 31)));
      if (s.pact[j]) atomicAnd(a.pactbits + (cj >> 5), ~(1u << (cj & 31)));
    }
    if (tid == 0) {
      int n_new = 0;
      for (int k = 0; k < C; ++k) n_new += s.isnew[k];
      s.nd += n_new;
      s.nrounds += 1;
    }
    __syncthreads();
  }
  // ---- the chunk's usage update and its outputs ----
  for (int i = tid; i < C; i += NT) {
    const int o = s.out[i];
    if (o >= 0)
      for (int r = 0; r < R; ++r) atomicAdd(a.used + (int64_t)o * R + r, s.creq[i][r]);
    a.choices[c0 + i] = o;
    a.ordinals[c0 + i] = base + s.ord[i];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1) chunk_rounds_dense_kernel(DenseArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ ktt::TopkScratch tks;
  extern __shared__ __align__(16) unsigned char dsm[];
  DenseSmem& s = *reinterpret_cast<DenseSmem*>(dsm);
  const int tid = threadIdx.x;
  // every block reads the same word, written by an earlier launch: the
  // whole grid returns together, before any grid barrier
  if (a.done != nullptr && __ldcg(a.done)) return;
  const int64_t g0 = (int64_t)blockIdx.x * NT + tid, gs = (int64_t)gridDim.x * NT;
  for (int64_t i = g0; i < (int64_t)a.N * a.R; i += gs) a.used[i] = a.used_in[i];
  for (int64_t i = g0; i < a.W; i += gs) {
    a.actbits[i] = 0;
    a.pactbits[i] = 0;
  }
  if (tid == 0) s.status = 0;
  int base = 0;
  grid.sync();
  for (int c0 = 0; c0 < a.P; c0 += a.C) {
    hoist(a, c0);
    grid.sync();
    for (int i = blockIdx.x; i < a.C; i += gridDim.x) {
      const int nfin = ktt::block_topk(a.total0 + (int64_t)i * a.N, a.N, a.K, a.topv + (int64_t)i * a.K,
                                       a.topi + (int64_t)i * a.K, tks);
      if (tid == 0) a.nf[i] = nfin;
    }
    grid.sync();
    if (blockIdx.x == 0) {
      dense_chunk(a, s, c0, base);
      base += s.nrounds;
    }
    grid.sync();
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.scal[0] = base;
    a.scal[1] |= s.status;  // a cap hit in any launch over one pair survives
  }
}

}  // namespace

// ip / fp: the score parameters (score.cuh make_score_params), host memory
extern "C" int ktt_chunk_rounds_dense(const void* preq, const void* pvalid, const void* alloc,
                                      const void* used_in, const void* sfs, void* choices, void* used,
                                      void* ordinals, void* scal, void* total0, void* topv, void* topi,
                                      void* nf, void* bits, const void* done, const int* ip, const float* fp,
                                      int P, int N, int R, int C, int spec_iters, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  DenseArgs a;
  a.sp = ktt::make_score_params(ip, fp);
  const int K = C + 1 < N ? C + 1 : N;
  const int Z = MAXZ < K ? MAXZ : K;
  if (!ktt::score_params_ok(a.sp, R) || P <= 0 || N <= 0 || C < 1 || C > MAXC || P % C != 0 ||
      K > ktt::TOPK_MAX || spec_iters < 0)
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
  a.nf = static_cast<int32_t*>(nf);
  a.actbits = static_cast<uint32_t*>(bits);
  a.pactbits = static_cast<uint32_t*>(bits) + W;
  a.P = P;
  a.N = N;
  a.R = R;
  a.W = W;
  a.C = C;
  a.K = K;
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
