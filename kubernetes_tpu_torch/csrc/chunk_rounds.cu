// The chunk round loop (stage B of the class-wave route).
//
// Replaces the lax.scan(chunk, ...) of the JAX package's ops/assign.py
// :1093-1387 in inc mode, run by :1397-1413 (_stage_b, and the lax.cond
// that skips it when the wave committed every pod) or, with the waves off,
// by :1414-1417: per chunk of C pods, the per-pod top-K lists of the class
// rows (K = min(C + 1, N); both U1 <= C branches of :1110-1114 give the same
// lists), the while_loop of rounds (speculate against the chunk-dirty nodes
// and the lists with Z usable entries and SPEC_ITERS jump iterations;
// revalidate under intra-round exclusive int32 prefix sums; commit the
// longest exact prefix), then the chunk's usage update and the t0u column
// patch.  Pods the wave committed enter committed with their decisions.
// Also the t0u prologue (:992-997) when no wave ran, and the ordinals of
// :1422-1440 (wave blocks, then stage-B rounds numbered on from n_blocks).
//
// Design: one cooperative launch of the whole resident grid (one
// 1024-thread block an SM), no host synchronisation per chunk or round.
//   1. The chunk classes, in parallel: block 0 classifies every chunk
//      (warp w of a tile of 1024 chunks reads its 32 chunks' committed
//      flags coalesced, one ballot a chunk) and compacts the chunks that
//      need rounds -- some pod the wave did not commit; every chunk when no
//      wave ran -- in order into a device list with its count (ballots and
//      a prefix sum over the warps).  Meanwhile the other blocks copy the
//      usage and write the choices and ordinals of the chunks the wave
//      committed whole from its decisions, a warp a chunk.
//   2. One grid barrier; every block reads the count.  A count of 0 is the
//      JAX _skip branch: sweeps = n_blocks, and every block returns alike
//      (no barrier sits under a flag blocks could read differently).
//   3. Otherwise the grid copies t0u (or builds it: the prologue), and the
//      listed chunks are walked in list order: block b computes the top-K
//      list of pod b's class row (topk.cuh, exact order), grid.sync();
//      block 0 runs the round loop with the chunk in shared memory, one
//      warp per pod (C <= 32, lanes over the chunk's pods, dirty slots or
//      list entries), then the usage update (atomics: pods may share a
//      node) and the [U1, C] t0u patch, grid.sync() so the next chunk's
//      lists see the patched rows.  Rounds count only over listed chunks.
// Rows other blocks patch are read through L2 (__ldcg).  Inputs are never
// written; used and t0u are fresh buffers.
//
// Bounds on an H100: when the wave committed every pod, the committed
// flags, decisions and ordinals in, the usage copied and the decisions
// out (17 P + 8 N R bytes, ~1.7 MB or ~0.5 us at the north star); with
// the waves off (1600 chunks, 2635 rounds) ~17 MB, >= 5 us at 3.35 TB/s,
// where the chain of 1600 dependent chunk steps and their two grid
// barriers each is the practical floor.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"
#include "topk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;
constexpr int MAXC = 32;
constexpr int MAXK = 64;
constexpr int MAXZ = 32;
constexpr int IMAX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

struct ChunkArgs {
  const int32_t* preq;     // [P, R]
  const uint8_t* pvalid;   // [P]
  const int32_t* cls;      // [P]
  const int32_t* alloc;    // [N, R]
  const int32_t* req_u;    // [U1, R]
  const uint32_t* stat_u;  // [U1, W]
  const uint32_t* fit_u;   // [U1, W]
  const float* base_u;     // [U1, N]
  const int32_t* used_in;  // [N, R]: the wave's usage, or the cycle start's
  const float* t0u_in;     // [U1, N]: the wave's class rows, or NULL (prologue)
  const uint8_t* wcom;     // [P] or NULL (no wave)
  const int32_t* wout;     // [P] or NULL
  const int32_t* wordn;    // [P] or NULL
  const int32_t* wscal;    // [2] the wave's n_blocks, epochs, or NULL
  int32_t* choices;        // [P] out
  int32_t* used;           // [N, R] out
  float* t0u;              // [U1, N] out (work rows)
  int32_t* ordinals;       // [P] out
  int32_t* scal;           // [2] out: sweeps, status (1: round cap hit)
  float* topv;             // [C, K] scratch
  int32_t* topi;           // [C, K] scratch
  int32_t* clist;          // [P / C + 1] scratch: the chunks that need rounds, then their count
  ktt::ScoreParams sp;
  int P, N, R, U1, W, C, K, Z, spec_iters;
};

struct ChunkSmem {
  int creq[MAXC][ktt::SCORE_MAX_R];
  int ccls[MAXC];
  int cvalid[MAXC];
  int wcom0[MAXC];
  int committed[MAXC];
  int out[MAXC];
  int ord[MAXC];
  unsigned long long cleank[MAXC];
  float topv[MAXC][MAXK];
  int topi[MAXC][MAXK];
  int dlist[MAXC];
  int dsu[MAXC][ktt::SCORE_MAX_R];
  float M2[MAXC][MAXC];
  int c[MAXC];
  int t[MAXC];
  int upos[MAXC][MAXZ];
  int nodesz[MAXC][MAXZ];
  int nus[MAXC];
  int ptr[MAXC];
  int okr[MAXC];
  int claim[MAXC];
  int head[MAXC];
  int act[MAXC];
  int hasslot[MAXC];
  int sl[MAXC];
  int cu[MAXC][ktt::SCORE_MAX_R];
  int pact[MAXC];
  int prefix[MAXC];
  int newly[MAXC];
  int nd, nrounds, done, status;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ bool t0u_feasible(const ChunkArgs& a, int u, int n) {
  return __ldcg(a.t0u + (int64_t)u * a.N + n) > -INFINITY;
}

// one chunk's round loop, usage update and t0u patch; block 0 only
__device__ void chunk_step(const ChunkArgs& a, ChunkSmem& s, int c0, int base, int nblk) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, K = a.K, Z = a.Z, R = a.R, N = a.N;
  const ktt::ScoreParams& sp = a.sp;
  const unsigned long long kmask = K == 64 ? ~0ull : ((1ull << K) - 1);
  if (tid < C) {
    const int i = tid, p = c0 + i;
    s.ccls[i] = a.cls[p];
    s.cvalid[i] = a.pvalid[p];
    for (int r = 0; r < R; ++r) s.creq[i][r] = a.preq[(int64_t)p * R + r];
    const int wc = a.wcom ? a.wcom[p] : 0;
    s.wcom0[i] = wc;
    s.committed[i] = wc;
    s.out[i] = a.wout ? a.wout[p] : -1;
    s.ord[i] = 0;
    s.cleank[i] = kmask;
    s.dlist[i] = -1;
    for (int r = 0; r < R; ++r) s.dsu[i][r] = 0;
  }
  if (tid == 0) {
    s.nd = 0;
    s.nrounds = 0;
  }
  __syncthreads();
  for (int idx = tid; idx < C * K; idx += NT) {
    const int i = idx / K, k = idx % K;
    s.topv[i][k] = s.cvalid[i] ? __ldcg(a.topv + idx) : -INFINITY;
    s.topi[i][k] = __ldcg(a.topi + idx);
  }
  const int i = warp;  // the pod this warp speaks for
  while (true) {
    __syncthreads();
    if (warp == 0) {
      const unsigned m = __ballot_sync(FULL, lane < C && !s.committed[lane]);
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
    if (i < C) {
      const int* rqi = s.creq[i];
      if (lane < C) {  // M2[i][d]: dirty slot d rescored
        const int dl = s.dlist[lane], dn = max(dl, 0);
        float m2 = -INFINITY;
        if (dl >= 0 && t0u_feasible(a, s.ccls[i], dn)) {
          const int* du = s.dsu[lane];
          const int32_t* ar = a.alloc + (int64_t)dn * R;
          auto al = [&](int r) { return ar[r]; };
          if (ktt::fit_ok(R, [&](int r) { return rqi[r]; }, [&](int r) { return du[r]; }, al))
            m2 = ktt::score_flat(sp, [&](int r) { return ktt::wadd(du[r], rqi[r]); }, al);
        }
        s.M2[i][lane] = m2;
      }
      // the first Z usable list positions, then the unusable ones (the
      // order lax.top_k gives the keys K - k / 0)
      const int k0 = lane, k1 = lane + 32;
      const bool us0 = k0 < K && ((s.cleank[i] >> k0) & 1ull) && s.topv[i][k0] > -INFINITY;
      const bool us1 = k1 < K && ((s.cleank[i] >> k1) & 1ull) && s.topv[i][k1] > -INFINITY;
      const unsigned long long U =
          (unsigned long long)__ballot_sync(FULL, us0) | ((unsigned long long)__ballot_sync(FULL, us1) << 32);
      const unsigned long long NU = ~U & kmask;
      const int nus = __popcll(U);
      for (int k = lane; k < K; k += 32) {
        const unsigned long long below = (1ull << k) - 1;
        const int slot = ((U >> k) & 1ull) ? __popcll(U & below) : nus + __popcll(NU & below);
        if (slot < Z) s.upos[i][slot] = k;
      }
      __syncwarp();
      if (lane == 0) {
        s.nus[i] = nus;
        s.head[i] = s.topi[i][s.upos[i][0]];
      }
    }
    __syncthreads();
    if (i < C) {
      const bool pr = lane < i && s.head[lane] == s.head[i] && s.nus[lane] > 0 && !s.committed[lane];
      const int cnt = __popc(__ballot_sync(FULL, pr));
      if (lane < Z) s.nodesz[i][lane] = s.topi[i][s.upos[i][lane]];
      if (lane == 0) {
        const int ptr = min(cnt, Z - 1);
        s.ptr[i] = ptr;
        s.okr[i] = ptr < s.nus[i] && !s.committed[i];
      }
    }
    __syncthreads();
    for (int it = 0; it < a.spec_iters; ++it) {
      if (i < C && lane == 0) s.claim[i] = s.okr[i] ? s.nodesz[i][s.ptr[i]] : -1;
      __syncthreads();
      if (i < C) {
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
    if (i < C) {
      const int sel = s.upos[i][s.ptr[i]];
      const float vu = s.okr[i] ? s.topv[i][sel] : -INFINITY;
      const int iu = s.topi[i][sel];
      const float v = lane < C ? s.M2[i][lane] : -INFINITY;
      const int nv = lane < C ? max(s.dlist[lane], 0) : IMAX;
      const float best = fmaxf(warp_max(v), vu);
      const int cd = warp_min(v == best ? nv : IMAX);
      const int cand = min(cd, vu == best ? iu : IMAX);
      if (lane == 0) s.c[i] = (best > -INFINITY && !s.committed[i] && s.cvalid[i]) ? cand : -1;
    }
    __syncthreads();
    // ---- pass 2: revalidate under intra-round prefix commits ----
    if (i < C) {  // per pod j = i: its dirty slot and round-start usage
      const int cj = s.c[i];
      const unsigned m = __ballot_sync(FULL, lane < C && s.dlist[lane] >= 0 && s.dlist[lane] == cj);
      const int cn = max(cj, 0);
      for (int r = lane; r < R; r += 32)
        s.cu[i][r] = m ? s.dsu[__ffs(m) - 1][r] : __ldcg(a.used + (int64_t)cn * R + r);
      if (lane == 0) {
        s.act[i] = !s.committed[i] && cj >= 0;
        s.hasslot[i] = m != 0;
        s.sl[i] = m ? __ffs(m) - 1 : 0;
      }
    }
    __syncthreads();
    if (i < C) {
      const int* rqi = s.creq[i];
      float mij = -INFINITY, m2x = -INFINITY;
      int nj = IMAX, nd2 = IMAX;
      if (lane < C) {
        // Mij: pod i at node c_j under the usage of earlier pods' picks
        const int j = lane, cj = s.c[j], cnj = max(cj, 0);
        nj = cnj;
        if (s.act[j] && j < i && t0u_feasible(a, s.ccls[i], cnj)) {
          unsigned same = 0;  // pods k < i with act[k] that picked c_j
          for (int k = 0; k < i; ++k)
            if (s.act[k] && s.c[k] == cj) same |= 1u << k;
          auto uij = [&](int r) {
            int v = s.cu[j][r];
            for (unsigned mm = same; mm; mm &= mm - 1) v = ktt::wadd(v, s.creq[__ffs(mm) - 1][r]);
            return v;
          };
          const int32_t* ar = a.alloc + (int64_t)cnj * R;
          auto al = [&](int r) { return ar[r]; };
          if (ktt::fit_ok(R, [&](int r) { return rqi[r]; }, uij, al))
            mij = ktt::score_flat(sp, [&](int r) { return ktt::wadd(uij(r), rqi[r]); }, al);
        }
        // M2x: dirty slots picked intra-round by an earlier pod are superseded
        const int d = lane, dl = s.dlist[d];
        nd2 = max(dl, 0);
        bool ex = false;
        if (dl >= 0)
          for (int k = 0; k < i; ++k) ex |= s.act[k] && s.c[k] == dl;
        m2x = ex ? -INFINITY : s.M2[i][d];
      }
      // the first clean list entry not picked by an earlier pod this round
      bool cl0 = false, cl1 = false;
      for (int h = 0; h < 2; ++h) {
        const int k = lane + 32 * h;
        bool cl = false;
        if (k < K && ((s.cleank[i] >> k) & 1ull)) {
          const int node = s.topi[i][k];
          bool chosen = false;
          for (int j = 0; j < i; ++j) chosen |= s.act[j] && node == s.c[j];
          cl = !chosen;
        }
        if (h == 0) cl0 = cl; else cl1 = cl;
      }
      const unsigned long long CK =
          (unsigned long long)__ballot_sync(FULL, cl0) | ((unsigned long long)__ballot_sync(FULL, cl1) << 32);
      const int jf2 = CK ? __ffsll((long long)CK) - 1 : 0;
      const float vu2 = CK ? s.topv[i][jf2] : -INFINITY;
      const int iu2 = s.topi[i][jf2];
      const float best = fmaxf(warp_max(fmaxf(m2x, mij)), vu2);
      const int cd = warp_min(min(m2x == best ? nd2 : IMAX, mij == best ? nj : IMAX));
      const int cand = min(cd, vu2 == best ? iu2 : IMAX);
      if (lane == 0) s.t[i] = (best > -INFINITY && !s.committed[i] && s.cvalid[i]) ? cand : -1;
    }
    __syncthreads();
    // ---- commit the longest exact prefix ----
    if (warp == 0) {
      const bool bad = lane < C && !s.committed[lane] && s.t[lane] != s.c[lane];
      const unsigned m = __ballot_sync(FULL, bad);
      const int firstbad = m ? __ffs(m) - 1 : C;
      if (lane < C) {
        const bool pre = !s.committed[lane] && lane < firstbad;
        s.prefix[lane] = pre;
        s.pact[lane] = pre && s.c[lane] >= 0;
      }
    }
    __syncthreads();
    if (i < C) {  // stale list entries: nodes the committed prefix picked
      unsigned long long hit = 0;
      for (int h = 0; h < 2; ++h) {
        const int k = lane + 32 * h;
        bool hk = false;
        if (k < K) {
          const int node = s.topi[i][k];
          for (int j = 0; j < C; ++j) hk |= s.pact[j] && node == s.c[j];
        }
        hit |= (unsigned long long)__ballot_sync(FULL, hk) << (32 * h);
      }
      if (lane == 0) {
        s.cleank[i] &= ~hit;
        if (s.prefix[i]) {
          s.out[i] = s.c[i];
          s.ord[i] = s.nrounds;
          s.committed[i] = 1;
        }
      }
    }
    if (warp == 0) {  // the dirty list: new slots for first choosers of new nodes
      const int j = lane;
      bool own = false;
      int cj = -1;
      if (j < C && s.pact[j]) {
        cj = s.c[j];
        int minpos = C;
        for (int k = 0; k < C; ++k)
          if (s.pact[k] && s.c[k] == cj && k < minpos) minpos = k;
        own = minpos == j;
      }
      const bool isnew = own && !s.hasslot[j < C ? j : 0];
      const unsigned m = __ballot_sync(FULL, isnew);
      const int rk = __popc(m & ((1u << lane) - 1));
      if (own) {
        const int slot = isnew ? s.nd + rk : s.sl[j];
        if (isnew) s.dlist[slot] = cj;
        for (int r = 0; r < R; ++r) {
          int add = 0;
          for (int k = 0; k < C; ++k)
            if (s.pact[k] && s.c[k] == cj) add = ktt::wadd(add, s.creq[k][r]);
          s.dsu[slot][r] = ktt::wadd(isnew ? __ldcg(a.used + (int64_t)cj * R + r) : s.dsu[slot][r], add);
        }
      }
      __syncwarp();
      if (lane == 0) {
        s.nd += __popc(m);
        s.nrounds += 1;
      }
    }
  }
  // ---- the chunk's usage update, then the t0u column patch ----
  if (tid < C) {
    const bool nw = s.out[tid] >= 0 && !s.wcom0[tid];
    s.newly[tid] = nw;
    if (nw)
      for (int r = 0; r < R; ++r) atomicAdd(a.used + (int64_t)s.out[tid] * R + r, s.creq[tid][r]);
  }
  __syncthreads();
  for (int idx = tid; idx < a.U1 * C; idx += NT) {
    const int u = idx / C, j = idx % C;
    if (!s.newly[j]) continue;
    const int col = s.out[j];
    const int32_t* ur = a.used + (int64_t)col * R;
    const int32_t* ar = a.alloc + (int64_t)col * R;
    const int32_t* rq = a.req_u + (int64_t)u * R;
    auto us = [&](int r) { return __ldcg(ur + r); };
    auto al = [&](int r) { return ar[r]; };
    float v = -INFINITY;
    if (ktt::bit_at(a.stat_u, u, a.W, col) && ktt::fit_ok(R, [&](int r) { return rq[r]; }, us, al))
      v = ktt::score_flat(sp, [&](int r) { return ktt::wadd(us(r), rq[r]); }, al);
    a.t0u[(int64_t)u * N + col] = v;  // duplicate columns write equal values
  }
  if (tid < C) {
    const int p = c0 + tid;
    a.choices[p] = s.out[tid];
    a.ordinals[p] = s.wcom0[tid] ? a.wordn[p] : base + s.ord[tid] + nblk;
  }
  __syncthreads();
}

// block 0: the chunks that need rounds, in order, into clist, their count
// at clist[P / C]; a tile of NT chunks at a time, warp w holding 32 of them
__device__ void list_chunks(const ChunkArgs& a, int* woff) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = a.C, nch = a.P / a.C;
  int total = 0;
  for (int t0 = 0; t0 < nch; t0 += NT) {
    const int cw = t0 + 32 * warp;
    unsigned need = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int ci = cw + j;
      const bool open = ci < nch && lane < C && !(a.wcom && a.wcom[(int64_t)ci * C + lane]);
      need |= (__ballot_sync(FULL, open) ? 1u : 0u) << j;
    }
    if (lane == 0) woff[warp] = __popc(need);
    __syncthreads();
    if (warp == 0) {  // exclusive prefix of the warps' counts; the tile's total last
      const int v = woff[lane];
      int incl = v;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += y;
      }
      woff[lane] = incl - v;
      if (lane == 31) woff[32] = incl;
    }
    __syncthreads();
    if ((need >> lane) & 1u) a.clist[total + woff[warp] + __popc(need & ((1u << lane) - 1u))] = cw + lane;
    total += woff[32];
    __syncthreads();  // woff is rewritten by the next tile
  }
  if (tid == 0) a.clist[nch] = total;
}

__global__ void __launch_bounds__(NT, 1) chunk_rounds_kernel(ChunkArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ ktt::TopkScratch tks;
  __shared__ ChunkSmem s;
  __shared__ int woff[33];
  const int tid = threadIdx.x, lane = tid & 31;
  const int N = a.N, R = a.R, U1 = a.U1, W = a.W, C = a.C, K = a.K, G = gridDim.x;
  const int nch = a.P / C;
  const int64_t g0 = (int64_t)blockIdx.x * NT + tid, gs = (int64_t)G * NT;
  const int nblk = a.wscal ? a.wscal[0] : 0;
  // ---- 1. the chunk classes; the usage copy and the wave's whole chunks ----
  for (int64_t i = g0; i < (int64_t)N * R; i += gs) a.used[i] = a.used_in[i];
  if (blockIdx.x == 0) list_chunks(a, woff);
  if (a.wcom && (G == 1 || blockIdx.x > 0)) {
    const int b = G == 1 ? 0 : blockIdx.x - 1, nb = G == 1 ? 1 : G - 1;
    for (int ci = b * (NT / 32) + (tid >> 5); ci < nch; ci += nb * (NT / 32)) {
      const int64_t p = (int64_t)ci * C + lane;
      if (__all_sync(FULL, lane >= C || a.wcom[p]) && lane < C) {
        a.choices[p] = a.wout[p];
        a.ordinals[p] = a.wordn[p];
      }
    }
  }
  grid.sync();
  // ---- 2. the skip: the wave committed every pod ----
  const int nlist = __ldcg(a.clist + nch);
  if (nlist == 0) {
    if (blockIdx.x == 0 && tid == 0) {
      a.scal[0] = nblk;
      a.scal[1] = 0;
    }
    return;
  }
  // ---- 3. the listed chunks' rounds, from the wave's class rows ----
  for (int64_t i = g0; i < (int64_t)U1 * N; i += gs) {
    if (a.t0u_in) {
      a.t0u[i] = a.t0u_in[i];
    } else {
      const int u = (int)(i / N), n = (int)(i % N);
      const int64_t w = (int64_t)u * W + (n >> 5);
      const bool bit = ((a.stat_u[w] & a.fit_u[w]) >> (n & 31)) & 1u;
      a.t0u[i] = bit ? a.base_u[i] : -INFINITY;
    }
  }
  if (tid == 0) s.status = 0;
  int base = 0;
  grid.sync();
  for (int j = 0; j < nlist; ++j) {
    const int c0 = __ldcg(a.clist + j) * C;
    for (int i = blockIdx.x; i < C; i += G) {
      const int u = a.cls[c0 + i];
      ktt::block_topk(a.t0u + (int64_t)u * N, N, K, a.topv + (int64_t)i * K, a.topi + (int64_t)i * K, tks);
    }
    grid.sync();
    if (blockIdx.x == 0) {
      chunk_step(a, s, c0, base, nblk);
      base += s.nrounds;
    }
    grid.sync();
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.scal[0] = base + nblk;
    a.scal[1] = s.status;
  }
}

}  // namespace

// ip / fp: the score parameters (score.cuh make_score_params), host memory
extern "C" int ktt_chunk_rounds(const void* preq, const void* pvalid, const void* cls,
                                const void* alloc, const void* req_u, const void* stat_u,
                                const void* fit_u, const void* base_u, const void* used_in,
                                const void* t0u_in, const void* wcom, const void* wout,
                                const void* wordn, const void* wscal, void* choices, void* used,
                                void* t0u, void* ordinals, void* scal, void* topv, void* topi,
                                void* clist, const int* ip, const float* fp, int P, int N, int R, int U1,
                                int C, int spec_iters, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  ChunkArgs a;
  a.sp = ktt::make_score_params(ip, fp);
  const int K = C + 1 < N ? C + 1 : N;
  const int Z = 16 < K ? 16 : K;
  if (!ktt::score_params_ok(a.sp, R) || P <= 0 || N <= 0 || U1 <= 0 || C < 1 || C > MAXC ||
      P % C != 0 || K > MAXK || spec_iters < 0)
    return (int)cudaErrorInvalidValue;
  a.preq = static_cast<const int32_t*>(preq);
  a.pvalid = static_cast<const uint8_t*>(pvalid);
  a.cls = static_cast<const int32_t*>(cls);
  a.alloc = static_cast<const int32_t*>(alloc);
  a.req_u = static_cast<const int32_t*>(req_u);
  a.stat_u = static_cast<const uint32_t*>(stat_u);
  a.fit_u = static_cast<const uint32_t*>(fit_u);
  a.base_u = static_cast<const float*>(base_u);
  a.used_in = static_cast<const int32_t*>(used_in);
  a.t0u_in = static_cast<const float*>(t0u_in);
  a.wcom = static_cast<const uint8_t*>(wcom);
  a.wout = static_cast<const int32_t*>(wout);
  a.wordn = static_cast<const int32_t*>(wordn);
  a.wscal = static_cast<const int32_t*>(wscal);
  a.choices = static_cast<int32_t*>(choices);
  a.used = static_cast<int32_t*>(used);
  a.t0u = static_cast<float*>(t0u);
  a.ordinals = static_cast<int32_t*>(ordinals);
  a.scal = static_cast<int32_t*>(scal);
  a.topv = static_cast<float*>(topv);
  a.topi = static_cast<int32_t*>(topi);
  a.clist = static_cast<int32_t*>(clist);
  a.P = P;
  a.N = N;
  a.R = R;
  a.U1 = U1;
  a.W = (N + 31) / 32;
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chunk_rounds_kernel, NT, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = nsm * per_sm;  // the whole resident grid: the classes, copies and t0u
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)chunk_rounds_kernel, dim3(grid), dim3(NT), args, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
