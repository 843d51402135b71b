// Class-batched commit waves (stage A of the class-wave route).
//
// Replaces the JAX package's ops/assign.py:530-867 _wave_commit_stage (the
// whole lax.while_loop) plus the t0u prologue of :992-997,
//   t0u = where(unpack(stat_u & fit_u), base_u, -inf),
// with one launch and no host synchronisation: the block loop runs on the
// card.  The algorithm and why each certified commit is exact are in the
// JAX function's docstring; this file follows it step by step (A)..(H), with
// the same tie orders: top-k keeps equal values in ascending node order,
// argmax is the first maximum, lexmax is (max value, min node).
//
// Design: a cooperative persistent grid (cudaLaunchCooperativeKernel), one
// 1024-thread block per SM, at most one block per class row.
//   - (A) epoch refresh, the only N-wide work done often: every block takes
//     class rows (row u on block u % G) and runs the exact top-KW selection
//     of topk.cuh over its row of t0u; grid.sync() before and after.  One
//     block alone would walk U1 x N = 2.1 M entries per refresh.
//   - (B)..(H), one block of E pods: block 0 alone, between grid syncs.  Its
//     per-pod work is [E, KW] (pointer walk, bit masks of the candidate
//     lists in shared memory, a warp per pod row), [U1, E] (the s2 columns)
//     and one N-wide rescore for the fallback pod (1024 threads, a
//     shuffle-tree argmax).  cm, the earliest block pod per node, is an
//     N-int array in shared memory kept at INT_MAX between uses; claimed is
//     the packed [ceil(N/32)] word register of the epoch.
//   - the other blocks wait at the grid barrier while block 0 works; the
//     loop's control (frontier, block count, refresh flag) goes through
//     global memory and every block reads it after each barrier, so all
//     blocks take the same branches and barriers.  It is double-buffered by
//     the parity of the loop step: block 0 writes the next step's slot, so a
//     block still reading this step's slot never sees it change.
// Arrays other blocks write (t0u, the lists) are read through L2 (__ldcg):
// L1 is not coherent across SMs.  The inputs are never written: used and
// t0u are fresh buffers (the donation-aliasing rule).
//
// Bounds on an H100 (north star: P = 51200, N = 20480, R = 5, U1 = 101,
// 1319 blocks, 86 refreshes): the bytes are the inputs read once and the
// outputs written once, ~17 MB, >= 5 us at 3.35 TB/s; the operations are
// dominated by the refreshes' selection (8 radix passes over U1 x N keys per
// refresh) and the fallback rescores, priced by chip_smoke.py from this
// run's counts.  The block loop is a chain of dependent steps, so the
// barrier latency per block is the practical floor.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "score.cuh"
#include "topk.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 1024;
constexpr int MAX_E = 64;
constexpr int IMAX = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

struct WaveArgs {
  const int32_t* cls;       // [P]
  const uint8_t* pvalid;    // [P]
  const int32_t* preq;      // [P, R]
  const int32_t* used_in;   // [N, R]
  const uint32_t* stat_u;   // [U1, W]
  const uint32_t* fit_u;    // [U1, W]
  const float* base_u;      // [U1, N]
  const int32_t* alloc;     // [N, R]
  const int32_t* req_u;     // [U1, R]
  uint8_t* committed;       // [P] out
  int32_t* out;             // [P] out
  int32_t* ordn;            // [P] out
  int32_t* used;            // [N, R] out
  float* t0u;               // [U1, N] out
  float* tv;                // [U1, KW] scratch: the epoch's lists
  int32_t* ti;              // [U1, KW]
  int32_t* nf;              // [U1]
  float* s2;                // [U1, E]
  float* bmax;              // [U1]
  int32_t* bnode;           // [U1]
  int32_t* ctrl;            // [2, 4]: frontier, blocks, refresh flag (by step parity)
  int32_t* scal;            // [2] out: n_blocks, epochs
  ktt::ScoreParams sp;
  int P, N, R, U1, W, E, KW, iters, max_blocks;
};

#ifdef KTT_WAVE_PHASES
// A build with -DKTT_WAVE_PHASES (kubernetes_tpu_torch/bench/wave_phases.py)
// makes thread 0 of block 0 add the SM cycles between the loop's phase
// boundaries into g_phase_cycles, and count each boundary it passes in
// g_phase_hits.  Each boundary follows a block or grid barrier, so a phase's
// cycles are block 0's whole time in it.
enum { PH_PROLOGUE, PH_REFRESH, PH_WALK, PH_S2, PH_CERTIFY, PH_FALLBACK, PH_ABSORB, PH_BARRIER, PH_N };
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

__device__ __forceinline__ int nth_set_bit(uint32_t m, int n) {
  for (; n > 0; --n) m &= m - 1;
  return __ffs(m) - 1;
}

__device__ __forceinline__ bool lexbetter(float v, int n, float cv, int cn) {
  return v > cv || (v == cv && n < cn);
}

__global__ void __launch_bounds__(NT, 1) wave_commit_kernel(WaveArgs a) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ ktt::TopkScratch tks;
  __shared__ int s_q, s_tfb, s_stacked;
  __shared__ float s_bv[NT / 32];
  __shared__ int s_bn[NT / 32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int P = a.P, N = a.N, R = a.R, U1 = a.U1, W = a.W, E = a.E, KW = a.KW;
  const int KWW = (KW + 31) / 32;
  int* cm = reinterpret_cast<int*>(smem);                  // [N]
  uint32_t* claimed = reinterpret_cast<uint32_t*>(cm + N);  // [W]
  int* tib = reinterpret_cast<int*>(claimed + W);           // [E, KW]
  uint32_t* availw = reinterpret_cast<uint32_t*>(tib + E * KW);  // [E, KWW]
  int* bcls = reinterpret_cast<int*>(availw + E * KWW);     // [E]
  int* breq = bcls + E;                                     // [E, R]
  int* live = breq + E * R;
  int* active = live + E;
  int* rank = active + E;
  int* pos = rank + E;
  int* nd = pos + E;
  float* a_val = reinterpret_cast<float*>(nd + E);
  int* picked = reinterpret_cast<int*>(a_val + E);
  int* own_ok = picked + E;
  int* prefix_ok = own_ok + E;
  int* s2n = prefix_ok + E;
  int* cpick = s2n + E;
  int* place = cpick + E;
  const ktt::ScoreParams& sp = a.sp;
#ifdef KTT_WAVE_PHASES
  long long ph_t = clock64();
#endif

  // ---- prologue: fresh state, t0u from the class planes ----
  const int64_t g0 = (int64_t)blockIdx.x * NT + tid, gs = (int64_t)gridDim.x * NT;
  for (int64_t i = g0; i < (int64_t)N * R; i += gs) a.used[i] = a.used_in[i];
  for (int64_t i = g0; i < (int64_t)U1 * N; i += gs) {
    const int u = (int)(i / N), n = (int)(i % N);
    const int64_t w = (int64_t)u * W + (n >> 5);
    const bool bit = ((a.stat_u[w] & a.fit_u[w]) >> (n & 31)) & 1u;
    a.t0u[i] = bit ? a.base_u[i] : -INFINITY;
  }
  for (int64_t i = g0; i < P; i += gs) {
    a.committed[i] = 0;
    a.out[i] = -1;
    a.ordn[i] = 0;
  }
  if (blockIdx.x == 0) {
    for (int n = tid; n < N; n += NT) cm[n] = IMAX;
    if (tid == 0) {
      a.ctrl[0] = 0;  // frontier f
      a.ctrl[1] = 0;  // blocks
      a.ctrl[2] = 1;  // refresh before the next block
    }
  }
  int epochs = 0, blocks = 0;
  grid.sync();
  KTT_PHASE(PH_PROLOGUE);

  for (int step = 0;; ++step) {
    const int32_t* cur = a.ctrl + 4 * (step & 1);
    const int f = __ldcg(cur + 0);
    blocks = __ldcg(cur + 1);
    const int need_ep = __ldcg(cur + 2);
    if (!(f < P && blocks < a.max_blocks)) break;
    // ---- (A) epoch refresh: per-class top-KW lists from the patched t0u ----
    if (need_ep) {
      for (int u = blockIdx.x; u < U1; u += gridDim.x) {
        const int cnt = ktt::block_topk(a.t0u + (int64_t)u * N, N, KW, a.tv + (int64_t)u * KW,
                                        a.ti + (int64_t)u * KW, tks);
        if (tid == 0) a.nf[u] = cnt;
      }
      grid.sync();
      KTT_PHASE(PH_REFRESH);
      if (blockIdx.x == 0) {
        for (int w = tid; w < W; w += NT) claimed[w] = 0u;
        for (int u = tid; u < U1; u += NT) {
          a.bmax[u] = -INFINITY;
          a.bnode[u] = IMAX;
        }
      }
    }
    if (blockIdx.x == 0) {
      // ---- (B) the block: E pods at the frontier, clamped at the tail ----
      const int start = min(f, P - E);
      if (tid < E) {
        const int p = start + tid;
        bcls[tid] = a.cls[p];
        const int act = __ldcg(a.committed + p) ? 0 : 1;
        active[tid] = act;
        live[tid] = act && a.pvalid[p];
        for (int r = 0; r < R; ++r) breq[tid * R + r] = a.preq[(int64_t)p * R + r];
      }
      if (tid == 0) s_q = E;
      __syncthreads();
      // ---- (C) pointer walk ----
      if (tid < E) {
        int rk = 0;
        for (int j = 0; j < tid; ++j) rk += (bcls[j] == bcls[tid] && live[j]) ? 1 : 0;
        rank[tid] = rk;
      }
      for (int i = warp; i < E; i += NT / 32) {
        const int c = bcls[i];
        const bool lv = live[i];
        for (int wd = 0; wd < KWW; ++wd) {
          const int k = wd * 32 + lane;
          bool av = false;
          if (k < KW) {
            const int node = __ldcg(a.ti + (int64_t)c * KW + k);
            tib[i * KW + k] = node;
            av = lv && __ldcg(a.tv + (int64_t)c * KW + k) > -INFINITY &&
                 !((claimed[node >> 5] >> (node & 31)) & 1u);
          }
          const uint32_t m = __ballot_sync(FULL, av);
          if (lane == 0) availw[i * KWW + wd] = m;
        }
      }
      __syncthreads();
      if (tid < E) {  // the (rank + 1)-th usable entry
        int need = rank[tid] + 1, p = KW;
        for (int wd = 0; wd < KWW; ++wd) {
          const uint32_t m = availw[tid * KWW + wd];
          const int c = __popc(m);
          if (need <= c) {
            p = wd * 32 + nth_set_bit(m, need - 1);
            break;
          }
          need -= c;
        }
        pos[tid] = p;
      }
      __syncthreads();
      for (int it = 0; it <= a.iters; ++it) {
        // claims(pos): nd[i] (N: no pick), cm[n] = earliest pod at n
        if (tid < E) nd[tid] = pos[tid] < KW ? tib[tid * KW + pos[tid]] : N;
        __syncthreads();
        if (tid < E && nd[tid] < N) atomicMin(&cm[nd[tid]], tid);
        __syncthreads();
        if (it == a.iters) break;  // the final claims stay for the checks
        // jump to the first usable entry no earlier pod points at
        for (int i = warp; i < E; i += NT / 32) {
          int np = KW;
          for (int wd = 0; wd < KWW && np == KW; ++wd) {
            const int k = wd * 32 + lane;
            bool el = false;
            if (k < KW) el = ((availw[i * KWW + wd] >> lane) & 1u) && !(cm[tib[i * KW + k]] < i);
            const uint32_t m = __ballot_sync(FULL, el);
            if (m) np = wd * 32 + __ffs(m) - 1;
          }
          if (lane == 0) pos[i] = np;
        }
        __syncthreads();
        if (tid < E && nd[tid] < N) cm[nd[tid]] = IMAX;
        __syncthreads();
      }
      // exact settlement check
      for (int i = warp; i < E; i += NT / 32) {
        const int p = pos[i];
        bool bad = false;
        for (int wd = 0; wd < KWW; ++wd) {
          const int k = wd * 32 + lane;
          bool b = false;
          if (k < KW && k < p) b = ((availw[i * KWW + wd] >> lane) & 1u) && !(cm[tib[i * KW + k]] < i);
          if (__any_sync(FULL, b)) bad = true;
        }
        if (lane == 0) {
          const int n = nd[i];
          const bool pk = live[i] && p < KW;
          prefix_ok[i] = !bad;
          own_ok[i] = n < N && cm[n] == i;
          picked[i] = pk;
          a_val[i] = p < KW ? __ldcg(a.tv + (int64_t)bcls[i] * KW + p) : -INFINITY;
          s2n[i] = pk ? n : IMAX;
        }
      }
      __syncthreads();
      KTT_PHASE(PH_WALK);
      // ---- (D) post-placement snapshot columns s2[U1, E] ----
      for (int idx = tid; idx < U1 * E; idx += NT) {
        const int u = idx / E, i = idx % E;
        float v = -INFINITY;
        if (picked[i]) {
          const int n = nd[i];
          if (ktt::bit_at(a.stat_u, u, W, n)) {
            const int32_t* ur = a.used + (int64_t)n * R;
            const int32_t* ar = a.alloc + (int64_t)n * R;
            const int32_t* rq = a.req_u + (int64_t)u * R;
            const int* bq = breq + i * R;
            auto nu = [&](int r) { return ktt::wadd(__ldcg(ur + r), bq[r]); };
            auto al = [&](int r) { return ar[r]; };
            if (ktt::fit_ok(R, [&](int r) { return rq[r]; }, nu, al))
              v = ktt::score_flat(sp, [&](int r) { return ktt::wadd(nu(r), rq[r]); }, al);
          }
        }
        a.s2[(int64_t)u * E + i] = v;
      }
      __syncthreads();
      KTT_PHASE(PH_S2);
      // ---- (E) exclusive lexicographic scan + (F) certification ----
      if (tid < E) {
        const int i = tid, c = bcls[i];
        float cv = __ldcg(a.bmax + c);
        int cn = __ldcg(a.bnode + c);
        for (int j = 0; j < i; ++j) {
          const float bv = a.s2[(int64_t)c * E + j];
          if (lexbetter(bv, s2n[j], cv, cn)) {
            cv = bv;
            cn = s2n[j];
          }
        }
        const bool covered = KW < N ? __ldcg(a.nf + c) < KW : true;
        const float av = a_val[i];
        const bool cp = picked[i] && own_ok[i] && prefix_ok[i] && lexbetter(av, nd[i], cv, cn);
        const bool cneg = live[i] && pos[i] >= KW && prefix_ok[i] && covered && cv == -INFINITY;
        cpick[i] = cp;
        if (active[i] && !(!live[i] || cp || cneg)) atomicMin(&s_q, i);
      }
      __syncthreads();
      const int q = s_q;
      // commit the certified prefix; placed nodes are distinct (own_ok)
      if (tid < E) {
        const int i = tid;
        const bool cb = active[i] && i < q;
        const bool pl = cb && cpick[i];
        place[i] = pl;
        if (cb) {
          const int p = start + i;
          a.out[p] = pl ? nd[i] : -1;
          a.committed[p] = 1;
          a.ordn[p] = blocks;
        }
        if (pl) {
          int32_t* ur = a.used + (int64_t)nd[i] * R;
          for (int r = 0; r < R; ++r) ur[r] = ktt::wadd(__ldcg(ur + r), breq[i * R + r]);
        }
      }
      __syncthreads();
      KTT_PHASE(PH_CERTIFY);
      // ---- (G) fallback: one exact N-wide rescore of the first uncertified pod ----
      const bool do_fb = q < E;
      int t_fb = -1;
      if (do_fb) {
        const int fcls = bcls[q];
        const int* fq = breq + q * R;
        float best = -INFINITY;
        int bn = IMAX;
        for (int n = tid; n < N; n += NT) {
          if (!ktt::bit_at(a.stat_u, fcls, W, n)) continue;
          const int32_t* ur = a.used + (int64_t)n * R;
          const int32_t* ar = a.alloc + (int64_t)n * R;
          auto al = [&](int r) { return ar[r]; };
          auto us = [&](int r) { return __ldcg(ur + r); };
          if (!ktt::fit_ok(R, [&](int r) { return fq[r]; }, us, al)) continue;
          const float v = ktt::score_flat(sp, [&](int r) { return ktt::wadd(us(r), fq[r]); }, al);
          if (v > best) {  // nodes ascend per thread: the first maximum
            best = v;
            bn = n;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ob = __shfl_down_sync(FULL, best, off);
          const int on = __shfl_down_sync(FULL, bn, off);
          if (lexbetter(ob, on, best, bn)) {
            best = ob;
            bn = on;
          }
        }
        if (lane == 0) {
          s_bv[warp] = best;
          s_bn[warp] = bn;
        }
        __syncthreads();
        if (warp == 0) {
          best = s_bv[lane];
          bn = s_bn[lane];
          for (int off = 16; off > 0; off >>= 1) {
            const float ob = __shfl_down_sync(FULL, best, off);
            const int on = __shfl_down_sync(FULL, bn, off);
            if (lexbetter(ob, on, best, bn)) {
              best = ob;
              bn = on;
            }
          }
          if (lane == 0) {
            const int t = best > -INFINITY ? bn : -1;
            s_tfb = t;
            const int p = start + q;
            a.out[p] = t;
            a.committed[p] = 1;
            a.ordn[p] = blocks;
            if (t >= 0) {
              int32_t* ur = a.used + (int64_t)t * R;
              for (int r = 0; r < R; ++r) ur[r] = ktt::wadd(__ldcg(ur + r), fq[r]);
            }
          }
        }
        __syncthreads();
        t_fb = s_tfb;
        KTT_PHASE(PH_FALLBACK);
      }
      const bool fb_ok = do_fb && t_fb >= 0;
      // ---- (H) absorb: claims, register fold, t0u patch ----
      if (tid < E && place[tid]) atomicOr(&claimed[nd[tid] >> 5], 1u << (nd[tid] & 31));
      __syncthreads();
      if (tid == 0) {
        // a fallback STACKS when it lands on a node this epoch touched
        s_stacked = fb_ok && ((claimed[t_fb >> 5] >> (t_fb & 31)) & 1u);
        if (fb_ok) claimed[t_fb >> 5] |= 1u << (t_fb & 31);
      }
      __syncthreads();
      for (int u = tid; u < U1; u += NT) {
        const float* s2u = a.s2 + (int64_t)u * E;
        float m = -INFINITY;
        for (int i = 0; i < q; ++i) m = fmaxf(m, s2u[i]);
        int mn = IMAX;
        for (int i = 0; i < q; ++i)
          if (s2u[i] == m && s2n[i] < mn) mn = s2n[i];
        float bm = __ldcg(a.bmax + u);
        int bnd = __ldcg(a.bnode + u);
        if (lexbetter(m, mn, bm, bnd)) {
          bm = m;
          bnd = mn;
        }
        float* row = a.t0u + (int64_t)u * N;
        for (int i = 0; i < q; ++i)
          if (place[i]) row[nd[i]] = s2u[i];
        if (fb_ok) {  // the fallback column last: it may stack on a prefix node
          const int32_t* ur = a.used + (int64_t)t_fb * R;
          const int32_t* ar = a.alloc + (int64_t)t_fb * R;
          const int32_t* rq = a.req_u + (int64_t)u * R;
          auto us = [&](int r) { return __ldcg(ur + r); };
          auto al = [&](int r) { return ar[r]; };
          float fcv = -INFINITY;
          if (ktt::bit_at(a.stat_u, u, W, t_fb) && ktt::fit_ok(R, [&](int r) { return rq[r]; }, us, al))
            fcv = ktt::score_flat(sp, [&](int r) { return ktt::wadd(us(r), rq[r]); }, al);
          row[t_fb] = fcv;
          if (lexbetter(fcv, t_fb, bm, bnd)) {
            bm = fcv;
            bnd = t_fb;
          }
        }
        a.bmax[u] = bm;
        a.bnode[u] = bnd;
      }
      if (tid < E && nd[tid] < N) cm[nd[tid]] = IMAX;
      if (tid == 0) {
        const int ep = (do_fb && (s_stacked || q < E / 8)) ? 1 : 0;
        epochs += ep;
        int32_t* nxt = a.ctrl + 4 * ((step + 1) & 1);
        nxt[0] = q == E ? start + E : start + q + 1;
        nxt[1] = blocks + 1;
        nxt[2] = ep;
        __threadfence();
      }
      __syncthreads();
      KTT_PHASE(PH_ABSORB);
    }
    grid.sync();
    KTT_PHASE(PH_BARRIER);
  }
  if (blockIdx.x == 0 && tid == 0) {
    a.scal[0] = blocks;
    a.scal[1] = epochs;
  }
}

size_t smem_bytes(int N, int W, int E, int KW, int R) {
  const int KWW = (KW + 31) / 32;
  return 4 * ((size_t)N + W + (size_t)E * KW + (size_t)E * KWW + (size_t)E * (R + 13));
}

}  // namespace

// ip / fp: the score parameters (score.cuh make_score_params), host memory
extern "C" int ktt_wave_commit(const void* cls, const void* pvalid, const void* preq,
                               const void* used_in, const void* stat_u, const void* fit_u,
                               const void* base_u, const void* alloc, const void* req_u,
                               void* committed, void* out, void* ordn, void* used, void* t0u,
                               void* tv, void* ti, void* nf, void* s2, void* bmax, void* bnode,
                               void* ctrl, void* scal, const int* ip, const float* fp, int P,
                               int N, int R, int U1, int E, int KW, int iters, int max_blocks,
                               void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  WaveArgs a;
  a.sp = ktt::make_score_params(ip, fp);
  if (!ktt::score_params_ok(a.sp, R) || P <= 0 || N <= 0 || U1 <= 0 || E < 1 || E > MAX_E ||
      E > P || KW < 1 || KW > ktt::TOPK_MAX || KW > N || iters < 0)
    return (int)cudaErrorInvalidValue;
  a.cls = static_cast<const int32_t*>(cls);
  a.pvalid = static_cast<const uint8_t*>(pvalid);
  a.preq = static_cast<const int32_t*>(preq);
  a.used_in = static_cast<const int32_t*>(used_in);
  a.stat_u = static_cast<const uint32_t*>(stat_u);
  a.fit_u = static_cast<const uint32_t*>(fit_u);
  a.base_u = static_cast<const float*>(base_u);
  a.alloc = static_cast<const int32_t*>(alloc);
  a.req_u = static_cast<const int32_t*>(req_u);
  a.committed = static_cast<uint8_t*>(committed);
  a.out = static_cast<int32_t*>(out);
  a.ordn = static_cast<int32_t*>(ordn);
  a.used = static_cast<int32_t*>(used);
  a.t0u = static_cast<float*>(t0u);
  a.tv = static_cast<float*>(tv);
  a.ti = static_cast<int32_t*>(ti);
  a.nf = static_cast<int32_t*>(nf);
  a.s2 = static_cast<float*>(s2);
  a.bmax = static_cast<float*>(bmax);
  a.bnode = static_cast<int32_t*>(bnode);
  a.ctrl = static_cast<int32_t*>(ctrl);
  a.scal = static_cast<int32_t*>(scal);
  a.P = P;
  a.N = N;
  a.R = R;
  a.U1 = U1;
  a.W = (N + 31) / 32;
  a.E = E;
  a.KW = KW;
  a.iters = iters;
  a.max_blocks = max_blocks;
  const size_t smem = smem_bytes(N, a.W, E, KW, R);
  cudaError_t err = cudaFuncSetAttribute(wave_commit_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, nsm = 0, coop = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_commit_kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = U1 < nsm * per_sm ? U1 : nsm * per_sm;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((void*)wave_commit_kernel, dim3(grid), dim3(NT), args, smem, st);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef KTT_WAVE_PHASES
// cycles, hits: host arrays of PH_N; reads the phase counters, then zeroes them
extern "C" int ktt_wave_phases(unsigned long long* cycles, unsigned long long* hits) {
  const unsigned long long zero[PH_N] = {};
  cudaError_t err = cudaMemcpyFromSymbol(cycles, g_phase_cycles, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(hits, g_phase_hits, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_phase_hits, zero, sizeof(zero));
  return (int)err;
}
#endif
