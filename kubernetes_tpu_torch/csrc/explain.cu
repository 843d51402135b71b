// K14 explain_counts: one-reason-per-node counts of the unschedulable
// diagnosis for F class representatives.
//
// Replaces the JAX package's ops/explain.py:86 _explain_kernel.  Every
// valid node n is claimed, for rep f (pod row reps[f]), by the first
// failing filter in the reference's plugin order:
//   0  NodeName: pod_nodename != -1 and != n (-2: the named node is missing);
//   1  NodeUnschedulable / 2 TaintToleration: some hard taint of the node
//      is not tolerated, split by node_unsched.  The JAX package counts the
//      intolerable taints with an f32 HIGHEST matmul and tests > 0; that
//      count is exact below 2^24 taints, so it is the same function as the
//      AND-NOT over the packed taint and toleration words taken here;
//   3  NodeAffinity: the pod has a selector and none of its terms matches
//      the node (term_match as ops/filters.py:25 defines it, terms.cuh);
//   4+r  NodeResourcesFit: the first resource r with req != 0 and
//      req > alloc - used (the subtraction form; JAX's argmax takes the
//      first True);
//   4+R  otherwise feasible.
// An unschedulable node without an intolerable taint is not claimed by
// column 1: the synthetic unschedulable taint the encoder adds is what
// claims it.  Rows with rep_valid false stay zero.
//
// Design: one launch, no memset, no scratch made per call.  A block owns
// a tile of TILE = 32 nodes and reads each of its nodes once, into a
// record in shared memory: alloc - used per resource (uint32 wrap, as
// int32 wraps in the JAX package), the first hard-taint word packed from
// the node_taint_ns bytes, the first term word, the valid and
// unschedulable flags (read as RP / 4 16-byte loads).  The terms: up to
// ALL_S, every term gets a bit (term s is bit s); more, only those the
// valid reps with a selector name (terms.cuh NamedTerms), a bit per
// (node, named term).  The reps go in slices of FR (F rounded up to a
// power of two, at most FR_MAX): thread t takes rep t % FR, its request (R
// a template parameter), pin, first toleration word and first term mask
// in registers, and classifies the nodes t / FR, + G, ... (G = NT / FR) of
// the tile without branches, counting each column in a 6-bit field of a
// 64-bit register (at most 32 nodes a thread), so no pair waits on
// another.  Every load that needs nothing staged (the node tile, slice
// 0's rep rows) is issued before the first barrier.  At a slice's end each
// thread adds its nonzero counts into the block's [rep, column] sums by
// shared atomics, and the block adds its nonzero sums with one atomicAdd
// each into copy b % COPIES of an int32 accumulator that the wrapper keeps
// across calls (`acc`: TICKETS ticket words, then COPIES copies of [F,
// 4+R+1], all zero between calls).  A block then takes its copy's ticket;
// the block that completes a copy takes the top ticket, and the block that
// completes that sums the copies into `out` and stores 0 back over every
// word it read, so `out` is written whole, invalid rows as 0, with no
// zeroing pass, and the accumulator is zero again for the next call.  Why
// copies and two tickets: atomics on one address serialise in the L2, and
// 640 blocks (the north star) each adding into one accumulator and taking
// one ticket took 0.0205 ms of card time against 0.0170 with the copies;
// clusters of 8 blocks summing through distributed shared memory first
// took 0.0238 (bench/score_explain.py, PERF.md).  Why not a block per
// row of out: every block would then read every node, F times the node
// traffic and F times the term and taint packing; why not per-block
// partials summed by the last block: that block would read (blocks x F x
// K) ints alone.  The counts are integers, so the order of the atomics
// cannot change the result.  Why 32-node tiles of 128 threads: every
// block of the north star's grid is resident at once (64 registers a
// thread), and each thread's pairs are independent of each other.
//
// Fallbacks, each inside the same kernel: more than TW_STAGE * 32 hard
// taints -> the taint test reads the bytes per pair; S > NAMED_S_MAX or more
// than NS_MAX named terms -> term_ok per pair.  Words past the first (taint,
// toleration, named term) sit in shared memory.
//
// Bound on an H100: it reads the node planes once (N x (2R int32 + L + T
// bytes)) plus F rows of the pods and writes F x (4+R+1) int32; at the
// north star's F = 128, N = 20480, R = 5 about 1 MB, ~0.3 us at 3.35 TB/s;
// its F x N classifications (~40 instructions each) take a few us of the
// card's issue rate.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "terms.cuh"

namespace {

constexpr int NT = 128;        // threads a block
constexpr int TILE = 32;       // nodes a block
constexpr int COPIES = 8;      // copies of the accumulator: block b adds into copy b % COPIES
constexpr int TICKETS = 1 + COPIES;  // the top ticket, then one a copy
constexpr int FR_MAX = 128;    // reps a slice
constexpr int MAX_R = 32;
constexpr int TW_STAGE = 8;    // taint words staged (256 taints)
constexpr int ALL_S = 32;      // up to this many terms, every term gets a bit (no named-term stage)
constexpr int NS_MAX = 256;    // named terms staged
constexpr int NSW_MAX = NS_MAX / 32;

struct ExplainArgs {
  const uint8_t* node_valid;    // [N]
  const int32_t* node_alloc;    // [N, R]
  const int32_t* node_used;     // [N, R] the supplied usage
  const uint8_t* node_unsched;  // [N]
  const uint8_t* node_labels;   // [N, L]
  const uint8_t* node_taint_ns;  // [N, T]
  const uint8_t* sel_mask;      // [S, E, L]
  const int32_t* sel_kind;      // [S, E]
  const int32_t* pod_req;       // [P, R]
  const uint8_t* pod_tol_ns;    // [P, T]
  const int32_t* pod_nodename;  // [P]
  const int32_t* pod_terms;     // [P, TT]
  const uint8_t* pod_has_sel;   // [P]
  const int64_t* reps;          // [F]
  const uint8_t* rep_valid;     // [F]
  int32_t* acc;                 // [1 + F * K], zero between calls
  int32_t* out;                 // [F, K]
  int F, N, T, TT, S, E, L, TW, FR;
};

// bits b of word w of a bool row of T bytes
__device__ __forceinline__ uint32_t pack_word(const uint8_t* __restrict__ row, int T, int w) {
  const int lim = min(32, T - 32 * w);
  uint32_t bits = 0;
  for (int b = 0; b < lim; ++b) bits |= (uint32_t)(row[32 * w + b] != 0) << b;
  return bits;
}

template <int R>
__global__ void __launch_bounds__(NT) explain_kernel(const ExplainArgs a) {
  constexpr int K = 4 + R + 1;
  constexpr int RP = (R + 3 + 3) / 4 * 4;  // a node's record: free[R], taint word 0, term word 0, flags
  constexpr int RS = R > 0 ? R : 1;
  constexpr int CW = (K + 9) / 10;  // 64-bit counter words a thread: ten 6-bit fields each
  __shared__ __align__(16) int32_t nrec[TILE * RP];
  __shared__ uint32_t taintx[(TW_STAGE - 1) * TILE];  // [word - 1][node]
  __shared__ uint32_t tmx[(NSW_MAX - 1) * TILE];      // [named-term word - 1][node]
  __shared__ uint32_t tolx[(TW_STAGE - 1) * FR_MAX];  // [word - 1][rep of the slice]
  __shared__ uint32_t selx[(NSW_MAX - 1) * FR_MAX];   // [named-term word - 1][rep of the slice]
  __shared__ int32_t cnt[FR_MAX * K];                 // [rep of the slice][column], the block's sums
  __shared__ int named[NS_MAX];
  __shared__ NamedTerms nt;
  __shared__ int last;

  const int t = threadIdx.x;
  const int base = blockIdx.x * TILE;
  const bool direct_taint = a.TW > TW_STAGE;
  const bool all_terms = a.S <= ALL_S;  // every term gets a bit, term s is slot s
  const bool use_named = !all_terms && a.S <= NAMED_S_MAX;
  const int FR = a.FR, G = NT / FR;
  const int j = t % FR, g = t / FR;  // this thread's rep of a slice and its first node

  // the loads that need nothing staged go first, so their latencies overlap:
  // the node tile (each node read once), the rep rows of slice 0
  if (use_named) named_clear(nt, a.S);
  for (int n = t; n < TILE; n += NT) {
    const int gn = base + n;
    int32_t* rec = nrec + n * RP;
    int fl = 0;
    if (gn < a.N) {
      fl = (a.node_valid[gn] ? 1 : 0) | (a.node_unsched[gn] ? 2 : 0);
#pragma unroll
      for (int r = 0; r < R; ++r)
        rec[r] = (int)((uint32_t)a.node_alloc[(int64_t)gn * R + r] - (uint32_t)a.node_used[(int64_t)gn * R + r]);
      if (!direct_taint) {
        rec[R] = (int)pack_word(a.node_taint_ns + (int64_t)gn * a.T, a.T, 0);
        for (int w = 1; w < a.TW; ++w)
          taintx[(w - 1) * TILE + n] = pack_word(a.node_taint_ns + (int64_t)gn * a.T, a.T, w);
      }
      uint32_t tm0 = 0;
      if (all_terms)
        for (int s = 0; s < a.S; ++s)
          tm0 |= (uint32_t)term_ok(a.sel_mask, a.sel_kind, a.node_labels, s, gn, a.E, a.L) << s;
      rec[R + 1] = (int)tm0;
    }
    rec[R + 2] = fl;
  }
  bool rv = false, has_sel = false;
  int64_t p = 0;
  int pin = -1;
  int rq[RS];  // the request, 0 as INT_MIN: free < rq[r] is "req != 0 and req > free"
  uint32_t tol0 = 0, selm0 = 0;
  // rep j of the slice at f0: its row into registers, its extra words (its first thread) into shared memory
  auto load_rep = [&](int f0) {
    const int f = f0 + j;
    rv = f < a.F && a.rep_valid[f];
    p = rv ? a.reps[f] : 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int q = rv ? a.pod_req[p * R + r] : 0;
      rq[r] = q != 0 ? q : INT_MIN;
    }
    has_sel = rv && a.pod_has_sel[p];
    pin = rv ? a.pod_nodename[p] : -1;
    selm0 = 0;
    if (rv && !direct_taint) {
      tol0 = pack_word(a.pod_tol_ns + p * a.T, a.T, 0);
      if (g == 0)
        for (int w = 1; w < a.TW; ++w) tolx[(w - 1) * FR_MAX + j] = pack_word(a.pod_tol_ns + p * a.T, a.T, w);
    }
    if (has_sel && all_terms)
      for (int jj = 0; jj < a.TT; ++jj) {
        const int s = a.pod_terms[p * a.TT + jj];
        if (s >= 0) selm0 |= 1u << s;
      }
  };
  load_rep(0);
  for (int i = t; i < FR * K; i += NT) cnt[i] = 0;
  __syncthreads();

  // where there are more terms: only those the valid reps with a selector name
  bool direct_terms = !all_terms && !use_named;
  int nsw = all_terms ? 1 : 0;
  // rep j's named-term mask: word 0 in a register, the rest (its first thread) in shared memory
  auto named_mask = [&]() {
    if (!has_sel) return;
    if (g == 0)
      for (int w = 1; w < nsw; ++w) selx[(w - 1) * FR_MAX + j] = 0u;
    for (int jj = 0; jj < a.TT; ++jj) {
      const int s = a.pod_terms[p * a.TT + jj];
      if (s < 0 || s >= a.S) continue;
      const int k = named_slot(nt, s);
      if (k < 32)
        selm0 |= 1u << k;
      else if (g == 0)
        selx[((k >> 5) - 1) * FR_MAX + j] |= 1u << (k & 31);
    }
  };
  if (use_named) {
    const int64_t marks = (int64_t)a.F * a.TT;
    for (int64_t e = t; e < marks; e += NT) {
      const int f = (int)(e / a.TT);
      if (!a.rep_valid[f]) continue;
      const int64_t q = a.reps[f];
      if (a.pod_has_sel[q]) named_mark(nt, a.pod_terms[q * a.TT + e % a.TT], a.S);
    }
    __syncthreads();
    named_list(nt, a.S, named, NS_MAX);
    __syncthreads();
    direct_terms = nt.count > NS_MAX;
    if (!direct_terms) {
      nsw = (nt.count + 31) / 32;
      for (int i = t; i < nsw * TILE; i += NT) {
        const int w = i / TILE, n = i % TILE, gn = base + n;
        uint32_t word = 0;
        if (gn < a.N)
          for (int b = 0; b < 32 && 32 * w + b < nt.count; ++b)
            if (term_ok(a.sel_mask, a.sel_kind, a.node_labels, named[32 * w + b], gn, a.E, a.L)) word |= 1u << b;
        if (w == 0)
          nrec[n * RP + R + 1] = (int)word;
        else
          tmx[(w - 1) * TILE + n] = word;
      }
      named_mask();
    }
    __syncthreads();
  }

  // the reps, FR at a time; thread t classifies its rep against nodes g, g + G, ...
  for (int f0 = 0; f0 < a.F; f0 += FR) {
    if (f0 > 0) {
      load_rep(f0);
      if (use_named && !direct_terms) named_mask();
      for (int i = t; i < FR * K; i += NT) cnt[i] = 0;
      __syncthreads();
    }
    uint64_t acc6[CW];  // this thread's count per column, 6 bits each (at most TILE = 32 nodes)
#pragma unroll
    for (int w = 0; w < CW; ++w) acc6[w] = 0;
    if (rv) {
#pragma unroll 4
      for (int n = g; n < TILE; n += G) {
        int v[RP];
#pragma unroll
        for (int i = 0; i < RP; i += 4) {
          const int4 x = *reinterpret_cast<const int4*>(&nrec[n * RP + i]);
          v[i] = x.x;
          v[i + 1] = x.y;
          v[i + 2] = x.z;
          v[i + 3] = x.w;
        }
        const int fl = v[R + 2];
        const int gn = base + n;
        bool intol;
        if (direct_taint) {
          intol = false;
          const uint8_t* tn = a.node_taint_ns + (int64_t)(gn < a.N ? gn : 0) * a.T;
          const uint8_t* tp = a.pod_tol_ns + p * a.T;
          for (int x = 0; x < a.T && !intol; ++x) intol = tn[x] && !tp[x];
        } else {
          uint32_t bad = (uint32_t)v[R] & ~tol0;
          for (int w = 1; w < a.TW; ++w) bad |= taintx[(w - 1) * TILE + n] & ~tolx[(w - 1) * FR_MAX + j];
          intol = bad != 0u;
        }
        bool sel_ok = !has_sel;
        if (has_sel) {
          if (direct_terms) {
            for (int jj = 0; jj < a.TT && !sel_ok && (fl & 1); ++jj) {
              const int s = a.pod_terms[p * a.TT + jj];
              if (s >= 0) sel_ok = term_ok(a.sel_mask, a.sel_kind, a.node_labels, s, gn, a.E, a.L);
            }
          } else {
            uint32_t hit = (uint32_t)v[R + 1] & selm0;
            for (int w = 1; w < nsw; ++w) hit |= tmx[(w - 1) * TILE + n] & selx[(w - 1) * FR_MAX + j];
            sel_ok = hit != 0u;
          }
        }
        int col = 4 + R;
#pragma unroll
        for (int r = R - 1; r >= 0; --r) col = v[r] < rq[r] ? 4 + r : col;
        col = sel_ok ? col : 3;
        col = intol ? ((fl & 2) ? 1 : 2) : col;
        col = (pin != -1 && pin != gn) ? 0 : col;
        if (CW == 1) {
          acc6[0] += (uint64_t)(fl & 1) << (6 * col);
        } else {
          const int wsel = (col >= 10) + (col >= 20) + (col >= 30);
          const uint64_t inc = (uint64_t)(fl & 1) << (6 * (col - 10 * wsel));
#pragma unroll
          for (int w = 0; w < CW; ++w) acc6[w] += w == wsel ? inc : 0ull;
        }
      }
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int x = (int)((acc6[c / 10] >> (6 * (c % 10))) & 63u);
        if (x) atomicAdd(&cnt[j * K + c], x);
      }
    }
    __syncthreads();
    // the block's nonzero sums into its copy of the accumulator
    int32_t* mine = a.acc + TICKETS + (int64_t)(blockIdx.x % COPIES) * a.F * K + (int64_t)f0 * K;
    for (int i = t; i < FR * K; i += NT)
      if (cnt[i]) atomicAdd(mine + i, cnt[i]);  // only valid reps count
    __syncthreads();
  }

  // the tickets: a block takes its copy's; the last block of a copy takes the
  // top one; the last of those moves the counts into out and zeroes acc
  __threadfence();
  __syncthreads();
  if (t == 0) {
    const int c = blockIdx.x % COPIES;
    const int in_copy = ((int)gridDim.x - c + COPIES - 1) / COPIES;
    last = 0;
    if (atomicAdd(reinterpret_cast<unsigned*>(a.acc) + 1 + c, 1u) == (unsigned)in_copy - 1) {
      __threadfence();
      last = atomicAdd(reinterpret_cast<unsigned*>(a.acc), 1u) == (unsigned)min((int)gridDim.x, COPIES) - 1;
    }
  }
  __syncthreads();
  if (last) {
    __threadfence();
    const int64_t total = (int64_t)a.F * K;
    const int copies = min((int)gridDim.x, COPIES);
    for (int64_t i = t; i < total; i += NT) {
      int32_t v[COPIES];
#pragma unroll
      for (int c = 0; c < COPIES; ++c) v[c] = c < copies ? __ldcg(a.acc + TICKETS + c * total + i) : 0;
      int sum = 0;
#pragma unroll
      for (int c = 0; c < COPIES; ++c) {
        sum += v[c];
        if (c < copies) __stcg(a.acc + TICKETS + c * total + i, 0);
      }
      a.out[i] = sum;
    }
    if (t < TICKETS) __stcg(a.acc + t, 0);
  }
}

template <int R>
cudaError_t launch(const ExplainArgs& a, cudaStream_t st) {
  const unsigned grid = a.N > 0 ? (unsigned)((a.N + TILE - 1) / TILE) : 1u;
  explain_kernel<R><<<grid, NT, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// every pointer is device memory; acc is the wrapper's accumulator, int32
// [TICKETS + COPIES * F * (4 + R + 1)], zero before the first call (each
// call leaves it so)
extern "C" int ktt_explain_counts(const void* node_valid, const void* node_alloc, const void* node_used,
                                  const void* node_unsched, const void* node_labels, const void* node_taint_ns,
                                  const void* sel_mask, const void* sel_kind, const void* pod_req,
                                  const void* pod_tol_ns, const void* pod_nodename, const void* pod_terms,
                                  const void* pod_has_sel, const void* reps, const void* rep_valid, void* acc,
                                  void* out, int F, int P, int N, int R, int T, int TT, int S, int E, int L,
                                  void* stream) {
  if (F < 0 || F > 65535 || P < 0 || N < 0 || R < 0 || R > MAX_R || T < 0 || TT < 0 || S < 0)
    return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaGetLastError();
  ExplainArgs a;
  a.node_valid = static_cast<const uint8_t*>(node_valid);
  a.node_alloc = static_cast<const int32_t*>(node_alloc);
  a.node_used = static_cast<const int32_t*>(node_used);
  a.node_unsched = static_cast<const uint8_t*>(node_unsched);
  a.node_labels = static_cast<const uint8_t*>(node_labels);
  a.node_taint_ns = static_cast<const uint8_t*>(node_taint_ns);
  a.sel_mask = static_cast<const uint8_t*>(sel_mask);
  a.sel_kind = static_cast<const int32_t*>(sel_kind);
  a.pod_req = static_cast<const int32_t*>(pod_req);
  a.pod_tol_ns = static_cast<const uint8_t*>(pod_tol_ns);
  a.pod_nodename = static_cast<const int32_t*>(pod_nodename);
  a.pod_terms = static_cast<const int32_t*>(pod_terms);
  a.pod_has_sel = static_cast<const uint8_t*>(pod_has_sel);
  a.reps = static_cast<const int64_t*>(reps);
  a.rep_valid = static_cast<const uint8_t*>(rep_valid);
  a.acc = static_cast<int32_t*>(acc);
  a.out = static_cast<int32_t*>(out);
  a.F = F;
  a.N = N;
  a.T = T;
  a.TT = TT;
  a.S = S;
  a.E = E;
  a.L = L;
  a.TW = T > 32 ? (T + 31) / 32 : 1;  // T == 0 packs to one zero word
  a.FR = 1;
  while (a.FR < F && a.FR < FR_MAX) a.FR <<= 1;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (R) {
#define KTT_R(x) \
  case x:        \
    err = launch<x>(a, st); \
    break;
    KTT_R(0) KTT_R(1) KTT_R(2) KTT_R(3) KTT_R(4) KTT_R(5) KTT_R(6) KTT_R(7) KTT_R(8)
    KTT_R(9) KTT_R(10) KTT_R(11) KTT_R(12) KTT_R(13) KTT_R(14) KTT_R(15) KTT_R(16)
    KTT_R(17) KTT_R(18) KTT_R(19) KTT_R(20) KTT_R(21) KTT_R(22) KTT_R(23) KTT_R(24)
    KTT_R(25) KTT_R(26) KTT_R(27) KTT_R(28) KTT_R(29) KTT_R(30) KTT_R(31) KTT_R(32)
#undef KTT_R
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
