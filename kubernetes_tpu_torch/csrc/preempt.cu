// K15 preempt_eval: the batched preemption evaluation, phases A-C, for K
// same-priority preemptors against one shared state snapshot.
//
// Replaces the JAX package's ops/preempt.py:52 _eval_body, vmapped over the
// preemptor axis by preempt_eval_wave (:117); preempt_eval (:110) is the
// same kernel with K = 1.  For each (node n, preemptor k):
//   static   bit n of the preemptor's packed static row (node_valid, node
//            selection, nodeName pin and taints, without pod_valid: the
//            JAX _static_row), read from the words class_hoist.cu's K3
//            wrote for the wave's pod rows;
//   phase A  base = used + nom - sum of the valid victims' requests;
//            okA = static & fit(req, base)  (every victim removed);
//   phase B  the reprieve scan over the V victim slots in the host's order,
//            with the running usage in registers: slot v is kept when
//            fit(req, cur + req_v) & valid & okA (cur += req_v), and is a
//            victim when valid & okA & !fit;
//   phase C  ok2 = fit(req, cur - nom) where the node has a nominated pod
//            and vcnt > 0, else true; nvio = victims counted PDB-violating,
//            vmax = their largest priority (INT32_MIN when none), vsum =
//            the sum of their priorities (an int32 sum that wraps, as
//            JAX's does), vcnt; cand = okA & ok2 & vcnt > 0.
// fit(req, u): every resource with req != 0 has req <= alloc - u (the
// subtraction form; int32 adds and subtractions wrap through uint32, as
// XLA's do).  Bool outputs are uint8.
//
// Design: grid (node tiles of NT, preemptor slices of KS); a thread owns a
// node and the block's slice.  It reads the node's alloc, used and
// nominated rows once and computes phase A's base once (it does not depend
// on k), then walks the slice's preemptors, whose request rows and packed
// static words over the tile the block staged in shared memory.  R is a
// template parameter (a switch over 0..MAX_R), so every per-resource array
// lives in registers: no stack frame.  The victim slots are read from
// memory once a block and from L1 for the slice's other preemptors; a node
// whose okA fails skips phase B (no slot can be kept or evicted there).
// Stores run along n for each k; a (k, n)'s V is_victim bytes are one
// store when V is 1, 2, 4 or 8 and the row is aligned (the host's V is a
// power of two: scheduler/preemption.py _tables), byte stores otherwise.
// At K = 64, N = 20480: 160 x 8 blocks of 128 threads.
//
// Bound on an H100: per wave it reads the victim tables once (N x V x
// (4R + 6) bytes), the alloc / used / nom planes (3 x 4 x N x R), has_nom,
// the K static rows and pod rows, and writes (4 x 4 + 2 + V) bytes per
// (k, n): at K = 64, N = 20480, R = 4, V = 2 that is 28284160 B, ~8.4 us
// at 3.35 TB/s (chip_smoke.py counts it term by term).
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // nodes a block, one a thread
constexpr int KS = 8;    // preemptors a block
constexpr int MAX_R = 16;
constexpr int IMIN = -2147483647 - 1;  // vmax with no victim

__device__ __forceinline__ int wadd(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }

// every resource with q != 0 has q <= alloc - u
template <int R>
__device__ __forceinline__ bool fits(const int* q, const int* alloc, const int* u) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < R; ++r) ok &= q[r] == 0 || q[r] <= wsub(alloc[r], u[r]);
  return ok;
}

struct EvalArgs {
  const uint32_t* stat_w;     // [K, W] packed static rows
  const int32_t* pod_req;     // [P, R]
  const int32_t* pod_idxs;    // [K]
  const int32_t* node_alloc;  // [N, R]
  const int32_t* used_now;    // [N, R]
  const int32_t* nom_extra;   // [N, R]
  const uint8_t* has_nom;     // [N]
  const int32_t* vict_req;    // [N, V, R]
  const int32_t* vict_prio;   // [N, V]
  const uint8_t* vict_viol;   // [N, V]
  const uint8_t* vict_valid;  // [N, V]
  uint8_t* cand;              // [K, N]
  int32_t* nvio;              // [K, N]
  int32_t* vmax;              // [K, N]
  int32_t* vsum;              // [K, N]
  int32_t* vcnt;              // [K, N]
  uint8_t* is_victim;         // [K, N, V]
  uint8_t* static_ok;         // [K, N]
  int K, N, V, W;
  int wide;                   // V in {1, 2, 4, 8} and is_victim aligned to V
};

template <int R>
__global__ void __launch_bounds__(NT) preempt_kernel(const EvalArgs a) {
  constexpr int RA = R > 0 ? R : 1;
  __shared__ int sq[KS][RA];
  __shared__ uint32_t sst[KS][NT / 32];
  const int tid = threadIdx.x;
  const int N = a.N, V = a.V, W = a.W;
  const int n0 = blockIdx.x * NT, k0 = blockIdx.y * KS;
  const int ks = min(KS, a.K - k0);
  // the slice's request rows and static words over the tile
  for (int i = tid; i < ks * R; i += NT) {
    const int kk = i / RA, r = i % RA;
    sq[kk][r] = a.pod_req[(int64_t)a.pod_idxs[k0 + kk] * R + r];
  }
  const int w0 = n0 >> 5;
  for (int i = tid; i < ks * (NT / 32); i += NT) {
    const int kk = i / (NT / 32), w = i % (NT / 32);
    sst[kk][w] = w0 + w < W ? a.stat_w[(int64_t)(k0 + kk) * W + w0 + w] : 0u;
  }
  __syncthreads();
  const int n = n0 + tid;
  if (n >= N) return;
  // the node's tables and phase A's base, once
  int al[RA], nom[RA], base[RA];
  const int32_t* vr = a.vict_req + (int64_t)n * V * R;
  const uint8_t* vv = a.vict_valid + (int64_t)n * V;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    al[r] = a.node_alloc[(int64_t)n * R + r];
    nom[r] = a.nom_extra[(int64_t)n * R + r];
    base[r] = 0;  // the valid victims' requests
  }
  for (int v = 0; v < V; ++v)
    if (vv[v]) {
#pragma unroll
      for (int r = 0; r < R; ++r) base[r] = wadd(base[r], vr[v * R + r]);
    }
#pragma unroll
  for (int r = 0; r < R; ++r) base[r] = wsub(wadd(a.used_now[(int64_t)n * R + r], nom[r]), base[r]);
  const bool hn = a.has_nom[n] != 0;
  const bool wide = a.wide != 0;
  for (int kk = 0; kk < ks; ++kk) {
    const int64_t kn = (int64_t)(k0 + kk) * N + n;
    int q[RA], cur[RA];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      q[r] = sq[kk][r];
      cur[r] = base[r];
    }
    const bool st = (sst[kk][tid >> 5] >> (n & 31)) & 1u;
    const bool okA = st && fits<R>(q, al, cur);
    // phase B: the reprieve scan in slot order (no slot changes where okA fails)
    int cnt = 0, nv = 0, mx = IMIN, sm = 0;
    uint64_t bits = 0;
    uint8_t* iv = a.is_victim + kn * V;
    for (int v = 0; v < V; ++v) {
      bool vic = false;
      if (okA && vv[v]) {
        int trial[RA];
#pragma unroll
        for (int r = 0; r < R; ++r) trial[r] = wadd(cur[r], vr[v * R + r]);
        if (fits<R>(q, al, trial)) {
#pragma unroll
          for (int r = 0; r < R; ++r) cur[r] = trial[r];
        } else {
          vic = true;
          const int pr = a.vict_prio[(int64_t)n * V + v];
          ++cnt;
          nv += a.vict_viol[(int64_t)n * V + v] ? 1 : 0;
          mx = max(mx, pr);
          sm = wadd(sm, pr);
        }
      }
      if (wide)
        bits |= (uint64_t)vic << (8 * v);
      else
        iv[v] = vic;
    }
    if (wide) {
      if (V == 8)
        *reinterpret_cast<uint64_t*>(iv) = bits;
      else if (V == 4)
        *reinterpret_cast<uint32_t*>(iv) = (uint32_t)bits;
      else if (V == 2)
        *reinterpret_cast<uint16_t*>(iv) = (uint16_t)bits;
      else
        *iv = (uint8_t)bits;
    }
    // phase C: the nominated second pass, candidate stats
    bool ok2 = true;
    if (hn && cnt > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) cur[r] = wsub(cur[r], nom[r]);
      ok2 = fits<R>(q, al, cur);
    }
    a.cand[kn] = okA && ok2 && cnt > 0;
    a.nvio[kn] = nv;
    a.vmax[kn] = mx;
    a.vsum[kn] = sm;
    a.vcnt[kn] = cnt;
    a.static_ok[kn] = st;
  }
}

template <int R>
cudaError_t launch(const EvalArgs& a, cudaStream_t st) {
  const dim3 grid((unsigned)((a.N + NT - 1) / NT), (unsigned)((a.K + KS - 1) / KS));
  preempt_kernel<R><<<grid, NT, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// every pointer is device memory
extern "C" int ktt_preempt_eval(const void* stat_w, const void* pod_req, const void* pod_idxs, const void* node_alloc,
                                const void* used_now, const void* nom_extra, const void* has_nom, const void* vict_req,
                                const void* vict_prio, const void* vict_viol, const void* vict_valid, void* cand,
                                void* nvio, void* vmax, void* vsum, void* vcnt, void* is_victim, void* static_ok,
                                int K, int N, int V, int R, void* stream) {
  if (K < 0 || K > 65535 || N < 0 || V < 0 || R < 0 || R > MAX_R) return (int)cudaErrorInvalidValue;
  if (K == 0 || N == 0) return (int)cudaGetLastError();
  EvalArgs a;
  a.stat_w = static_cast<const uint32_t*>(stat_w);
  a.pod_req = static_cast<const int32_t*>(pod_req);
  a.pod_idxs = static_cast<const int32_t*>(pod_idxs);
  a.node_alloc = static_cast<const int32_t*>(node_alloc);
  a.used_now = static_cast<const int32_t*>(used_now);
  a.nom_extra = static_cast<const int32_t*>(nom_extra);
  a.has_nom = static_cast<const uint8_t*>(has_nom);
  a.vict_req = static_cast<const int32_t*>(vict_req);
  a.vict_prio = static_cast<const int32_t*>(vict_prio);
  a.vict_viol = static_cast<const uint8_t*>(vict_viol);
  a.vict_valid = static_cast<const uint8_t*>(vict_valid);
  a.cand = static_cast<uint8_t*>(cand);
  a.nvio = static_cast<int32_t*>(nvio);
  a.vmax = static_cast<int32_t*>(vmax);
  a.vsum = static_cast<int32_t*>(vsum);
  a.vcnt = static_cast<int32_t*>(vcnt);
  a.is_victim = static_cast<uint8_t*>(is_victim);
  a.static_ok = static_cast<uint8_t*>(static_ok);
  a.K = K;
  a.N = N;
  a.V = V;
  a.W = (N + 31) / 32;
  a.wide = (V == 1 || V == 2 || V == 4 || V == 8) && reinterpret_cast<uintptr_t>(is_victim) % V == 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (R) {
#define KTT_R(x) \
  case x:        \
    err = launch<x>(a, st); \
    break;
    KTT_R(0) KTT_R(1) KTT_R(2) KTT_R(3) KTT_R(4) KTT_R(5) KTT_R(6) KTT_R(7) KTT_R(8)
    KTT_R(9) KTT_R(10) KTT_R(11) KTT_R(12) KTT_R(13) KTT_R(14) KTT_R(15) KTT_R(16)
#undef KTT_R
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
