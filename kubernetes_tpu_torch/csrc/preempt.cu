// K15 preempt_eval: the batched preemption evaluation, phases A-C, for K
// same-priority preemptors against one shared state snapshot.
//
// Replaces the JAX package's ops/preempt.py:52 _eval_body, vmapped over the
// preemptor axis by preempt_eval_wave (:117); preempt_eval (:110) is the
// same kernel with K = 1.  One thread per (node n, preemptor k):
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
// Design: grid (ceil(N / NT), K); a block's threads walk neighbouring
// nodes of one preemptor, so the victim tables [N, V, R] are read in
// order; the K preemptors of a wave read the same tables (L2 keeps them).
// V is the host's power of two (scheduler/preemption.py _tables) and R
// at most MAX_R: the running usage lives in a register array.
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

constexpr int NT = 256;
constexpr int MAX_R = 16;
constexpr int IMIN = -2147483647 - 1;  // vmax with no victim

__device__ __forceinline__ int wadd(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }

// every resource with q != 0 has q <= alloc - u
__device__ __forceinline__ bool fits(int R, const int* q, const int32_t* alloc, const int* u) {
  for (int r = 0; r < R; ++r)
    if (q[r] != 0 && !(q[r] <= wsub(alloc[r], u[r]))) return false;
  return true;
}

__global__ void __launch_bounds__(NT) preempt_kernel(
    const uint32_t* __restrict__ stat_w,     // [K, W] packed static rows
    const int32_t* __restrict__ pod_req,     // [P, R]
    const int32_t* __restrict__ pod_idxs,    // [K]
    const int32_t* __restrict__ node_alloc,  // [N, R]
    const int32_t* __restrict__ used_now,    // [N, R]
    const int32_t* __restrict__ nom_extra,   // [N, R]
    const uint8_t* __restrict__ has_nom,     // [N]
    const int32_t* __restrict__ vict_req,    // [N, V, R]
    const int32_t* __restrict__ vict_prio,   // [N, V]
    const uint8_t* __restrict__ vict_viol,   // [N, V]
    const uint8_t* __restrict__ vict_valid,  // [N, V]
    int N, int V, int R, int W,
    uint8_t* __restrict__ cand,       // [K, N]
    int32_t* __restrict__ nvio,       // [K, N]
    int32_t* __restrict__ vmax,       // [K, N]
    int32_t* __restrict__ vsum,       // [K, N]
    int32_t* __restrict__ vcnt,       // [K, N]
    uint8_t* __restrict__ is_victim,  // [K, N, V]
    uint8_t* __restrict__ static_ok) {  // [K, N]
  const int n = blockIdx.x * NT + threadIdx.x;
  if (n >= N) return;
  const int k = blockIdx.y;
  const int64_t kn = (int64_t)k * N + n;
  const int32_t* rq = pod_req + (int64_t)pod_idxs[k] * R;
  int q[MAX_R], cur[MAX_R];
  for (int r = 0; r < R; ++r) q[r] = rq[r];
  const bool st = (stat_w[(int64_t)k * W + (n >> 5)] >> (n & 31)) & 1u;
  const int32_t* an = node_alloc + (int64_t)n * R;
  const int32_t* vr = vict_req + (int64_t)n * V * R;
  const uint8_t* vv = vict_valid + (int64_t)n * V;
  // phase A: every valid victim removed
  for (int r = 0; r < R; ++r) {
    int removed = 0;
    for (int v = 0; v < V; ++v)
      if (vv[v]) removed = wadd(removed, vr[v * R + r]);
    cur[r] = wsub(wadd(used_now[(int64_t)n * R + r], nom_extra[(int64_t)n * R + r]), removed);
  }
  const bool okA = st && fits(R, q, an, cur);
  // phase B: the reprieve scan in slot order
  int cnt = 0, nv = 0, mx = IMIN, sm = 0;
  uint8_t* iv = is_victim + kn * V;
  for (int v = 0; v < V; ++v) {
    int trial[MAX_R];
    for (int r = 0; r < R; ++r) trial[r] = wadd(cur[r], vr[v * R + r]);
    const bool f = fits(R, q, an, trial);
    const bool valid = vv[v] != 0;
    if (f && valid && okA)
      for (int r = 0; r < R; ++r) cur[r] = trial[r];
    const bool vic = valid && okA && !f;
    iv[v] = vic;
    if (vic) {
      const int pr = vict_prio[(int64_t)n * V + v];
      ++cnt;
      nv += vict_viol[(int64_t)n * V + v] ? 1 : 0;
      mx = max(mx, pr);
      sm = wadd(sm, pr);
    }
  }
  // phase C: the nominated second pass, candidate stats
  bool ok2 = true;
  if (has_nom[n] && cnt > 0) {
    for (int r = 0; r < R; ++r) cur[r] = wsub(cur[r], nom_extra[(int64_t)n * R + r]);
    ok2 = fits(R, q, an, cur);
  }
  cand[kn] = okA && ok2 && cnt > 0;
  nvio[kn] = nv;
  vmax[kn] = mx;
  vsum[kn] = sm;
  vcnt[kn] = cnt;
  static_ok[kn] = st;
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
  const int W = (N + 31) / 32;
  dim3 grid((unsigned)((N + NT - 1) / NT), K);
  preempt_kernel<<<grid, NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(stat_w), static_cast<const int32_t*>(pod_req),
      static_cast<const int32_t*>(pod_idxs), static_cast<const int32_t*>(node_alloc),
      static_cast<const int32_t*>(used_now), static_cast<const int32_t*>(nom_extra),
      static_cast<const uint8_t*>(has_nom), static_cast<const int32_t*>(vict_req),
      static_cast<const int32_t*>(vict_prio), static_cast<const uint8_t*>(vict_viol),
      static_cast<const uint8_t*>(vict_valid), N, V, R, W, static_cast<uint8_t*>(cand),
      static_cast<int32_t*>(nvio), static_cast<int32_t*>(vmax), static_cast<int32_t*>(vsum),
      static_cast<int32_t*>(vcnt), static_cast<uint8_t*>(is_victim), static_cast<uint8_t*>(static_ok));
  return (int)cudaGetLastError();
}
