// K11 full_scan: the per-pod sequential commit scan over the full stage set.
//
// Replaces the JAX package's ops/assign.py:181 schedule_scan (its step at
// :258-332 and commit at :334-370, every optional stage: NodePorts,
// PodTopologySpread, InterPodAffinity filter and preferred score,
// TaintToleration and preferred NodeAffinity scores, ImageLocality), with
// ops/pairwise.py (B9) inlined from pairwise.cuh.  Kernel fit_scan keeps the
// fit-only stage set; the router picks by the score config.
//
// For each pod p in activeQ (array) order, one block of 1024 threads:
//   1. the pod's slots into shared memory; the spread minMatch per slot and
//      the required-affinity waiver against the running counts;
//   2. per node: static bit (K7's packed plane) & fit against the running
//      usage & host ports & spread skew & inter-pod required; for feasible
//      nodes the base score (fit + balanced), the spread raw and the
//      inter-pod preferred raw, into a global row scratch; block maxima of
//      the taint, node-affinity and spread raws and the inter-pod max/min
//      over the feasible set;
//   3. per node: the total in the plain version's stage order, masked to
//      -inf where infeasible; the argmax (lowest index on ties);
//   4. thread 0 adds the request to the chosen node's usage, the pod's
//      counts to total_t and its ports; every thread adds the pod's term
//      rows to the [T, N] count planes at the nodes of the chosen node's
//      domains.
// No grid-wide sync is needed; the rest of the card idles (as fit_scan).
//
// Bounds on an H100 at config 3 (P = 10240, N = 6144, T = 80): the bytes
// are the two packed planes (2 x 10240 x 192 words, 15.7 MB) and the pods'
// arrays read once, >= 5 us at 3.35 TB/s; the operations, ~60 f32 per
// feasible (pod, node), under 4 G, >= 0.06 ms at 67 TFLOP/s.  Neither sets
// the time: the chain of P dependent block-wide passes and barriers does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "pairwise.cuh"

namespace {

using ktt::CommitEnt;
using ktt::FullArgs;
using ktt::PodSlots;
using ktt::RowScalars;

constexpr int MAX_ENT = ktt::PW_MAX_M + 3 * ktt::PW_MAX_S;

struct ScanScratch {
  uint8_t* feas;  // [N]
  float* base;    // [N]
  float* sraw;    // [N]
  float* ipraw;   // [N]
  float* total;   // [N]
};

__global__ void __launch_bounds__(ktt::PW_NT) full_scan_kernel(FullArgs a, ScanScratch s, int32_t* choices) {
  __shared__ PodSlots ps;
  __shared__ RowScalars rs;
  __shared__ float red[5 * 32];
  __shared__ int redi[32];
  __shared__ CommitEnt ents[MAX_ENT];
  __shared__ int n_ent;
  __shared__ int s_choice;
  for (int p = 0; p < a.P; ++p) {
    ktt::load_pod(a, p, ps);
    __syncthreads();
    if (!ps.valid) {  // a padding or gated pod: its static row is all 0
      if (threadIdx.x == 0) choices[p] = -1;
      __syncthreads();
      continue;
    }
    ktt::pod_scalars(a, p, ps, red);
    ktt::row_pass(a, p, ps, s.feas, s.base, s.sraw, s.ipraw, s.total, rs, red, redi);
    if (threadIdx.x == 0) {
      const int choice = rs.best > -INFINITY ? rs.best_n : -1;
      choices[p] = choice;
      s_choice = choice;
      n_ent = 0;
      if (choice >= 0) {
        for (int r = 0; r < a.R; ++r) {
          int32_t* u = a.used + (int64_t)choice * a.R + r;
          *u = ktt::wadd(__ldcg(u), ps.req[r]);
        }
        for (int k = 0; k < ps.n_port; ++k) a.ports_used[(int64_t)choice * a.PT + ps.port[k]] = 1;
        n_ent = ktt::commit_entries(a, p, choice, ents);
      }
    }
    __syncthreads();
    if (s_choice >= 0)
      for (int n = threadIdx.x; n < a.N; n += blockDim.x)
        for (int k = 0; k < n_ent; ++k) ktt::apply_entry(a, ents[k], n);
    // the commit lands before any thread reads the state for the next pod
    __syncthreads();
  }
}

}  // namespace

// ip / fp: the score parameters (score.cuh make_score_params), host memory;
// wp: the stage weights (taint, node affinity, spread, inter-pod, image,
// hardPodAffinityWeight); sw: the stage switches (pairwise, interpod score,
// ports, taint, node affinity, image); dims: P, N, R, T, D, PT, CS, A1, A2,
// B, M
extern "C" int ktt_full_scan(const void* const* ptrs, const int* dims, const int* sw, const float* wp,
                             const int* ip, const float* fp, void* choices, void* scratch, void* stream) {
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
  if (!ktt::score_params_ok(a.sp, a.R) || a.N <= 0 || a.P < 0 || a.T < 1 || a.CS > ktt::PW_MAX_S ||
      a.A1 > ktt::PW_MAX_S || a.A2 > ktt::PW_MAX_S || a.B > ktt::PW_MAX_S || a.M > ktt::PW_MAX_M ||
      a.PT > ktt::PW_MAX_PT)
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
  a.cls = nullptr;  // K11 reads pod rows only
  if ((a.taint && !a.traw) || (a.nap && !a.naraw) || (a.img && !a.img_s) || (a.pw && !a.eligs))
    return (int)cudaErrorInvalidValue;
  if (a.P == 0) return (int)cudaGetLastError();
  ScanScratch s;
  uint8_t* base = static_cast<uint8_t*>(scratch);  // 4 f32 rows, then the byte row
  s.base = reinterpret_cast<float*>(base);
  s.sraw = s.base + a.N;
  s.ipraw = s.sraw + a.N;
  s.total = s.ipraw + a.N;
  s.feas = reinterpret_cast<uint8_t*>(s.total + a.N);
  full_scan_kernel<<<1, ktt::PW_NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      a, s, static_cast<int32_t*>(choices));
  return (int)cudaGetLastError();
}
