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
//      the node (term_match as ops/filters.py:25 defines it, feasible.cuh);
//   4+r  NodeResourcesFit: the first resource r with req != 0 and
//      req > alloc - used (the subtraction form; JAX's argmax takes the
//      first True);
//   4+R  otherwise feasible.
// An unschedulable node without an intolerable taint is not claimed by
// column 1: the synthetic unschedulable taint the encoder adds is what
// claims it.  Rows with rep_valid false stay zero.
//
// Design: one thread per (node, rep), grid (ceil(N / NT), F); each thread
// adds 1 to one of its block's shared counters, then the block adds its
// nonzero counters to out[f] with one atomicAdd each.  The counters are
// integers, so the order of the atomics cannot change the result.  The
// term matrix tm [S, N] and the taint / toleration words come from
// feasible.cuh's kernels, launched first on the same stream.
//
// Bound on an H100: it reads the node planes once (N x (2R int32 + L + T
// bytes)) plus F rows of the pods and writes F x (4+R+1) int32; at the
// north star's F = 128, N = 20480, R = 5 about 1 MB, ~0.3 us at 3.35 TB/s.
// It is a launch-sized kernel; simple and right first.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "feasible.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_R = 32;
constexpr int MAX_COLS = 4 + MAX_R + 1;

__global__ void __launch_bounds__(NT) explain_kernel(
    const uint8_t* __restrict__ node_valid,    // [N]
    const int32_t* __restrict__ node_alloc,    // [N, R]
    const int32_t* __restrict__ node_used,     // [N, R] the supplied usage
    const uint8_t* __restrict__ node_unsched,  // [N]
    const uint32_t* __restrict__ taint_w,      // [N, TW]
    const uint32_t* __restrict__ tol_w,        // [P, TW]
    const uint8_t* __restrict__ tm,            // [S, N]
    const int32_t* __restrict__ pod_req,       // [P, R]
    const int32_t* __restrict__ pod_nodename,  // [P]
    const int32_t* __restrict__ pod_terms,     // [P, TT]
    const uint8_t* __restrict__ pod_has_sel,   // [P]
    const int64_t* __restrict__ reps,          // [F]
    const uint8_t* __restrict__ rep_valid,     // [F]
    int N, int R, int TW, int TT,
    int32_t* __restrict__ out) {  // [F, 4 + R + 1], zeroed
  __shared__ int cnt[MAX_COLS];
  const int f = blockIdx.y;
  if (!rep_valid[f]) return;  // the whole block leaves
  const int K = 4 + R + 1;
  for (int c = threadIdx.x; c < K; c += NT) cnt[c] = 0;
  __syncthreads();
  const int n = blockIdx.x * NT + threadIdx.x;
  if (n < N && node_valid[n]) {
    const int64_t p = reps[f];
    int col;
    const int pin = pod_nodename[p];
    bool intol = false;
    for (int w = 0; w < TW && !intol; ++w) intol = (taint_w[(int64_t)n * TW + w] & ~tol_w[p * TW + w]) != 0;
    if (pin != -1 && pin != n) {
      col = 0;
    } else if (intol) {
      col = node_unsched[n] ? 1 : 2;
    } else {
      bool sel_ok = true;
      if (pod_has_sel[p]) {
        sel_ok = false;
        for (int j = 0; j < TT && !sel_ok; ++j) {
          const int s = pod_terms[p * TT + j];
          if (s >= 0) sel_ok = tm[(int64_t)s * N + n] != 0;
        }
      }
      if (!sel_ok) {
        col = 3;
      } else {
        col = 4 + R;
        const int32_t* rq = pod_req + p * R;
        const int32_t* an = node_alloc + (int64_t)n * R;
        const int32_t* un = node_used + (int64_t)n * R;
        for (int r = 0; r < R; ++r) {
          const int q = rq[r];
          // alloc - used wraps as int32 does in the JAX package
          const int free_r = (int)((uint32_t)an[r] - (uint32_t)un[r]);
          if (q != 0 && q > free_r) {
            col = 4 + r;
            break;
          }
        }
      }
    }
    atomicAdd(&cnt[col], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < K; c += NT)
    if (cnt[c]) atomicAdd(out + (int64_t)f * K + c, cnt[c]);
}

}  // namespace

// every pointer is device memory; tm, taint_w and tol_w are scratch the
// wrapper allocates ([S, N] bytes, [N, TW] and [P, TW] words with TW =
// max(1, ceil(T / 32)))
extern "C" int ktt_explain_counts(const void* node_valid, const void* node_alloc, const void* node_used,
                                  const void* node_unsched, const void* node_labels, const void* node_taint_ns,
                                  const void* sel_mask, const void* sel_kind, const void* pod_req,
                                  const void* pod_tol_ns, const void* pod_nodename, const void* pod_terms,
                                  const void* pod_has_sel, const void* reps, const void* rep_valid, void* tm,
                                  void* taint_w, void* tol_w, void* out, int F, int P, int N, int R, int T, int TT,
                                  int S, int E, int L, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (F < 0 || F > 65535 || P < 0 || N < 0 || R < 0 || R > MAX_R) return (int)cudaErrorInvalidValue;
  const int K = 4 + R + 1;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int32_t) * (size_t)F * K, st);
  if (err != cudaSuccess || F == 0 || N == 0) return (int)err;
  const int TW = T > 32 ? (T + 31) / 32 : 1;  // T == 0 packs to one zero word
  if (S > 0)
    term_match_kernel<<<blocks_for((int64_t)S * N, NT), NT, 0, st>>>(
        static_cast<const uint8_t*>(sel_mask), static_cast<const int32_t*>(sel_kind),
        static_cast<const uint8_t*>(node_labels), S, E, L, N, static_cast<uint8_t*>(tm), nullptr);
  pack_bits_kernel<<<blocks_for((int64_t)N * TW, NT), NT, 0, st>>>(
      static_cast<const uint8_t*>(node_taint_ns), N, T, TW, static_cast<uint32_t*>(taint_w), nullptr);
  if (P > 0)
    pack_bits_kernel<<<blocks_for((int64_t)P * TW, NT), NT, 0, st>>>(
        static_cast<const uint8_t*>(pod_tol_ns), P, T, TW, static_cast<uint32_t*>(tol_w), nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks_for(N, NT), F);
  explain_kernel<<<grid, NT, 0, st>>>(
      static_cast<const uint8_t*>(node_valid), static_cast<const int32_t*>(node_alloc),
      static_cast<const int32_t*>(node_used), static_cast<const uint8_t*>(node_unsched),
      static_cast<const uint32_t*>(taint_w), static_cast<const uint32_t*>(tol_w), static_cast<const uint8_t*>(tm),
      static_cast<const int32_t*>(pod_req), static_cast<const int32_t*>(pod_nodename),
      static_cast<const int32_t*>(pod_terms), static_cast<const uint8_t*>(pod_has_sel),
      static_cast<const int64_t*>(reps), static_cast<const uint8_t*>(rep_valid), N, R, TW, TT,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
