// Static feasibility: sf[p, n] = 1 when pod p may go on node n before
// capacity is checked.
//
// Replaces the JAX package's ops/filters.py:81 static_feasible (with
// term_match :28, node_selection_ok_from :47, taints_ok :62 and
// nodename_ok :74), which its per-pod scan hoists at ops/assign.py:197-208.
// XLA evaluates the taint and selector tests there as f32 counting matmuls;
// here they are integer tests, with no product at all:
//
//   term_match_kernel       (feasible.cuh, shared with class_hoist.cu)
//                           tm[s, n]: per expression, count the node's
//                           literals in the mask (AnyOf: > 0, NoneOf: == 0,
//                           PAD: true, anything else: false), AND over the
//                           term's expressions.  One thread per (s, n).
//   pack_bits_kernel        node taints and pod tolerations [rows, T] bytes
//                           -> [rows, TW] uint32 words (TW = max(1, ceil(T / 32))),
//                           so the taint test is an AND-NOT per word.
//   static_feasible_kernel  one thread per 16 consecutive nodes, looping
//                           over pods (p = blockIdx.y, += gridDim.y): the
//                           nodes' validity and first taint word are read
//                           once into registers, each pod's own values one
//                           pod ahead of their use, then per pod
//                           node_valid & pod_valid & no untolerated hard
//                           taint & (no selector | OR over the pod's term ids
//                           of tm) & (no pin | pin == n) is a 16-bit mask,
//                           widened to 16 bytes and written as one 16-byte
//                           store (a warp writes 512 contiguous bytes of the
//                           row).  When N % 16 != 0 rows are not 16-byte
//                           aligned and the bytes go out one by one.
//
// `done` (a device word, or NULL) gates every launch: once it is set each
// kernel returns at entry, so the gang fixpoint's queued per-pod iterations
// (ops/gang.py) stop that way without a host read.
//
// Bound on an H100: the output alone is P*N bytes (1.05 GB at the 50k x 20k
// shape, P=51200, N=20480), >= 0.31 ms at 3.35 TB/s; the inputs are KBs.
// Bit-packing the plane (kernel B6 of ROADMAP.md) would cut the write 8x and
// is later work.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "feasible.cuh"

namespace {

constexpr int VEC = 16;  // nodes per thread: one 16-byte store per pod
constexpr int THREADS = 256;
constexpr int POD_BLOCKS = 1024;  // gridDim.y cap; each block loops over pods

// four 0/1 bytes of a word -> four bits
__device__ __forceinline__ uint32_t nibble_of(uint32_t w) {
  return (w & 1u) | ((w >> 7) & 2u) | ((w >> 14) & 4u) | ((w >> 21) & 8u);
}

// four bits -> four 0/1 bytes of a word
__device__ __forceinline__ uint32_t word_of(uint32_t x) {
  return (x & 1u) | ((x & 2u) << 7) | ((x & 4u) << 14) | ((x & 8u) << 21);
}

__global__ void __launch_bounds__(THREADS) static_feasible_kernel(
    const uint8_t* __restrict__ node_valid,   // [N]
    const uint32_t* __restrict__ taint_w,     // [N, TW]
    const uint8_t* __restrict__ pod_valid,    // [P]
    const uint32_t* __restrict__ tol_w,       // [P, TW]
    const int32_t* __restrict__ pod_nodename,  // [P]
    const int32_t* __restrict__ pod_terms,    // [P, TT]
    const uint8_t* __restrict__ pod_has_sel,  // [P]
    const uint8_t* __restrict__ tm,           // [S, N]
    int P, int N, int TW, int TT,
    uint8_t* __restrict__ sf,  // [P, N]
    const int32_t* __restrict__ done) {  // or NULL
  if (done != nullptr && *done) return;
  const int n0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (n0 >= N) return;
  const int cnt = min(VEC, N - n0);
  const bool vec = (N % VEC) == 0;  // rows 16-byte aligned, and cnt == VEC
  uint32_t valid = 0;  // bit k: node n0 + k is real
  uint32_t taint0[VEC];  // first taint word of each node
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    taint0[k] = 0;
    if (k < cnt) {
      valid |= (uint32_t)(node_valid[n0 + k] != 0) << k;
      taint0[k] = taint_w[(int64_t)(n0 + k) * TW];
    }
  }
  // the pod's own values are loaded one pod ahead, so their latency hides
  // behind the current pod's tests and store
  int p = blockIdx.y;
  uint32_t nx_valid = 0, nx_sel = 0, nx_tol0 = 0;
  int nx_pin = -1;
  if (p < P) {
    nx_valid = pod_valid[p];
    nx_sel = pod_has_sel[p];
    nx_pin = pod_nodename[p];
    nx_tol0 = tol_w[(int64_t)p * TW];
  }
  for (; p < P; p += gridDim.y) {
    const uint32_t pod_ok = nx_valid, has_sel = nx_sel, tol0 = nx_tol0;
    const int pin = nx_pin;  // -1 none, -2 a missing node: never
    const int pn = p + gridDim.y;
    if (pn < P) {
      nx_valid = pod_valid[pn];
      nx_sel = pod_has_sel[pn];
      nx_pin = pod_nodename[pn];
      nx_tol0 = tol_w[(int64_t)pn * TW];
    }
    uint32_t ok = 0;
    if (pod_ok) {
      ok = valid;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        if (taint0[k] & ~tol0) ok &= ~(1u << k);
      }
      for (int k = 0; TW > 1 && k < cnt; ++k) {  // taint vocabularies past 32
        const uint32_t* taint = taint_w + (int64_t)(n0 + k) * TW;
        const uint32_t* tol = tol_w + (int64_t)p * TW;
        for (int w = 1; ((ok >> k) & 1u) && w < TW; ++w) {
          if (taint[w] & ~tol[w]) ok &= ~(1u << k);
        }
      }
      if (pin != -1) ok &= (pin >= n0 && pin < n0 + cnt) ? (1u << (pin - n0)) : 0u;
      if (ok && has_sel) {
        uint32_t any = 0;
        const int32_t* terms = pod_terms + (int64_t)p * TT;
        for (int j = 0; j < TT; ++j) {
          const int s = terms[j];
          if (s < 0) continue;
          const uint8_t* row = tm + (int64_t)s * N + n0;
          if (vec) {
            const uint4 v = *reinterpret_cast<const uint4*>(row);
            any |= nibble_of(v.x) | (nibble_of(v.y) << 4) | (nibble_of(v.z) << 8) |
                   (nibble_of(v.w) << 12);
          } else {
            for (int k = 0; k < cnt; ++k) any |= (uint32_t)(row[k] != 0) << k;
          }
        }
        ok &= any;
      }
    }
    uint8_t* row = sf + (int64_t)p * N + n0;
    if (vec) {
      *reinterpret_cast<uint4*>(row) =
          make_uint4(word_of(ok & 0xfu), word_of((ok >> 4) & 0xfu), word_of((ok >> 8) & 0xfu),
                     word_of((ok >> 12) & 0xfu));
    } else {
      for (int k = 0; k < cnt; ++k) row[k] = (uint8_t)((ok >> k) & 1u);
    }
  }
}

}  // namespace

// done (or NULL): the gate above; every pointer else is device memory
extern "C" int ktt_static_feasible(const void* node_valid, const void* node_taint_ns,
                                   const void* node_labels, const void* pod_valid,
                                   const void* pod_tol_ns, const void* pod_nodename,
                                   const void* pod_terms, const void* pod_has_sel,
                                   const void* sel_mask, const void* sel_kind, void* tm,
                                   void* taint_w, void* tol_w, void* sf, const void* done, int P, int N,
                                   int T, int TT, int S, int E, int L, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (P <= 0 || N <= 0) return (int)cudaGetLastError();
  const int TW = T > 32 ? (T + 31) / 32 : 1;  // T == 0 packs to one zero word
  const int32_t* dn = static_cast<const int32_t*>(done);
  term_match_kernel<<<blocks_for((int64_t)S * N, THREADS), THREADS, 0, st>>>(
      static_cast<const uint8_t*>(sel_mask), static_cast<const int32_t*>(sel_kind),
      static_cast<const uint8_t*>(node_labels), S, E, L, N, static_cast<uint8_t*>(tm), dn);
  pack_bits_kernel<<<blocks_for((int64_t)N * TW, THREADS), THREADS, 0, st>>>(
      static_cast<const uint8_t*>(node_taint_ns), N, T, TW, static_cast<uint32_t*>(taint_w), dn);
  pack_bits_kernel<<<blocks_for((int64_t)P * TW, THREADS), THREADS, 0, st>>>(
      static_cast<const uint8_t*>(pod_tol_ns), P, T, TW, static_cast<uint32_t*>(tol_w), dn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int groups = (N + VEC - 1) / VEC;
  const int threads = groups < THREADS ? ((groups + 31) / 32) * 32 : THREADS;
  dim3 grid(blocks_for(groups, threads), P < POD_BLOCKS ? P : POD_BLOCKS);
  static_feasible_kernel<<<grid, threads, 0, st>>>(
      static_cast<const uint8_t*>(node_valid), static_cast<const uint32_t*>(taint_w),
      static_cast<const uint8_t*>(pod_valid), static_cast<const uint32_t*>(tol_w),
      static_cast<const int32_t*>(pod_nodename), static_cast<const int32_t*>(pod_terms),
      static_cast<const uint8_t*>(pod_has_sel), static_cast<const uint8_t*>(tm), P, N, TW, TT,
      static_cast<uint8_t*>(sf), dn);
  return (int)cudaGetLastError();
}
