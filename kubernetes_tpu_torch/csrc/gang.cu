// K13 gang_quorum: one iteration of the gang fixpoint's quorum check and
// revocation.
//
// Replaces the body of the JAX package's ops/gang.py:142-161 (the
// lax.while_loop of gang_fixpoint_device) after its batch step:
//   sched[g]   = number of valid pods of group g that were placed
//                (the .at[gidx].add scatter-count; integer atomics, so the
//                order of the adds does not matter);
//   present[g] = group g has a valid pod;
//   bad[g]     = present[g] & sched[g] < group_min[g];
//   first      = the lowest pod index p with pv[p], pod_group[p] >= 0 and
//                bad[pod_group[p]] (an atomicMin over pod indices: the first
//                True that the JAX argmax returns, so no tie can arise),
//                or -1 when no group failed;
//   pv        &= ~(pod_group == pod_group[first]) where a group failed
//                (pv_next, written in place);
//   done       = no group failed.
// `done` also gates the launch: once it is set the kernel returns at entry,
// so the fixpoint's remaining queued iterations cost a launch each and
// change nothing (ops/gang.py, design (b): no host read between
// iterations).
//
// Design: one block of 1024 threads walks the pods in strides, with a block
// barrier between the phases; the group arrays live in global memory (G can
// exceed what shared memory would hold comfortably at 1000s of groups and
// the phases are tiny).  A single block sees its own global writes after
// __syncthreads.
//
// Bounds on an H100 at BASELINE config 5 (P = 65536, G = 1000): it reads
// choices, pod_group and pv (~0.6 MB) once or twice and the group arrays;
// >= 0.2 us at 3.35 TB/s.  One block at ~2 bytes a cycle per SM keeps it
// near 10-30 us: it is a launch-sized kernel next to the batch step.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;
constexpr int IMAX = 0x7fffffff;

__global__ void __launch_bounds__(NT) gang_quorum_kernel(
    const int32_t* __restrict__ choices,    // [P]
    const int32_t* __restrict__ pod_group,  // [P] group id or -1
    uint8_t* __restrict__ pv,               // [P] pod_valid, updated in place
    const int32_t* __restrict__ group_min,  // [G]
    int P, int G,
    int32_t* __restrict__ sched,    // [G] out
    uint8_t* __restrict__ present,  // [G] out
    uint8_t* __restrict__ bad,      // [G] out
    int32_t* __restrict__ first,    // [1] out
    int32_t* done) {                // [1] in: gate; out: no group failed
  __shared__ int anybad, firstp;
  if (*done) return;  // every thread reads the same word
  const int tid = threadIdx.x;
  for (int g = tid; g < G; g += NT) {
    sched[g] = 0;
    present[g] = 0;
  }
  if (tid == 0) {
    anybad = 0;
    firstp = IMAX;
  }
  __syncthreads();
  for (int p = tid; p < P; p += NT) {
    const int g = pod_group[p];
    if (g < 0 || !pv[p]) continue;
    present[g] = 1;
    if (choices[p] >= 0) atomicAdd(sched + g, 1);
  }
  __syncthreads();
  for (int g = tid; g < G; g += NT) {
    const bool b = present[g] && sched[g] < group_min[g];
    bad[g] = b;
    if (b) anybad = 1;
  }
  __syncthreads();
  if (anybad) {
    for (int p = tid; p < P; p += NT) {
      const int g = pod_group[p];
      if (g >= 0 && pv[p] && bad[g]) {
        atomicMin(&firstp, p);
        break;  // this thread's later pods are larger
      }
    }
  }
  __syncthreads();
  if (anybad) {
    const int fg = pod_group[firstp];
    for (int p = tid; p < P; p += NT)
      if (pod_group[p] == fg) pv[p] = 0;
  }
  if (tid == 0) {
    *first = anybad ? firstp : -1;
    *done = !anybad;
  }
}

}  // namespace

// every pointer is device memory; done is read first (a set word makes the
// launch return at entry) and written last
extern "C" int ktt_gang_quorum(const void* choices, const void* pod_group, void* pv, const void* group_min,
                               void* sched, void* present, void* bad, void* first, void* done, int P, int G,
                               void* stream) {
  if (P < 0 || G < 1) return (int)cudaErrorInvalidValue;
  gang_quorum_kernel<<<1, NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(choices), static_cast<const int32_t*>(pod_group), static_cast<uint8_t*>(pv),
      static_cast<const int32_t*>(group_min), P, G, static_cast<int32_t*>(sched), static_cast<uint8_t*>(present),
      static_cast<uint8_t*>(bad), static_cast<int32_t*>(first), static_cast<int32_t*>(done));
  return (int)cudaGetLastError();
}
