// Block-wide exact top-k of one f32 row, shared by wave_commit.cu and
// chunk_rounds.cu: the port of lax.top_k over a class row of t0u (the JAX
// package's ops/assign.py:632 and :1111), with its order: values
// descending, equal values in ascending index order.
//
// Each entry becomes a distinct 64-bit key, the sign-folded f32 bits (so
// -inf < -0.0 < +0.0 < inf) above the reversed index; the k-th largest key
// is found by an 8-pass MSB-first radix select (256-bin shared histograms,
// one warp picks the digit), the k keys at or above it are gathered and
// bitonic-sorted in shared memory.  The row is read from L2 (__ldcg: other
// blocks of the grid patch it between calls) once per pass.
//
// Bound: 8 passes x N loads per row; at N = 20480 about 160k L2 loads for
// a row, spread over the block's threads.

#pragma once

#include <math.h>
#include <stdint.h>

namespace ktt {

constexpr int TOPK_MAX = 256;  // largest k (the sort buffer is 256 keys)

struct TopkScratch {
  int hist[256];
  unsigned long long keys[TOPK_MAX];
  int sel_digit;
  int sel_rem;
  int count;
};

__device__ __forceinline__ unsigned long long topk_key(float v, int idx) {
  const uint32_t b = __float_as_uint(v);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned long long)(0xFFFFFFFFu - (uint32_t)idx);
}

__device__ __forceinline__ int topk_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
}

// The k (<= TOPK_MAX, <= n, <= blockDim.x) largest entries of row[0..n) ->
// out_v[k], out_i[k] (global or shared), sorted; returns how many of them
// are > -inf.  Every thread of the block calls it; it begins and ends with
// a block barrier.
__device__ int block_topk(const float* row, int n, int k, float* out_v, int* out_i,
                           TopkScratch& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  unsigned long long prefix = 0, pmask = 0;
  int remaining = k;
  __syncthreads();
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int b = tid; b < 256; b += nt) s.hist[b] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += nt) {
      const unsigned long long key = topk_key(__ldcg(row + i), i);
      if ((key & pmask) == prefix) atomicAdd(&s.hist[(key >> shift) & 255u], 1);
    }
    __syncthreads();
    if (warp == 0) {
      // lane l owns digits [8l, 8l + 8); find the digit d with
      // #(digit > d) < remaining <= #(digit >= d)
      int loc[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        loc[j] = s.hist[lane * 8 + j];
        sum += loc[j];
      }
      int incl = sum;  // suffix sum over lanes >= lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int v = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += v;
      }
      int acc = incl - sum;  // keys with a digit above this lane's digits
#pragma unroll
      for (int j = 7; j >= 0; --j) {
        if (acc < remaining && acc + loc[j] >= remaining) {
          s.sel_digit = lane * 8 + j;
          s.sel_rem = remaining - acc;
        }
        acc += loc[j];
      }
    }
    __syncthreads();
    prefix |= (unsigned long long)s.sel_digit << shift;
    pmask |= 255ull << shift;
    remaining = s.sel_rem;
    __syncthreads();
  }
  // prefix is now the k-th largest key: exactly k keys are >= it
  int p2 = 1;
  while (p2 < k) p2 <<= 1;
  if (tid == 0) s.count = 0;
  for (int i = tid; i < p2; i += nt) s.keys[i] = 0ull;
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    const unsigned long long key = topk_key(__ldcg(row + i), i);
    if (key >= prefix) s.keys[atomicAdd(&s.count, 1)] = key;
  }
  // bitonic sort of p2 keys, descending
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = tid; i < p2; i += nt) {
        const int j = i ^ stride;
        if (j > i) {
          const bool desc = (i & size) == 0;
          const unsigned long long a = s.keys[i], b = s.keys[j];
          if (desc ? (a < b) : (a > b)) {
            s.keys[i] = b;
            s.keys[j] = a;
          }
        }
      }
    }
  }
  __syncthreads();
  bool finite = false;
  if (tid < k) {
    const int idx = topk_index(s.keys[tid]);
    const float v = __ldcg(row + idx);
    out_i[tid] = idx;
    out_v[tid] = v;
    finite = v > -INFINITY;
  }
  return __syncthreads_count(finite);
}

}  // namespace ktt
