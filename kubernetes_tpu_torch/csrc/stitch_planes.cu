// K17 ktt_stitch_planes: per-shard packed blocks -> one flat packed plane.
//
// The node mesh (parallel/mesh.py) keeps a packed mask plane per shard:
// shard s's [rows, Wl] words, Wl = ceil(nl / 32), the packed form of its own
// nl nodes with its own zero tail bits.  Gathered end to end (the tiled
// all_gather, parallel/collectives.py) they are the JAX package's tiled
// layout [rows, S * Wl] (ops/bitplane.py:100-175, its all_gather of packed
// planes at ops/assign.py:1000-1010).  The commit kernels (K5, K6, K8) read
// the flat layout of S * nl bits, [rows, W] with W = ceil(S * nl / 32):
// this kernel turns the one into the other, so they stay as they are.
//
// One thread per output word w of a row: its 32 global columns
// [32 w, 32 w + 32) fall in at most two shard blocks when nl >= 32 (a
// funnel shift of two source words across a block boundary), in more when
// nl < 32; the loop below takes each run of columns that one source word
// holds, shifts it into place and ORs it in.  Columns at or past S * nl
// (the tail of the last word) stay zero.  When nl % 32 == 0 the two
// layouts coincide and every output word is one source word: a copy.
//
// Bound on an H100: rows x (S * Wl + W) x 4 bytes moved, a few integer
// operations per word -- bytes, at 3.35 TB/s.  The stitch of the north
// star's class planes (U1 = 101 rows, N = 20481 on 3 shards) moves ~0.5 MB;
// the dense route's static rows (P = 51200 rows) ~263 MB.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) stitch_kernel(const uint32_t* __restrict__ in,  // [rows, S * Wl]
                                                     int64_t rows, int S, int nl, int Wl, int W,
                                                     uint32_t* __restrict__ out) {  // [rows, W]
  const int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (i >= rows * W) return;
  const int64_t r = i / W;
  const int w = (int)(i % W);
  const int64_t total = (int64_t)S * nl;
  const uint32_t* src = in + r * ((int64_t)S * Wl);
  const int64_t g0 = (int64_t)w * 32;
  const int64_t g1 = g0 + 32 < total ? g0 + 32 : total;
  uint32_t word = 0;
  int64_t c = g0;
  while (c < g1) {
    const int s = (int)(c / nl);
    const int l = (int)(c - (int64_t)s * nl);
    const int off = l & 31;
    // the run of columns source word (s, l / 32) holds from bit `off`
    int64_t run = 32 - off;
    if (run > nl - l) run = nl - l;
    if (run > g1 - c) run = g1 - c;
    const uint32_t v = src[(int64_t)s * Wl + (l >> 5)] >> off;
    const uint32_t mask = run >= 32 ? 0xffffffffu : ((1u << run) - 1u);
    word |= (v & mask) << (int)(c - g0);
    c += run;
  }
  out[i] = word;
}

}  // namespace

extern "C" int ktt_stitch_planes(const void* in, void* out, long long rows, int S, int nl, void* stream) {
  if (rows <= 0 || S <= 0 || nl <= 0) return (int)cudaGetLastError();
  const int Wl = (nl + 31) / 32;
  const int64_t total = (int64_t)S * nl;
  const int W = (int)((total + 31) / 32);
  const int64_t work = rows * (int64_t)W;
  const int64_t blocks = (work + NT - 1) / NT;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  stitch_kernel<<<(unsigned)blocks, NT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), rows, S, nl, Wl, W, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
