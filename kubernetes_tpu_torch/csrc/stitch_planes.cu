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
// Output word w's 32 global columns [32 w, 32 w + 32) are the same source
// bits in every row, so the map from w to its source words, shifts and
// masks is row-independent.  One launch: a block owns a tile of up to
// TILE_WORDS output words and a group of rows (one wave of blocks); each
// thread builds the map entries of its WPT words of the tile once (32-bit
// arithmetic, one division a word) and keeps them in registers while it
// walks the block's rows (a 64-bit row base, 32-bit offsets inside a row),
// the threads along the words.  When nl >= 32 a word is a funnel shift of
// block s's one or two source words, masked to block s's bits, and, where
// block s ends inside the word, block s + 1's first source word shifted
// into the rest (at nl = 6827 on 3 shards word 426 takes 11 bits from each
// of words 212 and 213 of block 1 and 10 from block 2: three source words);
// inside a block it is one funnel shift.  The masks keep only the columns
// each piece owns, so tail bits of a source block never leak.  With many
// rows a block (the dense rows) the tile's source words of each row are
// first copied into one of STAGES row buffers in shared memory by
// cp.async, STAGES - 1 rows in flight while one is assembled; with few
// (the class planes, a row a block) the words load straight from global
// memory.  When nl < 32 a word can draw on every block: the map gives its
// first block and bit and the count of blocks, and a short loop takes each
// run.  When nl % 32 == 0 the two layouts coincide and the kernel is a
// coalesced copy of rows x W words, 16 bytes a thread where both buffers
// are 16-byte aligned.
//
// Why 4-byte accesses in the stitch: a row of 642 source words starts only
// 8-byte aligned and a row of 641 output words 4-byte aligned, while the
// threads along the words already make each warp's copies and stores whole
// 128-byte runs.  What bounds it is memory parallelism: a word's loads
// behind a branch, or behind the previous word's store, wait one memory
// latency each, so the loads are predicated and the rows staged.
//
// Bound on an H100: rows x (S * Wl + W) x 4 bytes moved, a few integer
// operations per word -- bytes, at 3.35 TB/s.  The stitch of the north
// star's class planes (U1 = 101 rows, N = 20481 on 3 shards) moves ~0.5 MB;
// the dense route's static rows (P = 51200 rows) ~263 MB, >= 78 us.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace {

constexpr int NT = 256;
constexpr int MAX_WPT = 4;  // output words a thread keeps the map of, at most
constexpr int TILE_WORDS = NT * MAX_WPT;  // the widest tile of words a block takes
constexpr int STITCH_PER_SM = 8;  // rows x tiles past this many blocks an SM: WPT words a thread
constexpr int X_BITS = 24;  // a map entry's source word index; the shift above it
constexpr int STAGES = 4;  // row buffers a block cycles through

__device__ __forceinline__ uint32_t low_mask(int bits) { return bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u); }

// The map entry of output word w for nl >= 32: a = x0 | off << X_BITS, b =
// x1, m01, c = x2 | sh2 << X_BITS, m2 such that
//   word = funnel(in[x0], in[x1]) >> off & m01 | (in[x2] << sh2) & m2
// with x1 = x0 + 1 where the word's bits of block s run into block s's
// next source word (else x1 = x0), m01 the bits block s gives, and the
// third piece the first source word of block s + 1 where block s ends
// inside the word (else m2 = 0 and x2 = x0).  Inside a block (all but
// about one word a shard) m01 is all ones and m2 0: one funnel shift.
// For nl < 32: a = first block | first bit << X_BITS, b = the number of
// blocks the word draws on.
struct WordMap {
  uint32_t a, b, m01, c, m2;
};

__device__ __forceinline__ WordMap word_map(int w, int S, int nl, int Wl, int total) {
  const int g0 = 32 * w;
  const int g1 = min(g0 + 32, total);
  int s = g0 / nl;
  int l = g0 - s * nl;
  WordMap e{};
  if (nl < 32) {
    int blocks = 0;
    for (int c = g0; c < g1; ++blocks) {
      c += (blocks == 0 ? nl - l : nl);
    }
    e.a = (uint32_t)s | ((uint32_t)l << X_BITS);
    e.b = (uint32_t)blocks;
    return e;
  }
  const int off = l & 31;
  const int x0 = s * Wl + (l >> 5);
  // block s's bits in this word: to its end or the word's, whichever first
  int own = nl - l;
  if (own > g1 - g0) own = g1 - g0;
  e.a = (uint32_t)x0 | ((uint32_t)off << X_BITS);
  e.b = (uint32_t)(off + own > 32 ? x0 + 1 : x0);
  e.m01 = low_mask(own);
  e.c = (uint32_t)x0;
  if (own < g1 - g0) {  // block s ends inside the word: block s + 1's first word fills it
    e.c = (uint32_t)((s + 1) * Wl) | ((uint32_t)own << X_BITS);
    e.m2 = low_mask(g1 - g0 - own) << own;
  }
  return e;
}

// nl < 32: one output word of the row at src, a run from each block
__device__ __forceinline__ uint32_t assemble_small(const uint32_t* __restrict__ src, const WordMap& e, int nl) {
  int s = (int)(e.a & ((1u << X_BITS) - 1u)), l = (int)(e.a >> X_BITS), pos = 0;
  uint32_t word = 0u;
  for (int b = 0; b < (int)e.b; ++b, ++s, l = 0) {
    const int run = min(nl - l, 32 - pos);
    word |= ((__ldg(src + s) >> l) & low_mask(run)) << pos;  // nl < 32: block s is word s
    pos += run;
  }
  return word;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(smem)), "l"(gmem));
}

// How a block reads its rows' source words: nl < 32, a run from each block
// straight from global memory; DIRECT (few rows a block: the class planes),
// each word's two or three source words straight from global memory;
// STAGED (many rows a block: the dense rows), the tile's source words of a
// row, [lo, lo + span), copied into one of STAGES row buffers in shared
// memory (cp.async, STAGES - 1 rows in flight while a row is assembled from
// its buffer).
enum StitchKind { SMALL_NL = 0, DIRECT = 1, STAGED = 2 };

// A block: WPT words a thread of its tile of output words (thread t: words
// wb + t + j * blockDim.x), rows [r0, r1).
template <int KIND, int WPT>
__global__ void __launch_bounds__(NT) stitch_kernel(const uint32_t* __restrict__ in,  // [rows, S * Wl]
                                                     int rows, int rpb, int tile, int span, int S, int nl, int Wl,
                                                     int W, uint32_t* __restrict__ out) {  // [rows, W]
  extern __shared__ uint32_t rows_sm[];  // [STAGES][span]
  const int T = (int)blockDim.x;
  const int wb = (int)blockIdx.x * tile;
  const int w0 = wb + (int)threadIdx.x;
  const int wend = min(W, wb + tile);
  const int r0 = (int)blockIdx.y * rpb;
  const int nr = min(rows, r0 + rpb) - r0;
  const int total = S * nl;
  const int win = S * Wl;
  const uint32_t xmask = (1u << X_BITS) - 1u;
  WordMap e[WPT];
  int mine = 0;
#pragma unroll
  for (int j = 0; j < WPT; ++j) {
    e[j] = WordMap{};
    if (w0 + j * T < wend) {
      e[j] = word_map(w0 + j * T, S, nl, Wl, total);
      mine = j + 1;
    }
  }
  if (KIND != STAGED) {
    for (int r = r0; r < r0 + nr; ++r) {
      const uint32_t* src = in + (int64_t)r * win;
#pragma unroll
      for (int j = 0; j < WPT; ++j) {
        if (j < mine) {
          uint32_t word;
          if (KIND == SMALL_NL) {
            word = assemble_small(src, e[j], nl);
          } else {
            const uint32_t a = __ldg(src + (e[j].a & xmask)), b = __ldg(src + e[j].b);
            const uint32_t c = e[j].m2 ? __ldg(src + (e[j].c & xmask)) : 0u;
            word = (__funnelshift_r(a, b, e[j].a >> X_BITS) & e[j].m01) | ((c << (e[j].c >> X_BITS)) & e[j].m2);
          }
          out[(int64_t)r * W + w0 + j * T] = word;
        }
      }
    }
    return;
  }
  // the tile's source words: from its first word's first to its last
  // word's last (the map's indices ascend with the words)
  const int lo = (int)(word_map(wb, S, nl, Wl, total).a & xmask);
  const WordMap last = word_map(wend - 1, S, nl, Wl, total);
  const int need = max((int)last.b, (int)(last.c & xmask)) + 1 - lo;  // <= span
  auto issue = [&](int i) {  // row r0 + i into buffer i % STAGES, one commit group
    if (i < nr) {
      const uint32_t* src = in + (int64_t)(r0 + i) * win + lo;
      uint32_t* dst = rows_sm + (i % STAGES) * span;
      for (int k = threadIdx.x; k < need; k += T) cp_async4(dst + k, src + k);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) issue(i);
  for (int i = 0; i < nr; ++i) {
    issue(i + STAGES - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 1));  // row i's group is in
    __syncthreads();
    const uint32_t* row = rows_sm + (i % STAGES) * span - lo;
    uint32_t* d = out + (int64_t)(r0 + i) * W + w0;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      if (j < mine) {
        const uint32_t a = row[e[j].a & xmask], b = row[e[j].b];
        const uint32_t c = e[j].m2 ? row[e[j].c & xmask] : 0u;
        d[j * T] = (__funnelshift_r(a, b, e[j].a >> X_BITS) & e[j].m01) | ((c << (e[j].c >> X_BITS)) & e[j].m2);
      }
    }
    __syncthreads();  // row i's buffer is read before row i + STAGES is copied into it
  }
}

// nl % 32 == 0: the layouts coincide, a copy of n words
__global__ void __launch_bounds__(NT) copy_kernel(const uint32_t* __restrict__ in, int64_t n, bool vec,
                                                  uint32_t* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * NT;
  int64_t k = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (vec) {
    const int64_t n4 = n / 4;
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    for (int64_t j = k; j < n4; j += stride) out4[j] = __ldg(in4 + j);
    for (int64_t j = 4 * n4 + k; j < n; j += stride) out[j] = __ldg(in + j);
  } else {
    for (int64_t j = k; j < n; j += stride) out[j] = __ldg(in + j);
  }
}

}  // namespace

namespace {

struct StitchShape {
  const uint32_t* src;
  uint32_t* dst;
  int64_t rows;
  int S, nl, Wl, W;
  int64_t tiles;
  int tile, threads, span, dev, nsm;
  cudaStream_t st;
};

// one wave: as many row groups as the card holds blocks of this kernel
// beside the word tiles
template <int KIND, int WPT>
cudaError_t launch_stitch(const StitchShape& a) {
  static ktt::Occupancy memo;
  const size_t smem = KIND == STAGED ? (size_t)STAGES * a.span * sizeof(uint32_t) : 0;
  int per_sm = 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(stitch_kernel<KIND, WPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  err = ktt::blocks_per_sm(memo, stitch_kernel<KIND, WPT>, a.dev, a.threads, smem, &per_sm);
  if (err != cudaSuccess) return err;
  int64_t groups = (int64_t)per_sm * a.nsm / a.tiles;
  if (groups < 1) groups = 1;
  if (groups > a.rows) groups = a.rows;
  const int64_t rpb = (a.rows + groups - 1) / groups;
  groups = (a.rows + rpb - 1) / rpb;
  if (a.tiles > 0x7fffffffLL || groups > 65535) return cudaErrorInvalidValue;
  stitch_kernel<KIND, WPT><<<dim3((unsigned)a.tiles, (unsigned)groups), a.threads, smem, a.st>>>(
      a.src, (int)a.rows, (int)rpb, a.tile, a.span, a.S, a.nl, a.Wl, a.W, a.dst);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ktt_stitch_planes(const void* in, void* out, long long rows, int S, int nl, void* stream) {
  if (rows <= 0 || S <= 0 || nl <= 0) return (int)cudaGetLastError();
  const int64_t Wl = (nl + 31) / 32;
  const int64_t total = (int64_t)S * nl;
  const int64_t W = (total + 31) / 32;
  // 32-bit positions inside a row and a row count a grid can cover
  if (total >= (1LL << 31) || S * Wl >= (1LL << X_BITS) || rows >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int dev = 0, nsm = 0;
  const cudaError_t err = ktt::device_sms(&dev, &nsm);
  if (err != cudaSuccess) return (int)err;
  const int64_t target = (int64_t)STITCH_PER_SM * nsm;
  const uint32_t* src = static_cast<const uint32_t*>(in);
  uint32_t* dst = static_cast<uint32_t*>(out);
  if (nl % 32 == 0) {
    const int64_t n = rows * W;
    const bool vec = ((reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
    int64_t blocks = (vec ? (n / 4 + NT - 1) : (n + NT - 1)) / NT;
    if (blocks > target) blocks = target;
    if (blocks < 1) blocks = 1;
    copy_kernel<<<(unsigned)blocks, NT, 0, st>>>(src, n, vec, dst);
    return (int)cudaGetLastError();
  }
  // Tiles of up to TILE_WORDS words, WPT = ceil(tile / NT) words a thread
  // and the fewest 32-thread warps that cover the tile, where the rows fill
  // the card at such tiles; else a word a thread (the class planes: 101
  // rows), so the grid has more blocks.
  const bool wide = nl >= 32 && rows * ((W + TILE_WORDS - 1) / TILE_WORDS) >= target;
  const int64_t tiles = wide ? (W + TILE_WORDS - 1) / TILE_WORDS : (W + NT - 1) / NT;
  const int64_t tile = (W + tiles - 1) / tiles;
  const int wpt = wide ? (int)((tile + NT - 1) / NT) : 1;
  // a tile's source words: its bits, a word more at each block boundary
  // inside it, and one at each end
  int64_t span = tile + (32 * tile + nl - 1) / nl + 2;
  if (span > S * Wl) span = S * Wl;
  const StitchShape sh{src, dst, rows, S, nl, (int)Wl, (int)W, tiles, (int)tile,
                       (int)(((tile + wpt - 1) / wpt + 31) / 32 * 32), (int)span, dev, nsm, st};
  if (nl < 32) return (int)launch_stitch<SMALL_NL, 1>(sh);
  if (!wide) return (int)launch_stitch<DIRECT, 1>(sh);
  switch (wpt) {
    case 1: return (int)launch_stitch<STAGED, 1>(sh);
    case 2: return (int)launch_stitch<STAGED, 2>(sh);
    case 3: return (int)launch_stitch<STAGED, 3>(sh);
    default: return (int)launch_stitch<STAGED, 4>(sh);
  }
}
