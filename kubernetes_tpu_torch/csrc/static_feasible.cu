// K1 ktt_static_feasible: sf[p, n] = 1 when pod p may go on node n before
// capacity is checked.
//
// Replaces the JAX package's ops/filters.py:81 static_feasible (with
// term_match :28, node_selection_ok_from :47, taints_ok :62 and
// nodename_ok :74), which its per-pod scan hoists at ops/assign.py:197-208.
// XLA evaluates the taint and selector tests there as f32 counting
// matmuls; here they are word operations, in two launches:
//
//   setup_kernel  everything along the node axis, into the wrapper's
//                 scratch (kept across calls): the term-match words
//                 tmw[s, w] (bit j: node 32w + j satisfies term s), then, a
//                 warp per (node word, taint word), the node-valid words
//                 nw[w], the OR of the word's nodes' hard taints orw[w, k]
//                 and the transposed taint words ttw[t, w] (bit j: node
//                 32w + j carries taint t), as class_hoist.cu's K7 set-up.
//                 No thread walks a label row.  Each block lists the set
//                 literals of every (term, expression) from one scan of the
//                 masks; when every ANY / NONE expression has at most
//                 LIST_CAP of them (a hostname pin sets a pool's few), a
//                 lane per node reads only those bytes of its row (the
//                 listed match).  Otherwise feasible.cuh match_tiles: a
//                 block packs the label rows of 32 nodes into words and a
//                 warp matches them against the packed masks.
//   rows_kernel   the [P, N] plane.  A thread owns 16 consecutive nodes (a
//                 half of a node word: its valid bits in a register) and
//                 walks its block's run of pods (the runs within one pod of
//                 each other, one wave of blocks) in chunks of up to 32,
//                 each chunk's flags, pins, term ids and toleration words
//                 (packed here by warp ballots, a warp a pod) staged in
//                 shared memory; per pod
//                   node_valid & pod_valid & no untolerated hard taint (the
//                   taints t of the word's nodes outside the pod's
//                   tolerations: ttw[t]) & (no selector | OR over the pod's
//                   terms of tmw[s]) & (no pin | the pin's bit)
//                 is a 16-bit mask, each bit widened to a byte by one
//                 multiply, and written as one 16-byte streaming store (a
//                 warp writes 512 contiguous bytes of the row).  When N %
//                 16 != 0 (or the plane is not 16-byte aligned) the bytes
//                 go out one by one.
//
// `base` is the first GLOBAL node id of the launch's nodes: 0 on one
// device, s * nl for node shard s of a mesh (parallel/sharded.py), since a
// nodeName pin is a global node id (the JAX package's my_nodes,
// ops/assign.py:189).
//
// `done` (a device word, or NULL) gates both launches: once it is set each
// returns at entry, so the gang fixpoint's queued per-pod iterations
// (ops/gang.py) stop that way without a host read.  Both grids are sized
// to the work (the row pass walks its chunks), so a gated call is two
// launches of a few blocks at small P.
//
// Bound on an H100: the output alone is P*N bytes (1.05 GB at the 50k x 20k
// shape, P=51200, N=20480), >= 0.31 ms at 3.35 TB/s: the row pass is
// write-bound.  At a wide label vocabulary the bytes any implementation
// must read are the masks and, of each label row, the literals some mask
// sets (gang_pinned: 2 of 5000, ~85 KB in all); reading the whole plane,
// as the packed match does, takes >= 9.2 us ([6144, 5000], 30.7 MB).
// Bit-packing the plane (kernel B6 of ROADMAP.md) would cut the write 8x
// and is later work.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

#include "feasible.cuh"

namespace {

constexpr int SETUP_NT = 256;
constexpr int SETUP_PER_SM = 4;  // set-up blocks per SM at most
constexpr int VEC = 16;          // nodes a row-pass thread owns: one 16-byte store a pod
constexpr int ROWS_NT = 256;
constexpr int POD_CHUNK = 32;    // pods staged at once
constexpr size_t POD_SMEM = 32768;  // the staged pods' bytes a block may take

// four bits -> four 0/1 bytes of a word: bit i of x lands at bit 8i, and
// no two partial products overlap
__device__ __forceinline__ uint32_t bytes_of(uint32_t x) { return (x * 0x00204081u) & 0x01010101u; }

// Listed literals: each (term, expression) of a valid kind with at most
// LIST_CAP set literals, then a node reads only those bytes of its row.
// The block lists them itself (a scan of the S x E masks), where there are
// at most LIST_SE_MAX pairs in at most LIST_SCAN_MAX mask bytes
// (bench/term_match.py times the listed match against the packed one,
// built with -DKTT_LIST_SCAN_MAX=0, at the cap).
constexpr int LIST_CAP = 32;
constexpr int LIST_SE_MAX = 64;
#ifndef KTT_LIST_SCAN_MAX
#define KTT_LIST_SCAN_MAX (1 << 18)
#endif
constexpr int64_t LIST_SCAN_MAX = KTT_LIST_SCAN_MAX;

__global__ void __launch_bounds__(SETUP_NT) setup_kernel(
    const uint8_t* __restrict__ node_valid,     // [N]
    const uint8_t* __restrict__ node_taint_ns,  // [N, T]
    const uint8_t* __restrict__ node_labels,    // [N, L]
    const uint8_t* __restrict__ sel_mask,       // [S, E, L]
    const int32_t* __restrict__ sel_kind,       // [S, E]
    int N, int W, int T, int TW, int S, int E, int L, MatchPlan plan,
    uint32_t* __restrict__ scratch,  // tmw [S, W], nw [W], orw [W, TW], ttw [32 TW, W]
    const int32_t* __restrict__ done) {
  if (done != nullptr && *done) return;
  extern __shared__ uint32_t match_sm[];
  uint32_t* tmw = scratch;
  uint32_t* nw = tmw + (int64_t)S * W;
  uint32_t* orw = nw + W;
  uint32_t* ttw = orw + (int64_t)W * TW;
  const int lane = threadIdx.x & 31;
  const int SE = S * E;
  bool listed = false;
  if (S > 0 && SE <= LIST_SE_MAX && (int64_t)SE * L <= LIST_SCAN_MAX) {
    int32_t* kinds = reinterpret_cast<int32_t*>(match_sm);  // [SE]
    int32_t* count = kinds + SE;                            // [SE]
    int32_t* lits = count + SE;                             // [SE, LIST_CAP]
    const int32_t kv = threadIdx.x < SE ? sel_kind[threadIdx.x] : 0;  // lands while the masks are scanned
    for (int i = threadIdx.x; i < SE; i += blockDim.x) count[i] = 0;
    __syncthreads();
    auto list = [&](int i) {
      const int se = i / L;
      const int slot = atomicAdd(&count[se], 1);
      if (slot < LIST_CAP) lits[se * LIST_CAP + slot] = i - se * L;
    };
    scan_set(sel_mask, SE * L, list, (const uint8_t*)nullptr, 0, list);
    for (int i = threadIdx.x; i < SE; i += blockDim.x) kinds[i] = i == threadIdx.x ? kv : sel_kind[i];
    __syncthreads();
    listed = true;
    for (int se = 0; se < SE; ++se)
      listed = listed && !((kinds[se] == KIND_ANY || kinds[se] == KIND_NONE) && count[se] > LIST_CAP);
    if (listed) {  // a warp per node word, a lane per node: its row's listed bytes
      const int warps = gridDim.x * (SETUP_NT / 32);
      for (int w = blockIdx.x * (SETUP_NT / 32) + (threadIdx.x >> 5); w < W; w += warps) {
        const int n = 32 * w + lane;
        const uint8_t* row = node_labels + (int64_t)(n < N ? n : 0) * L;
        for (int s = 0; s < S; ++s) {
          bool ok = n < N;
          for (int e = 0; e < E; ++e) {
            const int se = s * E + e, k = kinds[se];
            if (k == KIND_PAD) continue;
            if (k != KIND_ANY && k != KIND_NONE) {
              ok = false;
              break;
            }
            const int32_t* ls = lits + se * LIST_CAP;
            bool hit = false;
            for (int i = 0; ok && !hit && i < count[se]; i += 4) {
              uint32_t b = 0;
#pragma unroll
              for (int u = 0; u < 4; ++u) b |= i + u < count[se] ? row[ls[i + u]] : 0u;
              hit = b != 0;
            }
            ok = ok && expr_ok(k, hit);
          }
          const uint32_t bits = __ballot_sync(FULL_MASK, ok);
          if (lane == 0) tmw[(int64_t)s * W + w] = bits;
        }
      }
    }
  }
  if (S > 0 && !listed) {
    match_tiles<uint8_t>(node_labels, N, sel_mask, sel_kind, S, E, L, plan, match_sm, blockIdx.x, gridDim.x,
                         [&](int s, int w, int r0, int rows, bool ok) {
                           const uint32_t bits = __ballot_sync(FULL_MASK, ok && lane < rows) << r0;
                           if (lane == 0) {
                             uint32_t* o = tmw + (int64_t)s * W + w;
                             *o = r0 == 0 ? bits : (*o | bits);
                           }
                         });
  }
  const int64_t items = (int64_t)W * TW;
  const int64_t warps = (int64_t)gridDim.x * (SETUP_NT / 32);
  // the last blocks first: the first ones carry the listed match
  for (int64_t it = (int64_t)(gridDim.x - 1 - blockIdx.x) * (SETUP_NT / 32) + (threadIdx.x >> 5); it < items;
       it += warps) {
    const int w = (int)(it / TW), k = (int)(it % TW), n = 32 * w + lane;
    uint32_t tw = 0;  // this lane's node's taints 32k .. 32k + 31
    if (n < N)
      for (int b = 0; b < 32 && 32 * k + b < T; ++b)
        tw |= (uint32_t)(node_taint_ns[(int64_t)n * T + 32 * k + b] != 0) << b;
    if (k == 0) {
      const uint32_t v = __ballot_sync(FULL_MASK, n < N && node_valid[n]);
      if (lane == 0) nw[w] = v;
    }
    const uint32_t any = __reduce_or_sync(FULL_MASK, tw);
    if (lane == 0) orw[it] = any;
    uint32_t mine = 0;  // lane b keeps the word of taint 32k + b
    for (int b = 0; b < 32; ++b) {
      const uint32_t v = __ballot_sync(FULL_MASK, (tw >> b) & 1u);
      if (lane == b) mine = v;
    }
    ttw[(int64_t)(32 * k + lane) * W + w] = mine;
  }
}

// a staged pod: [0] flags (1 pod_valid, 2 has_sel), [1] the pin's local
// node id (-1 unset, -2 not among these nodes), [2, 2 + TT) its term ids,
// [2 + TT, 2 + TT + TW) its toleration words

__global__ void __launch_bounds__(ROWS_NT) rows_kernel(
    const uint8_t* __restrict__ pod_valid,     // [P]
    const uint8_t* __restrict__ pod_tol_ns,    // [P, T]
    const int32_t* __restrict__ pod_nodename,  // [P]
    const int32_t* __restrict__ pod_terms,     // [P, TT]
    const uint8_t* __restrict__ pod_has_sel,   // [P]
    const uint32_t* __restrict__ scratch,      // setup_kernel's words
    int P, int N, int W, int T, int TW, int TT, int S, int base, int chunk, bool vec,
    uint8_t* __restrict__ sf,  // [P, N]
    const int32_t* __restrict__ done) {
  if (done != nullptr && *done) return;
  extern __shared__ int32_t pods_sm[];
  const uint32_t* tmw = scratch;
  const uint32_t* nw = tmw + (int64_t)S * W;
  const uint32_t* orw = nw + W;
  const uint32_t* ttw = orw + (int64_t)W * TW;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int stride = 2 + TT + TW;
  const int n0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  const bool active = n0 < N;
  const int w = n0 >> 5, sh = n0 & 16, cnt = active ? min(VEC, N - n0) : 0;
  const uint32_t valid = active ? (nw[w] >> sh) & 0xffffu : 0u;
  const uint32_t orw0 = active ? orw[(int64_t)w * TW] : 0u;
  // block y walks its own run of pods, the runs within one pod of each other
  const int p_end = (int)((int64_t)(blockIdx.y + 1) * P / gridDim.y);
  for (int p0 = (int)((int64_t)blockIdx.y * P / gridDim.y); p0 < p_end; p0 += chunk) {
    const int rows = min(chunk, p_end - p0);
    __syncthreads();  // the previous chunk's reads of the staged pods are done
    for (int r = warp; r < rows; r += warps) {  // a warp a pod: its fields and its toleration words
      const int64_t p = p0 + r;
      int32_t* pod = pods_sm + r * stride;
      const uint8_t tol0 = lane < T ? pod_tol_ns[p * T + lane] : 0;  // loaded beside the fields
      for (int f = lane; f < 2 + TT; f += 32) {
        int32_t v;
        if (f == 0) {
          v = (pod_valid[p] ? 1 : 0) | (pod_has_sel[p] ? 2 : 0);
        } else if (f == 1) {
          // the pin is a GLOBAL node id; a node shard's launch numbers its
          // nodes from its first id `base` (the JAX package's my_nodes)
          const int pin = pod_nodename[p];
          v = pin == -1 ? -1 : ((pin >= base && pin - base < N) ? pin - base : -2);
        } else {
          v = pod_terms[p * TT + (f - 2)];
        }
        pod[f] = v;
      }
      for (int k = 0; k < TW; ++k) {
        const int t = 32 * k + lane;
        const uint32_t word = __ballot_sync(FULL_MASK, k == 0 ? tol0 != 0 : t < T && pod_tol_ns[p * T + t] != 0);
        if (lane == 0) pod[2 + TT + k] = (int32_t)word;
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int r = 0; r < rows; ++r) {
      const int32_t* pod = pods_sm + r * stride;
      const int flags = pod[0], pin = pod[1];
      uint32_t ok = (flags & 1) ? valid : 0u;
      if (ok) {
        uint32_t bad = 0u;  // the word's nodes carrying a taint the pod does not tolerate
        for (int k = 0; k < TW; ++k) {
          uint32_t m = (k == 0 ? orw0 : orw[(int64_t)w * TW + k]) & ~(uint32_t)pod[2 + TT + k];
          while (m) {
            const int t = __ffs(m) - 1;
            m &= m - 1;
            bad |= ttw[(int64_t)(32 * k + t) * W + w];
          }
        }
        ok &= ~(bad >> sh);
        if (pin != -1) ok &= (pin >= n0 && pin < n0 + VEC) ? 1u << (pin - n0) : 0u;
      }
      if (ok && (flags & 2)) {
        uint32_t any = 0u;
        for (int j = 0; j < TT; ++j) {
          const int s = pod[2 + j];
          if (s >= 0) any |= tmw[(int64_t)s * W + w];
        }
        ok &= any >> sh;
      }
      uint8_t* row = sf + (int64_t)(p0 + r) * N + n0;
      if (vec) {
        __stcs(reinterpret_cast<uint4*>(row),  // streaming: the plane is written once, read by the next kernel
               make_uint4(bytes_of(ok & 0xfu), bytes_of((ok >> 4) & 0xfu), bytes_of((ok >> 8) & 0xfu),
                          bytes_of((ok >> 12) & 0xfu)));
      } else {
        for (int k = 0; k < cnt; ++k) row[k] = (uint8_t)((ok >> k) & 1u);
      }
    }
  }
}

}  // namespace

// scratch: W (S + 1 + 33 TW) words (W = ceil(N / 32), TW = max(1,
// ceil(T / 32))) for tmw [S, W], nw [W], orw [W, TW], ttw [32 TW, W]
// (kernels.py keeps a buffer per card and stream); base: the first global
// node id of the nodes (the pin's); done (or NULL): the gate above; every
// pointer else is device memory
extern "C" int ktt_static_feasible(const void* node_valid, const void* node_taint_ns,
                                   const void* node_labels, const void* pod_valid,
                                   const void* pod_tol_ns, const void* pod_nodename,
                                   const void* pod_terms, const void* pod_has_sel,
                                   const void* sel_mask, const void* sel_kind, void* scratch, void* sf,
                                   const void* done, int P, int N, int T, int TT, int S, int E, int L, int base,
                                   void* stream) {
  static ktt::Occupancy setup_occ, rows_occ;
  static size_t setup_allowed[ktt::MAX_DEVICES] = {};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (P <= 0 || N <= 0) return (int)cudaGetLastError();
  const int W = (N + 31) / 32;
  const int TW = T > 32 ? (T + 31) / 32 : 1;  // T == 0 packs to one zero word
  const int32_t* dn = static_cast<const int32_t*>(done);
  const MatchPlan plan = match_plan(S, E, L);
  if (S > 0 && plan.smem == 0) return (int)cudaErrorInvalidValue;  // one label row's words exceed shared memory
  const size_t list_smem = S * E <= LIST_SE_MAX ? 4 * (size_t)S * E * (2 + LIST_CAP) : 0;
  const size_t setup_smem = S > 0 ? (plan.smem > list_smem ? plan.smem : list_smem) : 0;
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err = ktt::device_sms(&dev, &nsm);
  if (err == cudaSuccess) err = allow_smem(setup_kernel, dev, setup_smem, setup_allowed);
  if (err == cudaSuccess) err = ktt::blocks_per_sm(setup_occ, setup_kernel, dev, SETUP_NT, setup_smem, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int64_t work = S > 0 ? W : ((int64_t)W * TW + SETUP_NT / 32 - 1) / (SETUP_NT / 32);
  const int64_t cap = (int64_t)nsm * (per_sm < SETUP_PER_SM ? per_sm : SETUP_PER_SM);
  const unsigned setup_grid = (unsigned)(work < cap ? (work > 0 ? work : 1) : cap);
  uint32_t* sw = static_cast<uint32_t*>(scratch);
  setup_kernel<<<setup_grid, SETUP_NT, setup_smem, st>>>(
      static_cast<const uint8_t*>(node_valid), static_cast<const uint8_t*>(node_taint_ns),
      static_cast<const uint8_t*>(node_labels), static_cast<const uint8_t*>(sel_mask),
      static_cast<const int32_t*>(sel_kind), N, W, T, TW, S, E, L, plan, sw, dn);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int halves = (N + VEC - 1) / VEC;
  const unsigned gx = (unsigned)((halves + ROWS_NT - 1) / ROWS_NT);
  const int threads = ((halves + gx - 1) / gx + 31) / 32 * 32;  // the halves spread evenly over gx blocks
  const size_t pod_b = 4 * (size_t)(2 + TT + TW);
  const int chunk = POD_SMEM / pod_b < (size_t)POD_CHUNK ? (int)(POD_SMEM / pod_b > 0 ? POD_SMEM / pod_b : 1)
                                                         : POD_CHUNK;
  const size_t rows_smem = chunk * pod_b;
  err = ktt::blocks_per_sm(rows_occ, rows_kernel, dev, threads, rows_smem, &per_sm);
  if (err != cudaSuccess) return (int)err;
  const int64_t chunks = (P + chunk - 1) / chunk;
  int64_t ycap = (int64_t)nsm * per_sm / gx;  // one wave of blocks
  ycap = ycap < 1 ? 1 : (ycap < 65535 ? ycap : 65535);
  const unsigned gy = (unsigned)(chunks < ycap ? chunks : ycap);
  const bool vec = (N % VEC) == 0 && ((uintptr_t)sf & 15u) == 0;
  rows_kernel<<<dim3(gx, gy), threads, rows_smem, st>>>(
      static_cast<const uint8_t*>(pod_valid), static_cast<const uint8_t*>(pod_tol_ns),
      static_cast<const int32_t*>(pod_nodename), static_cast<const int32_t*>(pod_terms),
      static_cast<const uint8_t*>(pod_has_sel), sw, P, N, W, T, TW, TT, S, base, chunk, vec,
      static_cast<uint8_t*>(sf), dn);
  return (int)cudaGetLastError();
}
