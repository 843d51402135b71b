// Scalar fit test and score of one (request, node) pair, shared by the
// class-wave kernels (class_hoist.cu, wave_commit.cu, chunk_rounds.cu).
//
// The port of the JAX package's ops/filters.py:126 fit_ok and
// ops/scores.py:110-228 (LeastAllocated, MostAllocated,
// RequestedToCapacityRatio through interp_shape_f32, BalancedAllocation),
// op for op in the order of kubernetes_tpu_torch/ops/scores.py: the mean
// over the K scored resources is the sequential sum times f32(1/K), IEEE
// division and sqrtf, and the build passes -fmad=false.  fit_scan.cu keeps
// its own batched int4 form of the same arithmetic.
//
// int32 adds and subtractions wrap, as XLA's and torch's do: they go
// through uint32.

#pragma once

#include <math.h>
#include <stdint.h>

namespace ktt {

constexpr int SCORE_MAX_K = 8;
constexpr int SCORE_MAX_SHAPE = 16;
constexpr int SCORE_MAX_R = 32;

enum Strategy { LEAST_ALLOCATED = 0, MOST_ALLOCATED = 1, REQUESTED_TO_CAPACITY_RATIO = 2 };

struct ScoreParams {
  int k;                    // scored resources, 1..SCORE_MAX_K
  int idx[SCORE_MAX_K];     // their resource ids
  int strategy;
  int n_shape;
  float inv_k;              // f32(1/K)
  float fit_w;
  float bal_w;
  float xs[SCORE_MAX_SHAPE];  // RequestedToCapacityRatio shape points
  float ys[SCORE_MAX_SHAPE];
};

// host side: the parameters from the flat arrays the Python wrapper passes
// (ip = [k, strategy, n_shape, idx...], fp = [fit_w, bal_w, xs..., ys...])
inline ScoreParams make_score_params(const int* ip, const float* fp) {
  ScoreParams sp{};
  sp.k = ip[0];
  sp.strategy = ip[1];
  sp.n_shape = ip[2];
  for (int i = 0; i < SCORE_MAX_K; ++i) sp.idx[i] = i < sp.k ? ip[3 + i] : 0;
  sp.inv_k = 1.0f / (float)sp.k;
  sp.fit_w = fp[0];
  sp.bal_w = fp[1];
  for (int i = 0; i < SCORE_MAX_SHAPE; ++i) {
    sp.xs[i] = i < sp.n_shape ? fp[2 + i] : 0.0f;
    sp.ys[i] = i < sp.n_shape ? fp[2 + sp.n_shape + i] : 0.0f;
  }
  return sp;
}

inline bool score_params_ok(const ScoreParams& sp, int R) {
  if (sp.k < 1 || sp.k > SCORE_MAX_K || sp.n_shape < 1 || sp.n_shape > SCORE_MAX_SHAPE) return false;
  if (R < 1 || R > SCORE_MAX_R || sp.strategy < 0 || sp.strategy > 2) return false;
  for (int i = 0; i < sp.k; ++i)
    if (sp.idx[i] < 0 || sp.idx[i] >= R) return false;
  return true;
}

__device__ __forceinline__ int wadd(int a, int b) { return (int)((uint32_t)a + (uint32_t)b); }
__device__ __forceinline__ int wsub(int a, int b) { return (int)((uint32_t)a - (uint32_t)b); }

// ops/scores.py interp_shape_f32: descending segments, the first match wins
__device__ __forceinline__ float interp_shape(float util, const ScoreParams& sp) {
  const int n = sp.n_shape;
  float out = sp.ys[n - 1];
  for (int i = n - 1; i > 0; --i) {
    const float t = (util - sp.xs[i - 1]) / (sp.xs[i] - sp.xs[i - 1]);
    const float seg = sp.ys[i - 1] + t * (sp.ys[i] - sp.ys[i - 1]);
    if (util <= sp.xs[i]) out = seg;
  }
  if (util <= sp.xs[0]) out = sp.ys[0];
  return out;
}

// fit_ok: every resource r with req(r) != 0 has req(r) <= alloc(r) - used(r)
template <class Req, class Used, class Alloc>
__device__ __forceinline__ bool fit_ok(int R, Req req, Used used, Alloc alloc) {
  for (int r = 0; r < R; ++r) {
    const int q = req(r);
    if (q != 0 && !(q <= wsub(alloc(r), used(r)))) return false;
  }
  return true;
}

// The node-only part of a score: the scored resources' allocatable as f32
// and the f32 count of the present ones (alloc > 0, at least 1), which
// score_pre reads for every request scored against the node.  A kernel
// that scores many requests against one node (K4's class hoist) makes it
// once a node; the values are the ones score_flat makes for each pair.
struct ScoreNode {
  float fa[SCORE_MAX_K];
  float cntf;
};

// Compile-time forms: STRAT, the fit strategy, or -1 to read sp.strategy;
// KT, the number of scored resources (1..SCORE_MAX_K), or 0 to read sp.k.
// K4 builds a kernel for each strategy and small K, so it issues only the
// work of its own strategy and resources; the arithmetic, and its order,
// is the same in every form.
template <int KT>
__host__ __device__ constexpr int k_slots() { return KT > 0 ? KT : SCORE_MAX_K; }

template <int KT = 0, class Alloc>
__device__ __forceinline__ ScoreNode score_node(const ScoreParams& sp, Alloc alloc) {
  const int kk = KT > 0 ? KT : sp.k;
  ScoreNode nd;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < k_slots<KT>(); ++k) {
    nd.fa[k] = 0.0f;
    if (k < kk) {
      nd.fa[k] = (float)alloc(sp.idx[k]);
      cnt += nd.fa[k] > 0.0f ? 1 : 0;
    }
  }
  nd.cntf = (float)(cnt > 1 ? cnt : 1);
  return nd;
}

// fit_w * fit_score + bal_w * balanced_allocation of the requested vector
// fq[k] (usage + request of scored resource k, as f32) against the node nd
template <int STRAT = -1, int KT = 0>
__device__ __forceinline__ float score_pre(const ScoreParams& sp, const ScoreNode& nd, const float* fq) {
  const int strategy = STRAT >= 0 ? STRAT : sp.strategy;
  const int kk = KT > 0 ? KT : sp.k;
  float fit = 0.0f;
#pragma unroll
  for (int k = 0; k < k_slots<KT>(); ++k) {
    if (k < kk) {
      const float a = nd.fa[k], r = fq[k];
      float x;
      if (strategy == LEAST_ALLOCATED) {
        x = (a > 0.0f) ? fmaxf(0.0f, (a - r) * 100.0f / a) : 0.0f;
      } else if (strategy == MOST_ALLOCATED) {
        x = (a > 0.0f && r <= a) ? r * 100.0f / a : 0.0f;
      } else {
        const float util = (a > 0.0f) ? r * 100.0f / a : 100.0f;
        x = interp_shape(util, sp) * 10.0f;
      }
      fit = (k == 0) ? x : fit + x;
    }
  }
  fit = fit * sp.inv_k;
  float fr[SCORE_MAX_K];
  float fsum = 0.0f;
#pragma unroll
  for (int k = 0; k < k_slots<KT>(); ++k) {
    fr[k] = 0.0f;
    if (k < kk) {
      fr[k] = (nd.fa[k] > 0.0f) ? fminf(1.0f, fq[k] / nd.fa[k]) : 0.0f;
      fsum = (k == 0) ? fr[k] : fsum + fr[k];
    }
  }
  const float mean = fsum / nd.cntf;
  float var = 0.0f;
#pragma unroll
  for (int k = 0; k < k_slots<KT>(); ++k) {
    if (k < kk) {
      const float d = fr[k] - mean;
      const float sq = (nd.fa[k] > 0.0f) ? d * d : 0.0f;
      var = (k == 0) ? sq : var + sq;
    }
  }
  var = var / nd.cntf;
  const float bal = (1.0f - sqrtf(var)) * 100.0f;
  return sp.fit_w * fit + sp.bal_w * bal;
}

// fit_w * fit_score + bal_w * balanced_allocation of the requested vector
// q(r) (usage + request, already summed) against alloc(r)
template <int STRAT = -1, int KT = 0, class Q, class Alloc>
__device__ __forceinline__ float score_flat(const ScoreParams& sp, Q q, Alloc alloc) {
  const int kk = KT > 0 ? KT : sp.k;
  const ScoreNode nd = score_node<KT>(sp, alloc);
  float fq[SCORE_MAX_K];
#pragma unroll
  for (int k = 0; k < k_slots<KT>(); ++k) fq[k] = (k < kk) ? (float)q(sp.idx[k]) : 0.0f;
  return score_pre<STRAT, KT>(sp, nd, fq);
}

// packed plane bit test: bit n of row `row` (W words per row)
__device__ __forceinline__ bool bit_at(const uint32_t* plane, int64_t row, int W, int n) {
  return (__ldcg(plane + row * W + (n >> 5)) >> (n & 31)) & 1u;
}

}  // namespace ktt
