// Native sequential commit engine, the host-side engine behind the
// Scheduler's mode="native": the same sequential one-pod-at-a-time semantics
// as the per-pod scan of ops/assign.py, over the already-encoded columnar
// snapshot (api/snapshot.py ClusterArrays, host arrays), at C speed instead
// of per-pod Python plugin dispatch.  A copy of the JAX package's
// native/scheduler.cpp, its arithmetic unchanged.
//
// Float32 score arithmetic mirrors the device kernels op for op (same
// associativity, no FMA: build with -ffp-contract=off, as the kernels build
// with -fmad=false), so native, device and oracle paths return bit-identical
// decisions.
//
// Build: g++ -O2 -shared -fPIC -ffp-contract=off -o libscheduler.so scheduler.cpp
// (native/__init__.py builds it at first use into the package's _build/ and
// loads it with ctypes).

#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>
#include <limits>

namespace {

const float MAXS = 100.0f;

struct View {
  // dims
  int32_t N, P, R, T, K, D1, C, A1, A2, PT, B;
  // nodes
  const int32_t *alloc;     // [N,R]
  int32_t *used;            // [N,R] in/out
  const int32_t *node_dom;  // [K,N]
  uint8_t *ports_used;      // [N,PT] in/out
  // pods
  const int32_t *req;       // [P,R]
  const uint8_t *sf;        // [P,N] static feasibility
  const float *pref;        // [P,N] or null (PreferNoSchedule counts)
  const float *na_raw;      // [P,N] or null (preferred node affinity raw)
  const uint8_t *pod_valid; // [P]
  const uint8_t *nodesel;   // [P,N] or null (spread eligibility)
  const uint8_t *pod_ports; // [P,PT] or null
  // pairwise tables (null when disabled)
  const int32_t *term_key;  // [T]
  const float *m_pend;      // [T,P]
  float *counts;            // [T,D1] in/out
  float *anti_counts;       // [T,D1] in/out
  const int32_t *aff_terms;    // [P,A1]
  const int32_t *anti_terms;   // [P,A2]
  const int32_t *spread_terms; // [P,C]
  const int32_t *spread_skew;  // [P,C]
  const uint8_t *spread_hard;  // [P,C]
  const float *img;            // [P,N] ImageLocality static scores or null
  const int32_t *pref_t;       // [P,B] preferred interpod term ids or null
  const float *pref_w;         // [P,B] signed weights
  float *pref_own;             // [T,D1] in/out
  // config
  float w_fit, w_bal, w_taint, w_na, w_spread, w_img, w_interpod;
  float w_hard;  // hardPodAffinityWeight: committed required-affinity terms
  int32_t r0, r1;  // scored resource indices
  uint8_t enable_pairwise, enable_ports, enable_taint, enable_na, enable_img,
      enable_ip;
  // NodeResourcesFit scoringStrategy: 0 LeastAllocated, 1 MostAllocated,
  // 2 RequestedToCapacityRatio (shape points interpolated like np.interp)
  int32_t fit_strategy;
  int32_t n_shape;            // number of rtcr shape points (<= 8)
  float shape_x[8], shape_y[8];
};

inline float least_alloc(const int32_t *alloc_row, const int64_t *req_tot,
                         int r0, int r1) {
  float v0, v1;
  {
    float a = (float)alloc_row[r0], r = (float)req_tot[r0];
    v0 = a > 0.f ? std::fmax(0.0f, (a - r) * MAXS / a) : 0.0f;
  }
  {
    float a = (float)alloc_row[r1], r = (float)req_tot[r1];
    v1 = a > 0.f ? std::fmax(0.0f, (a - r) * MAXS / a) : 0.0f;
  }
  return (v0 + v1) / 2.0f;  // mean over the two scored resources
}

inline float most_alloc(const int32_t *alloc_row, const int64_t *req_tot,
                        int r0, int r1) {
  // most_allocated.go: 0 when alloc == 0 OR requested > alloc (no clamp)
  float v0, v1;
  {
    float a = (float)alloc_row[r0], r = (float)req_tot[r0];
    v0 = (a > 0.f && r <= a) ? r * MAXS / a : 0.0f;
  }
  {
    float a = (float)alloc_row[r1], r = (float)req_tot[r1];
    v1 = (a > 0.f && r <= a) ? r * MAXS / a : 0.0f;
  }
  return (v0 + v1) / 2.0f;
}

inline float interp_shape(float util, const float *xs, const float *ys,
                          int n) {
  // clamp outside, linear inside.  STRICT > on the upper clamp: at
  // util == xs[n-1] the JAX kernel (interp_shape_f32) and the oracle fall
  // through to the segment formula ys[n-2] + t*(ys[n-1]-ys[n-2]), which in
  // float32 does not round-trip to ys[n-1] for many y-pairs — early-returning
  // here would break three-engine bit-parity at exact-fit utilization.
  if (n <= 0) return 0.0f;
  if (util <= xs[0]) return ys[0];
  if (util > xs[n - 1]) return ys[n - 1];
  for (int i = 1; i < n; i++) {
    if (util <= xs[i]) {
      float t = (util - xs[i - 1]) / (xs[i] - xs[i - 1]);
      return ys[i - 1] + t * (ys[i] - ys[i - 1]);
    }
  }
  return ys[n - 1];
}

inline float rtcr(const int32_t *alloc_row, const int64_t *req_tot, int r0,
                  int r1, const float *xs, const float *ys, int n_shape) {
  // capacity == 0: the reference's resourceScoringFunction returns
  // rawScoringFunction(maxUtilization) — the shape score at 100% — not 0
  // (requested_to_capacity_ratio.go); mirrored by all engines.  This runs
  // once per node in the scoring hot loop, so utilization is folded to
  // 100 for the zero-capacity case instead of branching to a precomputed
  // constant.
  float v0, v1;
  {
    float a = (float)alloc_row[r0], r = (float)req_tot[r0];
    float util = a > 0.f ? r * 100.0f / a : 100.0f;
    v0 = interp_shape(util, xs, ys, n_shape) * (MAXS / 10.0f);
  }
  {
    float a = (float)alloc_row[r1], r = (float)req_tot[r1];
    float util = a > 0.f ? r * 100.0f / a : 100.0f;
    v1 = interp_shape(util, xs, ys, n_shape) * (MAXS / 10.0f);
  }
  return (v0 + v1) / 2.0f;
}

inline float fit_score_strategy(const View *v, const int32_t *alloc_row,
                                const int64_t *req_tot) {
  if (v->fit_strategy == 1) return most_alloc(alloc_row, req_tot, v->r0, v->r1);
  if (v->fit_strategy == 2)
    return rtcr(alloc_row, req_tot, v->r0, v->r1, v->shape_x, v->shape_y,
                v->n_shape);
  return least_alloc(alloc_row, req_tot, v->r0, v->r1);
}

inline float balanced(const int32_t *alloc_row, const int64_t *req_tot,
                      int r0, int r1) {
  float f[2];
  bool present[2];
  int idx[2] = {r0, r1};
  int cnt = 0;
  for (int j = 0; j < 2; j++) {
    float a = (float)alloc_row[idx[j]];
    present[j] = a > 0.f;
    f[j] = present[j] ? std::fmin(1.0f, (float)req_tot[idx[j]] / a) : 0.0f;
    if (present[j]) cnt++;
  }
  float n = (float)(cnt > 0 ? cnt : 1);
  float mean = (f[0] + f[1]) / n;
  float var = 0.f;
  for (int j = 0; j < 2; j++)
    if (present[j]) { float d = f[j] - mean; var += d * d; }
  var = var / n;
  return (1.0f - std::sqrt(var)) * MAXS;
}

}  // namespace

extern "C" int schedule_native(const View *v, int32_t *choices) {
  const int N = v->N, P = v->P, R = v->R, T = v->T, K = v->K, D1 = v->D1;
  const int D = D1 - 1;
  std::vector<int64_t> req_tot(R);
  std::vector<uint8_t> feasible(N);
  std::vector<float> spread_raw(v->enable_pairwise ? N : 0);
  std::vector<float> agg;  // [K, D1] per-pod symmetric-anti aggregation
  if (v->enable_pairwise) agg.resize((size_t)K * D1);
  std::vector<float> ip_raw(v->enable_ip ? N : 0);
  std::vector<float> agg_pref;  // [K, D1] symmetric preferred aggregation
  if (v->enable_ip) agg_pref.resize((size_t)K * D1);

  for (int p = 0; p < P; p++) {
    choices[p] = -1;
    if (!v->pod_valid[p]) continue;
    const int32_t *req = v->req + (size_t)p * R;
    const uint8_t *sf = v->sf + (size_t)p * N;

    // ---- pairwise per-pod precomputation ----
    float min_match[8];  // per spread constraint (C <= 8 enforced by wrapper)
    float total_any = 0.f;
    bool self_all = true, has_aff = false;
    if (v->enable_pairwise) {
      const uint8_t *elig = v->nodesel + (size_t)p * N;
      for (int c = 0; c < v->C; c++) {
        int t = v->spread_terms[(size_t)p * v->C + c];
        if (t < 0) { min_match[c] = 0.f; continue; }
        int k = v->term_key[t];
        const int32_t *dom = v->node_dom + (size_t)k * N;
        float mn = std::numeric_limits<float>::infinity();
        for (int n = 0; n < N; n++) {
          if (elig[n] && dom[n] < D) {
            float cval = v->counts[(size_t)t * D1 + dom[n]];
            if (cval < mn) mn = cval;
          }
        }
        min_match[c] = std::isinf(mn) ? 0.f : mn;
      }
      for (int a = 0; a < v->A1; a++) {
        int t = v->aff_terms[(size_t)p * v->A1 + a];
        if (t < 0) continue;
        has_aff = true;
        const float *row = v->counts + (size_t)t * D1;
        for (int d = 0; d < D; d++) total_any += row[d];
        if (!(v->m_pend[(size_t)t * P + p] > 0.f)) self_all = false;
      }
      // symmetric anti aggregation: agg[k][d] = sum_t(key==k) m[t,p]*anti[t][d]
      std::memset(agg.data(), 0, agg.size() * sizeof(float));
      for (int t = 0; t < T; t++) {
        float m = v->m_pend[(size_t)t * P + p];
        if (m == 0.f) continue;
        float *dst = agg.data() + (size_t)v->term_key[t] * D1;
        const float *src = v->anti_counts + (size_t)t * D1;
        for (int d = 0; d < D; d++) dst[d] += m * src[d];  // column D excluded
      }
      if (v->enable_ip) {
        std::memset(agg_pref.data(), 0, agg_pref.size() * sizeof(float));
        for (int t = 0; t < T; t++) {
          float m = v->m_pend[(size_t)t * P + p];
          if (m == 0.f) continue;
          float *dst = agg_pref.data() + (size_t)v->term_key[t] * D1;
          const float *src = v->pref_own + (size_t)t * D1;
          for (int d = 0; d < D; d++) dst[d] += m * src[d];
        }
      }
    }
    bool waiver = has_aff && total_any == 0.f && self_all;

    // ---- pass A: feasibility (+ raw spread score), maxima over feasible ----
    float max_pref = 0.f, max_na = 0.f, max_spread = 0.f;
    float ip_max = -std::numeric_limits<float>::infinity();
    float ip_min = std::numeric_limits<float>::infinity();
    bool any_feasible = false;
    for (int n = 0; n < N; n++) {
      bool ok = sf[n];
      if (ok) {
        const int32_t *al = v->alloc + (size_t)n * R;
        const int32_t *us = v->used + (size_t)n * R;
        for (int r = 0; r < R && ok; r++)
          if (req[r] != 0 && req[r] > al[r] - us[r]) ok = false;
      }
      if (ok && v->enable_ports) {
        const uint8_t *pp = v->pod_ports + (size_t)p * v->PT;
        const uint8_t *np_ = v->ports_used + (size_t)n * v->PT;
        for (int q = 0; q < v->PT && ok; q++)
          if (pp[q] && np_[q]) ok = false;
      }
      float raw = 0.f;
      if (v->enable_pairwise) {
        // spread
        for (int c = 0; c < v->C; c++) {
          int t = v->spread_terms[(size_t)p * v->C + c];
          if (t < 0) continue;
          int k = v->term_key[t];
          int d = v->node_dom[(size_t)k * N + n];
          bool has_key = d < D;
          float cval = v->counts[(size_t)t * D1 + d];
          if (has_key) raw += cval;
          if (v->spread_hard[(size_t)p * v->C + c]) {
            if (!has_key ||
                cval + 1.0f - min_match[c] >
                    (float)v->spread_skew[(size_t)p * v->C + c])
              ok = false;
          }
        }
        if (ok) {
          // required affinity
          bool all_ok = true;
          for (int a = 0; a < v->A1; a++) {
            int t = v->aff_terms[(size_t)p * v->A1 + a];
            if (t < 0) continue;
            int d = v->node_dom[(size_t)v->term_key[t] * N + n];
            if (d >= D || !(v->counts[(size_t)t * D1 + d] > 0.f)) all_ok = false;
          }
          if (!all_ok && !waiver) ok = false;
          // own anti
          for (int a = 0; a < v->A2 && ok; a++) {
            int t = v->anti_terms[(size_t)p * v->A2 + a];
            if (t < 0) continue;
            int d = v->node_dom[(size_t)v->term_key[t] * N + n];
            if (d < D && v->counts[(size_t)t * D1 + d] > 0.f) ok = false;
          }
          // existing pods' anti vs this pod
          if (ok) {
            float blocked = 0.f;
            for (int k = 0; k < K; k++) {
              int d = v->node_dom[(size_t)k * N + n];
              if (d < D) blocked += agg[(size_t)k * D1 + d];
            }
            if (blocked != 0.f) ok = false;
          }
        }
        spread_raw[n] = raw;
      }
      if (v->enable_ip) {
        // own preferred terms + existing pods' preferred terms toward p
        float r2 = 0.f;
        for (int b = 0; b < v->B; b++) {
          int t = v->pref_t[(size_t)p * v->B + b];
          if (t < 0) continue;
          int d = v->node_dom[(size_t)v->term_key[t] * N + n];
          if (d < D)
            r2 += v->pref_w[(size_t)p * v->B + b] * v->counts[(size_t)t * D1 + d];
        }
        for (int k = 0; k < K; k++) {
          int d = v->node_dom[(size_t)k * N + n];
          if (d < D) r2 += agg_pref[(size_t)k * D1 + d];
        }
        ip_raw[n] = r2;
      }
      feasible[n] = ok;
      if (ok) {
        any_feasible = true;
        if (v->enable_taint) {
          float c = v->pref[(size_t)p * N + n];
          if (c > max_pref) max_pref = c;
        }
        if (v->enable_na) {
          float c = v->na_raw[(size_t)p * N + n];
          if (c > max_na) max_na = c;
        }
        if (v->enable_pairwise && raw > max_spread) max_spread = raw;
        if (v->enable_ip) {
          if (ip_raw[n] > ip_max) ip_max = ip_raw[n];
          if (ip_raw[n] < ip_min) ip_min = ip_raw[n];
        }
      }
    }
    if (!any_feasible) continue;

    // ---- pass B: scores + first-max selection ----
    float best = -std::numeric_limits<float>::infinity();
    int best_n = -1;
    for (int n = 0; n < N; n++) {
      if (!feasible[n]) continue;
      const int32_t *al = v->alloc + (size_t)n * R;
      const int32_t *us = v->used + (size_t)n * R;
      for (int r = 0; r < R; r++) req_tot[r] = (int64_t)us[r] + req[r];
      float total = v->w_fit * fit_score_strategy(v, al, req_tot.data()) +
                    v->w_bal * balanced(al, req_tot.data(), v->r0, v->r1);
      if (v->enable_taint) {
        float c = v->pref[(size_t)p * N + n];
        float sc = max_pref > 0.f ? MAXS - MAXS * c / max_pref : MAXS;
        total = total + v->w_taint * sc;
      }
      if (v->enable_na) {
        float c = v->na_raw[(size_t)p * N + n];
        float sc = max_na > 0.f ? c * MAXS / max_na : 0.0f;
        total = total + v->w_na * sc;
      }
      if (v->enable_pairwise) {
        float sc = max_spread > 0.f ? MAXS - MAXS * spread_raw[n] / max_spread : MAXS;
        total = total + v->w_spread * sc;
      }
      if (v->enable_ip) {
        float sc = ip_max > ip_min
                       ? MAXS * (ip_raw[n] - ip_min) / (ip_max - ip_min)
                       : 0.0f;
        total = total + v->w_interpod * sc;
      }
      if (v->enable_img)
        total = total + v->w_img * v->img[(size_t)p * N + n];
      if (total > best) { best = total; best_n = n; }
    }
    if (best_n < 0) continue;
    choices[p] = best_n;

    // ---- commit ----
    int32_t *us = v->used + (size_t)best_n * R;
    for (int r = 0; r < R; r++) us[r] += req[r];
    if (v->enable_ports) {
      const uint8_t *pp = v->pod_ports + (size_t)p * v->PT;
      uint8_t *np_ = v->ports_used + (size_t)best_n * v->PT;
      for (int q = 0; q < v->PT; q++) np_[q] |= pp[q];
    }
    if (v->enable_pairwise) {
      for (int t = 0; t < T; t++) {
        float m = v->m_pend[(size_t)t * P + p];
        if (m != 0.f) {
          int d = v->node_dom[(size_t)v->term_key[t] * N + best_n];
          v->counts[(size_t)t * D1 + d] += m;
        }
      }
      for (int a = 0; a < v->A2; a++) {
        int t = v->anti_terms[(size_t)p * v->A2 + a];
        if (t < 0) continue;
        int d = v->node_dom[(size_t)v->term_key[t] * N + best_n];
        v->anti_counts[(size_t)t * D1 + d] += 1.0f;
      }
      if (v->enable_ip) {
        for (int b = 0; b < v->B; b++) {
          int t = v->pref_t[(size_t)p * v->B + b];
          if (t < 0) continue;
          int d = v->node_dom[(size_t)v->term_key[t] * N + best_n];
          v->pref_own[(size_t)t * D1 + d] += v->pref_w[(size_t)p * v->B + b];
        }
        if (v->w_hard != 0.f) {
          // committed pod's REQUIRED affinity terms at hardPodAffinityWeight
          for (int a = 0; a < v->A1; a++) {
            int t = v->aff_terms[(size_t)p * v->A1 + a];
            if (t < 0) continue;
            int d = v->node_dom[(size_t)v->term_key[t] * N + best_n];
            v->pref_own[(size_t)t * D1 + d] += v->w_hard;
          }
        }
      }
    }
  }
  return 0;
}
