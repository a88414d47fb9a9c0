// The fixed-size filter of the interior-point whole-solve kernels.
//
// Counterpart of cddp_tpu/ops/pallas/mega_ipddp.py::_filter_accept and
// _filter_prune (shared there with mega_msipddp.py) and of the MSIPDDP
// acceptance rule mega_msipddp.py::_ms_filter_acceptable (:269), for one
// problem instance: the semantics of solvers/filter.py and
// solvers/msipddp.py::_is_filter_acceptable. Valid entries form a prefix in
// insertion order. Every loop has a compile-time trip count and every index
// is static, so the slots stay in registers.
#pragma once

#include "small_linalg.cuh"

namespace cddp {

constexpr int kFCap = 7;  // max_filter_size (5) + 2; MSIPDDP's 7 slots

template <typename T>
struct Filter {
  T m[kFCap], v[kFCap];
  bool ok[kFCap];

  __device__ void clear() {
#pragma unroll
    for (int i = 0; i < kFCap; ++i) {
      m[i] = T(INFINITY);
      v[i] = T(INFINITY);
      ok[i] = false;
    }
  }

  __device__ int size() const {
    int n = 0;
#pragma unroll
    for (int i = 0; i < kFCap; ++i) n += ok[i];
    return n;
  }

  // (merit, violation, nonempty) of the most recent entry.
  __device__ void back(T& mf, T& cv, bool& nonempty) const {
    mf = T(INFINITY);
    cv = T(INFINITY);
    nonempty = false;
#pragma unroll
    for (int i = 0; i < kFCap; ++i) {
      if (ok[i]) {
        mf = m[i];
        cv = v[i];
        nonempty = true;
      }
    }
  }

  // isFilterCandidateDominated: an entry dominates (mf, cv).
  __device__ bool dominated(T mf, T cv) const {
    bool d = false;
#pragma unroll
    for (int i = 0; i < kFCap; ++i) d = d | (ok[i] & (m[i] <= mf) & (v[i] <= cv));
    return d;
  }

  // filterContainsInvalidValues: a valid entry with a non-finite value.
  __device__ bool contains_invalid() const {
    bool bad = false;
#pragma unroll
    for (int i = 0; i < kFCap; ++i) bad = bad | (ok[i] & !(isfinite(m[i]) & isfinite(v[i])));
    return bad;
  }

  // acceptFilterEntry: reject a dominated candidate; otherwise drop the
  // entries it dominates (stable compaction) and append it. A full filter
  // whose entries all stay drops the candidate, as the fixed-size filter of
  // solvers/filter.py does.
  __device__ void accept(T mf, T cv) {
    bool keep[kFCap];
    int pos[kFCap], n = 0;
    const bool is_dominated = dominated(mf, cv);
#pragma unroll
    for (int i = 0; i < kFCap; ++i) {
      keep[i] = ok[i] & !((mf <= m[i]) & (cv <= v[i]));
      pos[i] = n;
      n += keep[i];
    }
    if (is_dominated) return;
    T nm[kFCap], nv[kFCap];
#pragma unroll
    for (int j = 0; j < kFCap; ++j) {
      T mj = T(INFINITY), vj = T(INFINITY);
#pragma unroll
      for (int i = 0; i < kFCap; ++i) {
        const bool sel = keep[i] & (pos[i] == j);
        mj = sel ? m[i] : mj;
        vj = sel ? v[i] : vj;
      }
      nm[j] = j == n ? mf : mj;
      nv[j] = j == n ? cv : vj;
    }
#pragma unroll
    for (int j = 0; j < kFCap; ++j) {
      m[j] = nm[j];
      v[j] = nv[j];
      ok[j] = j <= n;
    }
  }

  // pruneFilterToBestPoints: the min-violation entry, plus the min-merit
  // entry when distinct (1e-12); the first minimum wins ties.
  __device__ void prune() {
    bool nonempty = false;
    T bv_m = T(INFINITY), bv_v = T(INFINITY), bm_m = T(INFINITY), bm_v = T(INFINITY);
    bool have_v = false, have_m = false;
#pragma unroll
    for (int i = 0; i < kFCap; ++i) {
      if (!ok[i]) continue;
      nonempty = true;
      if (!have_v || v[i] < bv_v) {
        bv_v = v[i];
        bv_m = m[i];
        have_v = true;
      }
      if (!have_m || m[i] < bm_m) {
        bm_m = m[i];
        bm_v = v[i];
        have_m = true;
      }
    }
    if (!nonempty) return;
    const bool distinct = (dabs(bm_v - bv_v) > T(1e-12)) | (dabs(bm_m - bv_m) > T(1e-12));
    clear();
    m[0] = bv_m;
    v[0] = bv_v;
    ok[0] = true;
    if (distinct) {
      m[1] = bm_m;
      v[1] = bm_v;
      ok[1] = true;
    }
  }

  // MSIPDDPSolver::isFilterAcceptable (msipddp_solver.cpp:789-827): an empty
  // filter accepts; a dominated candidate is rejected; otherwise the
  // best-violation entry (the first minimum over the valid entries, argmin
  // semantics: a NaN wins, and with no finite minimum slot 0) is the
  // reference point of the Armijo branch, the tiny-violation pass and the
  // merit and violation improvements.
  __device__ bool ms_acceptable(T mf, T cv, T expected, T armijo, T mat, T one_m_vat,
                                T mvfac) const {
    if (size() == 0) return true;
    T best = ok[0] ? v[0] : T(INFINITY), bv_m = m[0];
#pragma unroll
    for (int i = 1; i < kFCap; ++i) {
      const T vi = ok[i] ? v[i] : T(INFINITY);
      if ((vi != vi && best == best) || vi < best) {
        best = vi;
        bv_m = m[i];
      }
    }
    const T bv_v = best;
    const bool viol_imp = cv < bv_v * one_m_vat;
    const bool merit_imp = mf < bv_m - mat * cv;
    const bool armijo_branch = (cv < mvfac) & (expected < T(0));
    const bool armijo_ok = mf < bv_m + armijo * expected;
    const bool tiny_ok = (cv < T(1e-6)) & (mf <= bv_m * T(1.0 + 1e-8));
    const bool verdict = armijo_branch ? armijo_ok : (tiny_ok | viol_imp | merit_imp);
    return !dominated(mf, cv) & verdict;
  }
};

}  // namespace cddp
