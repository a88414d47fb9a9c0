// One condensed interior-point Riccati step for one problem instance, and
// the pieces the interior-point kernels share.
//
// Counterpart of cddp_tpu/ops/pallas/ipddp_riccati.py::ipddp_condense_lanes,
// ipddp_path_gain_lanes and ipddp_condensed_step_lanes (:73-212), shared by
// the streamed condensed backward (ipddp_backward.cu), the interior-point
// forward trial (ip_forward.cu) and the whole-solve kernel (ipddp_solve.cu):
// the Q-expansion with the dual term, the condensation
// Sigma = clip(y / s_safe, 0, cap), the regularized gain solve with its
// leading-minors positive-definiteness check, the closed-form dual and slack
// gains, the value update (ipddp_solver.cpp:1380-1509, iLQR Hessians), the
// box rows of a control/state box stack and the fraction-to-boundary test.
// The association of every sum follows the plain PyTorch version
// (ops/kernels/ipddp_riccati.py::condensed_step).
#pragma once

#include <cfloat>

#include "small_linalg.cuh"

namespace cddp {

constexpr double kEpsSlack = 1e-10;  // ipddp.EPS_SLACK
constexpr int kMaxAlpha = 64;        // the whole-solve kernels' alpha-ladder capacity
constexpr double kFtbSlop = 16.0;    // solvers/base.py FTB_SLOP_FACTOR

// Barrier-ratio clip (ipddp.py:64-73): 1e6 in float32, 1e12 in float64.
template <typename T>
__host__ __device__ constexpr T max_ratio();
template <>
__host__ __device__ constexpr float max_ratio<float>() { return 1e6f; }
template <>
__host__ __device__ constexpr double max_ratio<double>() { return 1e12; }

template <typename T>
__host__ __device__ constexpr T machine_eps();
template <>
__host__ __device__ constexpr float machine_eps<float>() { return FLT_EPSILON; }
template <>
__host__ __device__ constexpr double machine_eps<double>() { return DBL_EPSILON; }

// torch.clamp / jnp.clip: NaN propagates.
template <typename T>
__device__ __forceinline__ T clip(T v, T lo, T hi) {
  return nan_min(nan_max(v, lo), hi);
}

__device__ __forceinline__ float dlog(float v) { return logf(v); }
__device__ __forceinline__ double dlog(double v) { return log(v); }
__device__ __forceinline__ float dpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double dpow(double a, double b) { return pow(a, b); }

// Fraction-to-boundary re-check with the knife-edge slop (solvers/base.py
// ftb_ok): v_new > 0 and v_new >= (1 - tau) v_old - 16 eps (1 + |v_old| +
// |v_new|), eps the working type's machine epsilon.
template <typename T>
__device__ __forceinline__ bool ftb_ok(T vn, T vo, T tau) {
  const T slop = (T(kFtbSlop) * machine_eps<T>()) * (T(1) + dabs(vo) + dabs(vn));
  return (vn > T(0)) & (vn >= (T(1) - tau) * vo - slop);
}

// Rows of a box-only path stack, in stack order (ip_rollout.py::BoxRows):
// row r reads entry var[r] of [x; u] and is g = (bound - v) * scale (lower
// rows) or (v - bound) * scale (upper rows). Gx, Gu are the constant rows
// -scale / +scale of its Jacobian.
template <typename T, int MR, int NX, int NU>
struct BoxRows {
  int var[MR];
  bool upper[MR];
  T bound[MR];
  T sf[MR];
  T Gx[MR][NX];
  T Gu[MR][NU];

  static BoxRows from_host(const double* h) {
    BoxRows r{};
    for (int i = 0; i < MR; ++i) {
      r.var[i] = int(h[4 * i]);
      r.upper[i] = h[4 * i + 1] > 0.5;
      r.bound[i] = T(h[4 * i + 2]);
      r.sf[i] = T(h[4 * i + 3]);
      const T d = r.upper[i] ? r.sf[i] : -r.sf[i];
      for (int j = 0; j < NX; ++j) r.Gx[i][j] = r.var[i] == j ? d : T(0);
      for (int j = 0; j < NU; ++j) r.Gu[i][j] = r.var[i] == NX + j ? d : T(0);
    }
    return r;
  }

  __device__ __forceinline__ void eval(const T (&x)[NX], const T (&u)[NU],
                                       T (&g)[MR]) const {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      T v = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) v = var[r] == j ? x[j] : v;
#pragma unroll
      for (int j = 0; j < NU; ++j) v = var[r] == NX + j ? u[j] : v;
      g[r] = upper[r] ? (v - bound[r]) * sf[r] : (bound[r] - v) * sf[r];
    }
  }

  // The same rows as LogDDP's and MSIPDDP's plain drivers evaluate them:
  // G = g - ub of the doubled form (PathStacker.evaluate_shifted), g = +-v *
  // scale, ub = +-bound * scale.
  __device__ __forceinline__ T shifted_row(int r, const T (&x)[NX], const T (&u)[NU]) const {
    T v = T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) v = var[r] == j ? x[j] : v;
#pragma unroll
    for (int j = 0; j < NU; ++j) v = var[r] == NX + j ? u[j] : v;
    const T g = upper[r] ? v * sf[r] : -(v * sf[r]);
    const T ub = upper[r] ? bound[r] * sf[r] : -(bound[r] * sf[r]);
    return g - ub;
  }

  __device__ __forceinline__ void shifted(const T (&x)[NX], const T (&u)[NU],
                                          T (&G)[MR]) const {
#pragma unroll
    for (int r = 0; r < MR; ++r) G[r] = shifted_row(r, x, u);
  }
};

// A keep-out ball row (BallConstraint, constraints/path.py) of the
// whole-solve kernel's stack: g = scale (r^2 - ||x[:d] - c||^2) in the JAX
// kernel's order (mega_ipddp.py::box_g), its state-Jacobian row
// -2 scale (x[:d] - c) at the point (stack_Gx), a zero control-Jacobian row,
// and the state Hessian -2 scale I on the head dims. Host layout: d, r,
// scale, c[0..NX) (the center in its first d entries).
template <typename T, int NX>
struct BallRow {
  int d;
  T radius, sf;
  T c[NX];

  static BallRow from_host(const double* h) {
    BallRow b{};
    b.d = int(h[0]);
    b.radius = T(h[1]);
    b.sf = T(h[2]);
    for (int i = 0; i < NX; ++i) b.c[i] = T(h[3 + i]);
    return b;
  }

  __device__ __forceinline__ T g(const T (&x)[NX]) const {
    T q = T(0);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      if (i < d) {
        const T diff = x[i] - c[i];
        q = q + diff * diff;
      }
    }
    return sf * (radius * radius - q);
  }

  __device__ __forceinline__ void gx(const T (&x)[NX], T (&row)[NX]) const {
    const T s2 = T(-2) * sf;
#pragma unroll
    for (int i = 0; i < NX; ++i) row[i] = i < d ? s2 * (x[i] - c[i]) : T(0);
  }
};

// Per-row condensation quantities (ipddp.py::_condense_path).
template <typename T, int M>
struct Condensed {
  T ss[M], sigma[M], pr[M], comp[M], rhat[M], sir[M];
};

// The same quantities for one row.
template <typename T>
struct CondensedRow {
  T ss, sigma, pr, comp, rhat, sir;
};

template <typename T>
__device__ __forceinline__ CondensedRow<T> condense_row(T y, T s, T g, T mu) {
  constexpr T cap = max_ratio<T>();
  const T floor = nan_max(mu * T(1e-3), T(kEpsSlack));
  CondensedRow<T> c;
  c.ss = nan_max(s, floor);
  c.sigma = clip(y / c.ss, T(0), cap);
  c.pr = g + s;
  c.comp = y * s - mu;
  c.rhat = y * c.pr - c.comp;
  c.sir = clip(c.rhat / c.ss, -cap, cap);
  return c;
}

template <typename T, int M>
__device__ __forceinline__ void condense(const T (&y)[M], const T (&s)[M],
                                         const T (&g)[M], T mu, Condensed<T, M>& c) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const CondensedRow<T> r = condense_row(y[i], s[i], g[i], mu);
    c.ss[i] = r.ss;
    c.sigma[i] = r.sigma;
    c.pr[i] = r.pr;
    c.comp[i] = r.comp;
    c.rhat[i] = r.rhat;
    c.sir[i] = r.sir;
  }
}

// One row of the closed-form dual and slack gains: ky, Ky, ks, Ks of a
// constraint row with Jacobian rows (Gx, Gu), dual y and condensation c,
// from the control gains (k, K). The whole-solve kernels make and use the
// gains a row at a time, so the [M][NX] arrays are never all live.
template <typename T, int NX, int NU>
__device__ __forceinline__ void path_gain_row(T y, const CondensedRow<T>& c,
                                              const T (&Gx)[NX], const T (&Gu)[NU],
                                              const T (&k)[NU], const T (&K)[NU][NX], T& ky,
                                              T (&Ky)[NX], T& ks, T (&Ks)[NX]) {
  constexpr T cap = max_ratio<T>();
  T temp = T(0);
#pragma unroll
  for (int l = 0; l < NU; ++l) temp = temp + Gu[l] * k[l];
  ky = clip((c.rhat + y * temp) / c.ss, -cap, cap);
  ks = -c.pr - temp;
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    T guk = T(0);
#pragma unroll
    for (int l = 0; l < NU; ++l) guk = guk + Gu[l] * K[l][j];
    Ky[j] = clip(c.sigma * (Gx[j] + guk), -cap, cap);
    Ks[j] = -Gx[j] - guk;
  }
}

// Closed-form dual and slack gains from the control gains
// (ipddp.py::_path_gains).
template <typename T, int NX, int NU, int M>
__device__ __forceinline__ void path_gains(const T (&y)[M], const Condensed<T, M>& c,
                                           const T (&Gx)[M][NX], const T (&Gu)[M][NU],
                                           const T (&k)[NU], const T (&K)[NU][NX],
                                           T (&ky)[M], T (&Ky)[M][NX], T (&ks)[M],
                                           T (&Ks)[M][NX]) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const CondensedRow<T> r{c.ss[i], c.sigma[i], c.pr[i], c.comp[i], c.rhat[i], c.sir[i]};
    path_gain_row<T, NX, NU>(y[i], r, Gx[i], Gu[i], k, K, ky[i], Ky[i], ks[i], Ks[i]);
  }
}

// What one condensed step returns besides the path gains.
template <typename T, int NX, int NU>
struct IpStep {
  T k[NU];
  T K[NU][NX];
  T dv0, dv1;
  T qu_absmax, pr_absmax, comp_absmax;
  bool ok;
};

// One condensed Riccati step (ipddp.py::_condensed_step_math): reads the
// stage and the value function (Vx, Vxx) after step t, writes the control
// gains into o and the value function before step t over (Vx, Vxx). On a
// failed positive-definiteness check the control gains are zero, as
// linalg.solve_and_check gives them.
template <typename T, int NX, int NU, int M>
__device__ __forceinline__ void condensed_step(
    const T (&A)[NX][NX], const T (&Bm)[NX][NU], const T (&lx)[NX], const T (&lu)[NU],
    const T (&lxx)[NX][NX], const T (&luu)[NU][NU], const T (&lux)[NU][NX],
    const T (&y)[M], const T (&Gx)[M][NX], const T (&Gu)[M][NU],
    const Condensed<T, M>& c, T reg, T (&Vx)[NX], T (&Vxx)[NX][NX],
    IpStep<T, NX, NU>& o) {
  // Q-expansion with the dual term (ipddp_solver.cpp:1380-1395).
  T Qx[NX], Qu[NU], Qxx[NX][NX], Qux[NU][NX], Quu[NU][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T gy = T(0), av = T(0);
#pragma unroll
    for (int r = 0; r < M; ++r) gy = gy + Gx[r][i] * y[r];
#pragma unroll
    for (int l = 0; l < NX; ++l) av = av + A[l][i] * Vx[l];
    Qx[i] = lx[i] + gy + av;
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T gy = T(0), bv = T(0);
#pragma unroll
    for (int r = 0; r < M; ++r) gy = gy + Gu[r][i] * y[r];
#pragma unroll
    for (int l = 0; l < NX; ++l) bv = bv + Bm[l][i] * Vx[l];
    Qu[i] = lu[i] + gy + bv;
  }
  {
    T AtV[NX][NX], BtV[NU][NX];  // A' Vxx, B' Vxx
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) s = s + A[l][i] * Vxx[l][j];
        AtV[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) s = s + Bm[l][i] * Vxx[l][j];
        BtV[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) s = s + AtV[i][l] * A[l][j];
        Qxx[i][j] = lxx[i][j] + s;
      }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) s = s + BtV[i][l] * A[l][j];
        Qux[i][j] = lux[i][j] + s;
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) s = s + BtV[i][l] * Bm[l][j];
        Quu[i][j] = luu[i][j] + s;
      }
    }
  }

  // Condensation terms G' Sigma G and G' S^-1 rhat.
  T GSGu[NU][NU], GSGx_u[NU][NX], Gsir_u[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T s = T(0);
#pragma unroll
    for (int r = 0; r < M; ++r) s = s + Gu[r][i] * c.sir[r];
    Gsir_u[i] = s;
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      T a = T(0);
#pragma unroll
      for (int r = 0; r < M; ++r) a = a + Gu[r][i] * (c.sigma[r] * Gu[r][j]);
      GSGu[i][j] = a;
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T a = T(0);
#pragma unroll
      for (int r = 0; r < M; ++r) a = a + Gu[r][i] * (c.sigma[r] * Gx[r][j]);
      GSGx_u[i][j] = a;
    }
  }

  // Regularized condensed Quu, right-hand sides, gain solve.
  T H[NU][NU], rhs_k[NU], rhs_K[NU][NX];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j)
      H[i][j] = T(0.5) * (Quu[i][j] + Quu[j][i]) + GSGu[i][j] + (i == j ? reg : T(0));
    rhs_k[i] = Qu[i] + Gsir_u[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) rhs_K[i][j] = Qux[i][j] + GSGx_u[i][j];
  }
  T Hinv[NU][NU];
  inverse<T, NU>(H, Hinv);
  o.ok = leading_minors_pd<T, NU>(H);
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T s = T(0);
#pragma unroll
    for (int l = 0; l < NU; ++l) s = s + Hinv[i][l] * rhs_k[l];
    o.k[i] = o.ok ? -s : T(0);
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T a = T(0);
#pragma unroll
      for (int l = 0; l < NU; ++l) a = a + Hinv[i][l] * rhs_K[l][j];
      o.K[i][j] = o.ok ? -a : T(0);
    }
  }

  // Condensed expansions folded back (ipddp_solver.cpp:1488-1509):
  // Qu_c = rhs_k, Qux_c = rhs_K.
  T Qx_c[NX], Qxx_c[NX][NX], Quu_c[NU][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T s = T(0);
#pragma unroll
    for (int r = 0; r < M; ++r) s = s + Gx[r][i] * c.sir[r];
    Qx_c[i] = Qx[i] + s;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T a = T(0);
#pragma unroll
      for (int r = 0; r < M; ++r) a = a + Gx[r][i] * (c.sigma[r] * Gx[r][j]);
      Qxx_c[i][j] = Qxx[i][j] + a;
    }
  }
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) Quu_c[i][j] = Quu[i][j] + GSGu[i][j];

  // dV step: [k' Qu_c, (Quu_c' (k / 2)) . k].
  T dv0 = T(0), dv1 = T(0);
#pragma unroll
  for (int i = 0; i < NU; ++i) dv0 = dv0 + o.k[i] * rhs_k[i];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    T s = T(0);
#pragma unroll
    for (int i = 0; i < NU; ++i) s = s + Quu_c[i][j] * (T(0.5) * o.k[i]);
    dv1 = dv1 + s * o.k[j];
  }
  o.dv0 = dv0;
  o.dv1 = dv1;

  // Value update: Vx = Qx_c + K' Qu_c + Qux_c' k + (K' Quu_c) k,
  // Vxx = sym(Qxx_c + K' Qux_c + Qux_c' K + (K' Quu_c) K).
  T KtQ[NX][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      T s = T(0);
#pragma unroll
      for (int l = 0; l < NU; ++l) s = s + o.K[l][i] * Quu_c[l][j];
      KtQ[i][j] = s;
    }
  T Vxx_n[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T a = T(0), b = T(0), d = T(0);
#pragma unroll
    for (int l = 0; l < NU; ++l) {
      a = a + o.K[l][i] * rhs_k[l];
      b = b + rhs_K[l][i] * o.k[l];
      d = d + KtQ[i][l] * o.k[l];
    }
    Vx[i] = Qx_c[i] + a + b + d;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T p = T(0), q = T(0), w = T(0);
#pragma unroll
      for (int l = 0; l < NU; ++l) {
        p = p + o.K[l][i] * rhs_K[l][j];
        q = q + rhs_K[l][i] * o.K[l][j];
        w = w + KtQ[i][l] * o.K[l][j];
      }
      Vxx_n[i][j] = Qxx_c[i][j] + p + q + w;
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) Vxx[i][j] = T(0.5) * (Vxx_n[i][j] + Vxx_n[j][i]);

  T qm = T(0), pm = T(0), cm = T(0);
#pragma unroll
  for (int i = 0; i < NU; ++i) qm = nan_max(qm, dabs(rhs_k[i]));
#pragma unroll
  for (int r = 0; r < M; ++r) {
    pm = nan_max(pm, dabs(c.pr[r]));
    cm = nan_max(cm, dabs(c.comp[r]));
  }
  o.qu_absmax = qm;
  o.pr_absmax = pm;
  o.comp_absmax = cm;
}

}  // namespace cddp
