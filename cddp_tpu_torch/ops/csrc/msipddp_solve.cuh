// Whole MSIPDDP solve: one thread runs the complete multiple-shooting
// interior-point solve of one instance.
//
// Replaces cddp_tpu/ops/pallas/mega_msipddp.py::make_ms_solve_kernel (:302)
// for box-only path stacks (m > 0), the quadratic cost and cold seeds, with
// the three barrier strategies and the three gap-closing rollouts. The
// Pallas kernel runs a tile of instances in lock step and freezes finished
// lanes with masks; here every thread follows its own control flow, which is
// the per-instance semantics of solvers/msipddp.py::_drive directly:
//
//   initial cost, merit, residuals and the one-entry filter; per iteration:
//     defect-aware condensed backward (Euler linearization A = I + dt Fx,
//       B = dt Fu; drift Vx + Vxx d with d = F - X[1:]; UNCLIPPED y/s and
//       rhat/s, unlike ipddp_step.cuh's condensation) with the
//       regularization retry, at most bp_bound attempts;
//     first-success line search over the alpha ladder: one rollout pass per
//       trial closes the segment gaps ((t+1) % seg == 0) with the nonlinear,
//       hybrid or dense rule and collects the fraction-to-boundary
//       feasibility of every dual step of the ladder as one bit mask; the
//       MSIPDDP filter rule (ip_filter.cuh) judges it;
//     on success: the trial written over the nominal with its first feasible
//       dual step, the filter entry, the sd-scaled convergence tests, then
//       the barrier update; on failure: filter restoration (more than five
//       entries or an invalid one) before regularization, then the barrier
//       update unless the regularization limit ends the solve.
//
// State (batch-last, [t][i][b]): X, U, Y, S, F, Lambda in and out, the
// control gains k, K and the costate gains k_lambda, K_lambda; with the
// hybrid rollout also the backward's Jacobians A, B at the nominal, which
// the gap closing reads. The costates and F are live solver state: a trial
// updates them and the next backward reads them. The constraint values G
// and the dual and slack gains are never stored: they are recomputed from
// (x, u), (y, s, mu) and the control gains where needed, one constraint row
// at a time, as the JAX kernel does. A trial only sums its cost, merit and
// violation; the accepted one is rolled again with writes, repeating the
// trial's arithmetic exactly. The filter (7 slots) lives in registers.
//
// Bound: latency. Per iteration each instance reads and writes its
// trajectories several times (one backward attempt reads 3 nx + nu + 2m and
// writes nu (1 + nx) + nx (1 + nx) values per step; each trial reads about
// 3 nx + nu (1 + nx) + 2m + nx (1 + nx) per step), with one thread's worth
// of memory-level parallelism. Blocks of 128 threads at most 128 registers
// in float32 keep four blocks (16 warps) on an SM. Staging the next step in
// shared memory as kernel 7 does (sweep_stage.cuh) measured slower here
// (PERF.md section 6), and is left out.
//
// TRACK (the `_track` launchers) is the tracking variant
// (mega_msipddp.py:304,321-342): step t's running reference is row t of the
// shared (N, nx) reference `refs` (models.cuh::running_ref) in every
// trial's running cost and in the backward sweep's lx; the terminal cost
// and its derivatives keep the goal.
#pragma once

#include "ip_filter.cuh"
#include "ipddp_step.cuh"
#include "models.cuh"

namespace cddp {

// Barrier strategies in mega_msipddp.STRATEGIES order, and rollout types.
constexpr int kMsAdaptive = 0, kMsMonotonic = 1, kMsIpopt = 2;
constexpr int kRollNonlinear = 0, kRollHybrid = 1, kRollDense = 2;
// Status codes (cddp_tpu_torch.solution.Status), written as floats.
constexpr int kMsMaxIter = 0, kMsOptimal = 1, kMsAcceptable = 2, kMsRegLimit = 3;

// Solver options baked into one launch (mega_msipddp.py::_solve_cfg).
template <typename T>
struct MsCfg {
  T tol, atol, reg0, reg_uf, reg_max, reg_min, f, f01, f03, f06, power, mu_min, min_ftb,
      tol_div10, tol_div100, armijo, mat, one_m_vat, mvfac, sqrt_atol, tol10, n_sd;
  T alphas[kMaxAlpha];
  int max_iterations, n_alpha, bp_bound, integrator, strategy, seg, rollout;

  static MsCfg from_host(const double* h, const double* alphas, const int* ints) {
    MsCfg c{};
    T* v[] = {&c.tol,       &c.atol,       &c.reg0,   &c.reg_uf, &c.reg_max, &c.reg_min,
              &c.f,         &c.f01,        &c.f03,    &c.f06,    &c.power,   &c.mu_min,
              &c.min_ftb,   &c.tol_div10,  &c.tol_div100, &c.armijo, &c.mat, &c.one_m_vat,
              &c.mvfac,     &c.sqrt_atol,  &c.tol10,  &c.n_sd};
    for (int i = 0; i < int(sizeof(v) / sizeof(v[0])); ++i) *v[i] = T(h[i]);
    c.max_iterations = ints[3];
    c.n_alpha = ints[4];
    for (int i = 0; i < c.n_alpha && i < kMaxAlpha; ++i) c.alphas[i] = T(alphas[i]);
    c.bp_bound = ints[5];
    c.integrator = ints[2];
    c.strategy = ints[6];
    c.seg = ints[7];
    c.rollout = ints[8];
    return c;
  }
};

// What one backward attempt reports besides the gains it writes.
template <typename T>
struct MsBack {
  T dv0, dv1, inf_du, inf_pr, inf_comp, step;
};

// The nominal's filter quantities (msipddp.py::_reset_filter_quantities)
// and the l1 norms of its duals and slacks (the sd scaling).
template <typename T>
struct MsReset {
  T merit, inf_pr, inf_comp, cv, yl1, sl1;
};

// What one line-search trial reports; with write also the new duals'
// complementarity residual and l1 norms.
template <typename T>
struct MsTrial {
  T J, sumlog, cvp, cvd, pr_max, def_max, comp_max, yl1, sl1;
  unsigned long long ymask;  // bit j: dual step alphas[j] passes everywhere
  bool sfeas, finite;
};

template <typename T, class Mdl, int M, bool TRACK>
struct MsSolver {
  static constexpr int NX = Mdl::NX, NU = Mdl::NU;
  const Consts<T, Mdl>& c;
  const BoxRows<T, M, NX, NU>& rows;
  const MsCfg<T>& cfg;
  const T* refs;
  T* X;
  T* U;
  T* Y;
  T* S;
  T* F;
  T* L;
  T* k;
  T* K;
  T* kl;
  T* Kl;
  T* Ab;
  T* Bb;
  size_t Bs;
  int b;
  int N;

  __device__ T& at(T* p, int t, int i, int I) const { return p[(size_t(t) * I + i) * Bs + b]; }
  __device__ T& at(T* p, int t, int i, int j, int I, int J) const {
    return p[((size_t(t) * I + i) * J + j) * Bs + b];
  }

  template <int D>
  __device__ void load(T* p, int t, T (&v)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = at(p, t, i, D);
  }

  template <int D>
  __device__ void store(T* p, int t, const T (&v)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) at(p, t, i, D) = v[i];
  }

  __device__ void linearize(const T (&x)[NX], const T (&u)[NU], T (&A)[NX][NX],
                            T (&Bm)[NX][NU]) const {
    T Fx[NX][NX], Fu[NX][NU];
    Mdl::fxfu(x, u, c.p, Fx, Fu);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) A[i][j] = c.dt * Fx[i][j] + (i == j ? T(1) : T(0));
#pragma unroll
      for (int j = 0; j < NU; ++j) Bm[i][j] = c.dt * Fu[i][j];
    }
  }

  __device__ T initial_cost() const {
    T J = T(0), x[NX], u[NU];
    for (int t = 0; t < N; ++t) {
      load(X, t, x);
      load(U, t, u);
      T rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
      J = J + running_cost(c, rf, x, u);
    }
    load(X, N, x);
    return J + terminal_cost(c, x);
  }

  // resetBarrierFilter's quantities of the nominal under mu.
  __device__ MsReset<T> reset(T mu, T cost) const {
    T sumlog = T(0), cvp = T(0), cvd = T(0), pr = T(0), def = T(0), comp = T(0);
    MsReset<T> o{};
    for (int t = 0; t < N; ++t) {
      T x[NX], u[NU], y[M], s[M], f[NX], xn[NX], G[M];
      load(X, t, x);
      load(U, t, u);
      load(Y, t, y);
      load(S, t, s);
      load(F, t, f);
      load(X, t + 1, xn);
      rows.shifted(x, u, G);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        sumlog = sumlog + dlog(s[r]);
        const T rp = G[r] + s[r];
        cvp = cvp + dabs(rp);
        pr = nan_max(pr, dabs(rp));
        comp = nan_max(comp, dabs(y[r] * s[r] - mu));
        o.yl1 = o.yl1 + dabs(y[r]);
        o.sl1 = o.sl1 + dabs(s[r]);
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const T d = f[i] - xn[i];
        cvd = cvd + dabs(d);
        def = nan_max(def, dabs(d));
      }
    }
    o.merit = cost - mu * sumlog;
    o.cv = cvp + cvd;
    o.inf_pr = nan_max(pr, def);
    o.inf_comp = comp;
    return o;
  }

  // Row r of the dual and slack gains at one step (the closed forms of
  // msipddp.py::_backward_pass, unclipped) from the row's nominal (y, s, G)
  // and the step's control gains; made and used a row at a time, so the
  // [M][NX] arrays are never all live.
  __device__ void gain_row(int r, T mu, T y, T s, T G, const T (&kt)[NU],
                           const T (&Kt)[NU][NX], T& ky, T (&Ky)[NX], T& ks,
                           T (&Ks)[NX]) const {
    const T ys_inv = y / s;
    const T pr = G + s;
    const T comp = y * s - mu;
    const T rhat = y * pr - comp;
    T temp = T(0);
#pragma unroll
    for (int l = 0; l < NU; ++l) temp = temp + rows.Gu[r][l] * kt[l];
    ky = (rhat + y * temp) / s;
    ks = -pr - temp;
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T guk = T(0);
#pragma unroll
      for (int l = 0; l < NU; ++l) guk = guk + rows.Gu[r][l] * Kt[l][j];
      Ky[j] = ys_inv * (rows.Gx[r][j] + guk);
      Ks[j] = -rows.Gx[r][j] - guk;
    }
  }

  // One backward attempt at regularization reg; writes k, K, k_lambda,
  // K_lambda (and A, B for the hybrid rollout). Returns ok (every step's
  // regularized condensed Quu finite and positive definite).
  __device__ bool backward(T reg, T mu, MsBack<T>& bs) const {
    T xN[NX], Vx[NX], Vxx[NX][NX];
    load(X, N, xN);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) s = s + (xN[j] - c.goal[j]) * (T(2) * c.Qf[i][j]);
      Vx[i] = s;
#pragma unroll
      for (int j = 0; j < NX; ++j) Vxx[i][j] = T(0.5) * (T(2) * c.Qf[i][j] + T(2) * c.Qf[j][i]);
    }
    bs = MsBack<T>{T(0), T(0), T(0), T(0), T(0), T(0)};
    T def = T(0);
    bool ok = true;
    for (int t = N - 1; t >= 0; --t) {
      T x[NX], u[NU], y[M], s[M], G[M], lam[NX], f[NX], xn[NX], A[NX][NX], Bm[NX][NU];
      load(X, t, x);
      load(U, t, u);
      load(Y, t, y);
      load(S, t, s);
      load(L, t, lam);
      load(F, t, f);
      load(X, t + 1, xn);
      rows.shifted(x, u, G);
      linearize(x, u, A, Bm);
      if (cfg.rollout == kRollHybrid) {
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j) at(Ab, t, i, j, NX, NX) = A[i][j];
#pragma unroll
          for (int j = 0; j < NU; ++j) at(Bb, t, i, j, NX, NU) = Bm[i][j];
        }
      }
      // Defects and the drift Vx + Vxx d; the costate gains.
      T d[NX], drift[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) d[i] = f[i] - xn[i];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + Vxx[i][j] * d[j];
        drift[i] = Vx[i] + a;
        at(kl, t, i, NX) = -lam[i] + drift[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) at(Kl, t, i, j, NX, NX) = T(0.5) * (Vxx[i][j] + Vxx[j][i]);
      }
      // Q-expansion (lxx = 2Q, luu = 2R, lux = 0).
      T Qx[NX], Qu[NU], Qxx[NX][NX], Qux[NU][NX], Quu[NU][NU], rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T lx = T(0), gy = T(0), ad = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) lx = lx + (x[j] - rf[j]) * (T(2) * c.Q[i][j]);
#pragma unroll
        for (int r = 0; r < M; ++r) gy = gy + y[r] * rows.Gx[r][i];
#pragma unroll
        for (int l = 0; l < NX; ++l) ad = ad + A[l][i] * drift[l];
        Qx[i] = (lx + gy) + ad;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T lu = T(0), gy = T(0), bd = T(0);
#pragma unroll
        for (int j = 0; j < NU; ++j) lu = lu + u[j] * (T(2) * c.R[i][j]);
#pragma unroll
        for (int r = 0; r < M; ++r) gy = gy + y[r] * rows.Gu[r][i];
#pragma unroll
        for (int l = 0; l < NX; ++l) bd = bd + Bm[l][i] * drift[l];
        Qu[i] = (lu + gy) + bd;
      }
      {
        T AtV[NX][NX], BtV[NU][NX];
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            T a = T(0);
#pragma unroll
            for (int l = 0; l < NX; ++l) a = a + A[l][i] * Vxx[l][j];
            AtV[i][j] = a;
          }
#pragma unroll
        for (int i = 0; i < NU; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            T a = T(0);
#pragma unroll
            for (int l = 0; l < NX; ++l) a = a + Bm[l][i] * Vxx[l][j];
            BtV[i][j] = a;
          }
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            T a = T(0);
#pragma unroll
            for (int l = 0; l < NX; ++l) a = a + AtV[i][l] * A[l][j];
            Qxx[i][j] = T(2) * c.Q[i][j] + a;
          }
#pragma unroll
        for (int i = 0; i < NU; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            T a = T(0);
#pragma unroll
            for (int l = 0; l < NX; ++l) a = a + BtV[i][l] * A[l][j];
            Qux[i][j] = T(0) + a;
          }
#pragma unroll
          for (int j = 0; j < NU; ++j) {
            T a = T(0);
#pragma unroll
            for (int l = 0; l < NX; ++l) a = a + BtV[i][l] * Bm[l][j];
            Quu[i][j] = T(2) * c.R[i][j] + a;
          }
        }
      }
      // Unclipped condensation (msipddp_solver.cpp:1330-1345).
      T ys_inv[M], pr[M], comp[M], sir[M];
#pragma unroll
      for (int r = 0; r < M; ++r) {
        ys_inv[r] = y[r] / s[r];
        pr[r] = G[r] + s[r];
        comp[r] = y[r] * s[r] - mu;
        const T rhat = y[r] * pr[r] - comp[r];
        sir[r] = rhat / s[r];
      }
      T GSGu[NU][NU], rhs_k[NU], rhs_K[NU][NX];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T a = T(0);
#pragma unroll
        for (int r = 0; r < M; ++r) a = a + sir[r] * rows.Gu[r][i];
        rhs_k[i] = Qu[i] + a;
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T g = T(0);
#pragma unroll
          for (int r = 0; r < M; ++r) g = g + rows.Gu[r][i] * (ys_inv[r] * rows.Gu[r][j]);
          GSGu[i][j] = g;
        }
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T g = T(0);
#pragma unroll
          for (int r = 0; r < M; ++r) g = g + rows.Gu[r][i] * (ys_inv[r] * rows.Gx[r][j]);
          rhs_K[i][j] = Qux[i][j] + g;
        }
      }
      // Joint [k | K] solve of sym(Quu) + G'SG + reg I, zero where the
      // finiteness or leading-minors check fails (linalg.solve_and_check).
      T H[NU][NU], Hinv[NU][NU], kt[NU], Kt[NU][NX];
      bool fin = true;
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          H[i][j] = (T(0.5) * (Quu[i][j] + Quu[j][i]) + GSGu[i][j]) + (i == j ? reg : T(0));
          fin = fin & isfinite(H[i][j]);
        }
      inverse<T, NU>(H, Hinv);
      const bool pd = leading_minors_pd<T, NU>(H) & fin;
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T a = T(0);
#pragma unroll
        for (int l = 0; l < NU; ++l) a = a + Hinv[i][l] * rhs_k[l];
        kt[i] = pd ? -a : T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T e = T(0);
#pragma unroll
          for (int l = 0; l < NU; ++l) e = e + Hinv[i][l] * rhs_K[l][j];
          Kt[i][j] = pd ? -e : T(0);
        }
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        at(k, t, i, NU) = kt[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) at(K, t, i, j, NU, NX) = Kt[i][j];
      }
      // Condensed expansions folded back: Qu_c = rhs_k, Qux_c = rhs_K.
      T Qx_c[NX], Qxx_c[NX][NX], Quu_c[NU][NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0);
#pragma unroll
        for (int r = 0; r < M; ++r) a = a + sir[r] * rows.Gx[r][i];
        Qx_c[i] = Qx[i] + a;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T g = T(0);
#pragma unroll
          for (int r = 0; r < M; ++r) g = g + rows.Gx[r][i] * (ys_inv[r] * rows.Gx[r][j]);
          Qxx_c[i][j] = Qxx[i][j] + g;
        }
      }
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j) Quu_c[i][j] = Quu[i][j] + GSGu[i][j];
      // dV step: [k' Qu_c, (Quu_c' (k / 2)) . k].
      T dv0 = T(0), dv1 = T(0);
#pragma unroll
      for (int i = 0; i < NU; ++i) dv0 = dv0 + kt[i] * rhs_k[i];
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T a = T(0);
#pragma unroll
        for (int i = 0; i < NU; ++i) a = a + Quu_c[i][j] * (T(0.5) * kt[i]);
        dv1 = dv1 + a * kt[j];
      }
      bs.dv0 = bs.dv0 + dv0;
      bs.dv1 = bs.dv1 + dv1;
      // Value update: Vx = Qx_c + K' Qu_c + Qux_c' k + (K' Quu_c) k,
      // Vxx = sym(Qxx_c + K' Qux_c + Qux_c' K + (K' Quu_c) K).
      T KtQ[NX][NU];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T a = T(0);
#pragma unroll
          for (int l = 0; l < NU; ++l) a = a + Kt[l][i] * Quu_c[l][j];
          KtQ[i][j] = a;
        }
      T Vxx_n[NX][NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0), q = T(0), e = T(0);
#pragma unroll
        for (int l = 0; l < NU; ++l) {
          a = a + Kt[l][i] * rhs_k[l];
          q = q + rhs_K[l][i] * kt[l];
          e = e + KtQ[i][l] * kt[l];
        }
        Vx[i] = Qx_c[i] + a + q + e;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T p = T(0), w = T(0), z = T(0);
#pragma unroll
          for (int l = 0; l < NU; ++l) {
            p = p + Kt[l][i] * rhs_K[l][j];
            w = w + rhs_K[l][i] * Kt[l][j];
            z = z + KtQ[i][l] * Kt[l][j];
          }
          Vxx_n[i][j] = Qxx_c[i][j] + p + w + z;
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) Vxx[i][j] = T(0.5) * (Vxx_n[i][j] + Vxx_n[j][i]);

#pragma unroll
      for (int i = 0; i < NU; ++i) {
        bs.inf_du = nan_max(bs.inf_du, dabs(rhs_k[i]));
        bs.step = nan_max(bs.step, dabs(kt[i]));
      }
#pragma unroll
      for (int r = 0; r < M; ++r) {
        bs.inf_pr = nan_max(bs.inf_pr, dabs(pr[r]));
        bs.inf_comp = nan_max(bs.inf_comp, dabs(comp[r]));
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) def = nan_max(def, dabs(d[i]));
      ok = ok & pd;
    }
    bs.inf_pr = nan_max(bs.inf_pr, def);
    return ok;
  }

  // One trial from x0 at step alpha (msipddp.py::_forward_pass). Without
  // write it collects the ladder's dual feasibility mask; with write it
  // takes the dual step a_du and replaces the nominal in place: every
  // nominal value of step t (and x_{t+1}) is read before step t writes.
  __device__ MsTrial<T> trial(T alpha, T a_du, T mu, bool write) const {
    const T tau = nan_max(cfg.min_ftb, T(1) - mu);
    MsTrial<T> o{};
    o.ymask = cfg.n_alpha >= 64 ? ~0ull : ((1ull << cfg.n_alpha) - 1ull);
    o.sfeas = true;
    o.finite = true;
    T x[NX], xb[NX];
    load(X, 0, x);
    load(X, 0, xb);
    for (int t = 0; t < N; ++t) {
      T ub[NU], y[M], s[M], fo[NX], lam[NX], xbn[NX], kt[NU], Kt[NU][NX], dx[NX];
      load(U, t, ub);
      load(Y, t, y);
      load(S, t, s);
      load(F, t, fo);
      load(L, t, lam);
      load(X, t + 1, xbn);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        kt[i] = at(k, t, i, NU);
#pragma unroll
        for (int j = 0; j < NX; ++j) Kt[i][j] = at(K, t, i, j, NU, NX);
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) dx[i] = x[i] - xb[i];

      // Per row: the slack step and its fraction-to-boundary test, and the
      // dual gain ky with Ky dx for the dual step below.
      T s_n[M], ky[M], kydx[M], u[NU], f_new[NX], xn[NX], lam_n[NX], g_n[M];
#pragma unroll
      for (int r = 0; r < M; ++r) {
        T Ky[NX], ks, Ks[NX];
        gain_row(r, mu, y[r], s[r], rows.shifted_row(r, xb, ub), kt, Kt, ky[r], Ky, ks, Ks);
        T a = T(0), d = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          a = a + Ks[j] * dx[j];
          d = d + Ky[j] * dx[j];
        }
        s_n[r] = (s[r] + alpha * ks) + a;
        kydx[r] = d;
        o.sfeas = o.sfeas & ftb_ok(s_n[r], s[r], tau);
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + Kt[i][j] * dx[j];
        u[i] = (ub[i] + alpha * kt[i]) + a;
      }
      integrate<T, Mdl>(cfg.integrator, x, u, c.p, c.dt, f_new);
      const int tp1 = t + 1;
      const bool boundary = cfg.seg > 1 && tp1 % cfg.seg == 0 && tp1 < N;
#pragma unroll
      for (int i = 0; i < NX; ++i) xn[i] = f_new[i];
      if (boundary && cfg.rollout == kRollNonlinear) {
#pragma unroll
        for (int i = 0; i < NX; ++i)
          xn[i] = (xbn[i] + (f_new[i] - fo[i])) + alpha * (fo[i] - xbn[i]);
      } else if (boundary && cfg.rollout == kRollHybrid) {
        // (A + B K) dx + alpha (B k + f_old - xb_next) at the nominal's
        // Jacobians, which the backward stored.
        T A[NX][NX], Bm[NX][NU];
#pragma unroll
        for (int i = 0; i < NX; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j) A[i][j] = at(Ab, t, i, j, NX, NX);
#pragma unroll
          for (int j = 0; j < NU; ++j) Bm[i][j] = at(Bb, t, i, j, NX, NU);
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T mdx = T(0), bk = T(0);
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            T bK = T(0);
#pragma unroll
            for (int l = 0; l < NU; ++l) bK = bK + Bm[i][l] * Kt[l][j];
            mdx = mdx + (A[i][j] + bK) * dx[j];
          }
#pragma unroll
          for (int l = 0; l < NU; ++l) bk = bk + Bm[i][l] * kt[l];
          xn[i] = (xbn[i] + mdx) + alpha * ((bk + fo[i]) - xbn[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + at(Kl, t, i, j, NX, NX) * dx[j];
        lam_n[i] = (lam[i] + alpha * at(kl, t, i, NX)) + a;
      }
      T rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
      o.J = o.J + running_cost(c, rf, x, u);
      rows.shifted(x, u, g_n);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        o.sumlog = o.sumlog + dlog(s_n[r]);
        const T rp = g_n[r] + s_n[r];
        o.cvp = o.cvp + dabs(rp);
        o.pr_max = nan_max(o.pr_max, dabs(rp));
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        const T d = f_new[i] - xn[i];
        o.cvd = o.cvd + dabs(d);
        o.def_max = nan_max(o.def_max, dabs(d));
        o.finite = o.finite & isfinite(xn[i]);
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) o.finite = o.finite & isfinite(u[i]);
      // The dual step: every rung's fraction-to-boundary test in this one
      // pass, or with write the chosen rung's duals.
      if (!write) {
        for (int j = 0; j < cfg.n_alpha; ++j) {
          bool feas = true;
#pragma unroll
          for (int r = 0; r < M; ++r) {
            const T yn = (y[r] + cfg.alphas[j] * ky[r]) + kydx[r];
            feas = feas & ftb_ok(yn, y[r], tau);
          }
          if (!feas) o.ymask &= ~(1ull << j);
        }
      } else {
        T y_n[M];
#pragma unroll
        for (int r = 0; r < M; ++r) {
          y_n[r] = (y[r] + a_du * ky[r]) + kydx[r];
          o.comp_max = nan_max(o.comp_max, dabs(y_n[r] * s_n[r] - mu));
          o.yl1 = o.yl1 + dabs(y_n[r]);
          o.sl1 = o.sl1 + dabs(s_n[r]);
        }
        store(U, t, u);
        store(Y, t, y_n);
        store(S, t, s_n);
        store(F, t, f_new);
        store(L, t, lam_n);
        store(X, t + 1, xn);
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        xb[i] = xbn[i];
        x[i] = xn[i];
      }
    }
    o.J = o.J + terminal_cost(c, x);
    return o;
  }

  // updateBarrierParameters (msipddp.py::_update_barrier): mu_new and
  // whether mu changed (which resets the filter).
  __device__ bool barrier(T mu, T metric, bool fp_success, T alpha_pr, T& mu_new) const {
    if (cfg.strategy == kMsMonotonic) {
      mu_new = nan_max(cfg.f * mu, cfg.mu_min);
      return true;
    }
    const T superlinear = dpow(mu, cfg.power);
    if (cfg.strategy == kMsIpopt) {
      const T cand = nan_max(nan_min(cfg.f * mu, superlinear), cfg.tol_div10);
      const bool changed = metric <= T(10) * mu;
      mu_new = changed ? cand : mu;
      return changed;
    }
    const T threshold = mu < T(1e-5) ? nan_max(metric * T(10), mu * T(100))
                                     : nan_max(cfg.f * mu, mu * T(2));
    const bool slow = fp_success && alpha_pr > T(0) && metric < T(1e-3);
    const T ratio = metric / mu;
    T factor = ratio < T(0.01) ? cfg.f01
                               : (ratio < T(0.1) ? cfg.f03 : (ratio < T(0.5) ? cfg.f06 : cfg.f));
    factor = mu > T(1e-12) ? factor : cfg.f;
    const T minls = nan_min(factor * mu, superlinear);
    const T cand = (slow && mu > cfg.tol) ? minls : nan_max(minls, cfg.tol_div100);
    const bool changed = metric <= threshold || slow;
    mu_new = changed ? cand : mu;
    return changed;
  }

  // IPOPT sd scaling of the dual infeasibility (msipddp.py::_scaled_inf_du).
  __device__ T scaled_inf_du(T inf_du, T yl1, T sl1) const {
    const T sd = nan_max((yl1 + sl1) / cfg.n_sd, T(100)) / T(100);
    return inf_du / sd;
  }
};

template <typename T, class Mdl, int M, bool TRACK>
__global__ void __launch_bounds__(kSolveThreads, solve_min_blocks<T>()) msipddp_solve_kernel(
    T* __restrict__ X, T* __restrict__ U, T* __restrict__ Y, T* __restrict__ S,
    T* __restrict__ F, T* __restrict__ L, T* __restrict__ k, T* __restrict__ K,
    T* __restrict__ kl, T* __restrict__ Kl, T* __restrict__ Ab, T* __restrict__ Bb,
    T* __restrict__ stats, const T* __restrict__ refs, const __grid_constant__ Consts<T, Mdl> c,
    const __grid_constant__ BoxRows<T, M, Mdl::NX, Mdl::NU> rows,
    const __grid_constant__ MsCfg<T> cfg, int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = B;
  const MsSolver<T, Mdl, M, TRACK> sv{c,  rows, cfg, refs, X,  U,  Y,  S,  F, L,
                                      k,  K,    kl,  Kl,   Ab, Bb, Bs, b,  N};

  T mu = stats[4 * Bs + b];
  T cost = sv.initial_cost();
  MsReset<T> r0 = sv.reset(mu, cost);
  T inf_pr = r0.inf_pr, inf_comp = r0.inf_comp;
  T yl1 = r0.yl1, sl1 = r0.sl1;
  Filter<T> filt;
  filt.clear();
  filt.accept(r0.merit, r0.cv);
  T reg = cfg.reg0, inf_du = T(0), step_norm = T(0), alpha_pr = T(1);
  // Work done, for the operation count of a roofline bound, by kind of
  // pass: backward attempts, line-search trials (with the dual ladder),
  // commits (the accepted trial's rewrite with one dual step) and nominal
  // resets (the initial one and each filter reset).
  int attempts = 0, trials = 0, commits = 0, resets = 1;
  int it = 0, status = kMsMaxIter;

  for (int iter = 0; iter < cfg.max_iterations; ++iter) {
    ++it;
    // Backward pass with regularization retry (msipddp.py:763-781).
    MsBack<T> bs;
    bool bp_limit = false;
    for (int attempt = 0; attempt < cfg.bp_bound; ++attempt) {
      const bool ok = sv.backward(reg, mu, bs);
      ++attempts;
      const T reg_next = ok ? reg : nan_min(reg * cfg.reg_uf, cfg.reg_max);
      const bool limit = !ok && reg_next >= cfg.reg_max;
      reg = reg_next;
      if (ok || limit) {
        bp_limit = limit;
        break;
      }
    }
    inf_pr = bs.inf_pr;
    inf_du = bs.inf_du;
    inf_comp = bs.inf_comp;
    step_norm = bs.step;
    if (bp_limit) {
      status = kMsRegLimit;
      break;
    }

    // First-success line search (msipddp.py:794-825).
    bool found = false;
    T a = T(1), a_du = T(1);
    MsTrial<T> tr{};
    for (int ia = 0; ia < cfg.n_alpha && !found; ++ia) {
      a = cfg.alphas[ia];
      tr = sv.trial(a, T(0), mu, false);
      ++trials;
      const bool any_y = tr.ymask != 0ull;
      a_du = cfg.alphas[any_y ? __ffsll(static_cast<long long>(tr.ymask)) - 1 : 0];
      const T tmerit = tr.J - mu * tr.sumlog;
      const T tcv = tr.cvp + tr.cvd;
      const bool accept = filt.ms_acceptable(tmerit, tcv, a * bs.dv0, cfg.armijo, cfg.mat,
                                             cfg.one_m_vat, cfg.mvfac);
      found = tr.sfeas && any_y && tr.finite && accept;
    }

    bool update = true, fp_success = found;
    if (found) {
      // Commit (msipddp.py:827-884): the trial over the nominal, the filter
      // entry, the convergence tests, the barrier update if not converged.
      const MsTrial<T> w = sv.trial(a, a_du, mu, true);
      ++commits;
      const T dJ = cost - tr.J;
      const T tmerit = tr.J - mu * tr.sumlog;
      filt.accept(tmerit, tr.cvp + tr.cvd);
      cost = tr.J;
      inf_pr = nan_max(tr.pr_max, tr.def_max);
      inf_comp = w.comp_max;
      yl1 = w.yl1;
      sl1 = w.sl1;
      alpha_pr = a;
      reg = nan_max(reg / cfg.reg_uf, cfg.reg_min);
      const T sdu = sv.scaled_inf_du(inf_du, yl1, sl1);
      const T metric = nan_max(nan_max(sdu, inf_pr), inf_comp);
      const bool conv_opt = metric <= cfg.tol;
      const bool conv_acc =
          (dabs(dJ) < cfg.atol && it > 10 && inf_pr < cfg.sqrt_atol && inf_comp < cfg.sqrt_atol) ||
          (it >= 1 && step_norm < cfg.tol10 && inf_pr < T(1e-4));
      status = conv_opt ? kMsOptimal : (conv_acc ? kMsAcceptable : status);
      if (conv_opt || conv_acc) break;
    } else {
      // Restoration before regularization (msipddp.py:886-908).
      const bool restore = filt.size() > 5 || filt.contains_invalid();
      if (restore) {
        filt.prune();
      } else {
        reg = nan_min(reg * cfg.reg_uf, cfg.reg_max);
        if (reg >= cfg.reg_max) {
          status = kMsRegLimit;
          update = false;
        }
      }
      if (!update) break;
    }

    // Barrier update with the filter reset (msipddp.py:485-551).
    const T sdu = sv.scaled_inf_du(inf_du, yl1, sl1);
    const T metric = nan_max(nan_max(sdu, inf_pr), inf_comp);
    T mu_new;
    if (sv.barrier(mu, metric, fp_success, alpha_pr, mu_new)) {
      const MsReset<T> rs = sv.reset(mu_new, cost);
      ++resets;
      filt.clear();
      filt.accept(rs.merit, rs.cv);
      inf_pr = rs.inf_pr;
      inf_comp = rs.inf_comp;
    }
    mu = mu_new;
  }

  const T vals[13] = {cost,      inf_pr,      inf_du,    inf_comp,   mu,
                      reg,       alpha_pr,    T(it),     T(status),  T(attempts),
                      T(trials), T(commits),  T(resets)};
#pragma unroll
  for (int i = 0; i < 13; ++i) stats[i * Bs + b] = vals[i];
}

template <typename T, class Mdl, int M, bool TRACK>
int launch_msipddp_solve(T* const* buf, const T* refs, const double* consts, const double* rows,
                         const double* cfg, const double* alphas, const int* ints,
                         cudaStream_t stream) {
  const int N = ints[0], B = ints[1];
  if (ints[4] > kMaxAlpha) return static_cast<int>(cudaErrorInvalidValue);
  const Consts<T, Mdl> c = Consts<T, Mdl>::from_host(consts);
  const auto r = BoxRows<T, M, Mdl::NX, Mdl::NU>::from_host(rows);
  const MsCfg<T> sc = MsCfg<T>::from_host(cfg, alphas, ints);
  const int blocks = (B + kSolveThreads - 1) / kSolveThreads;
  msipddp_solve_kernel<T, Mdl, M, TRACK><<<blocks, kSolveThreads, 0, stream>>>(
      buf[0], buf[1], buf[2], buf[3], buf[4], buf[5], buf[6], buf[7], buf[8], buf[9],
      buf[10], buf[11], buf[12], refs, c, r, sc, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// m (mega_ipddp.MS_BOX_ROWS): a control box (4), a state box (6) or both
// (10) on the unicycle, the control box (2) on the pendulum, the small
// models' control boxes but the acrobot's (goal form only: the bicycle's
// 4, the others' 2);
// the goal form and (TRACK true, suffix _track) the tracking form, whose
// `refs` is the shared (N, nx) reference (NULL and unread in the goal
// form). The kernel
// stages nothing in shared memory, so no instantiation has a shared-memory
// size to bound.
#define CDDP_MSIPDDP_SOLVE(MODEL, STRUCT, M, TRACK, SUFFIX)                            \
  extern "C" int CDDP_EXPORT(cddp_msipddp_solve_##MODEL##_m##M##SUFFIX)(               \
      scalar_t* X, scalar_t* U, scalar_t* Y, scalar_t* S, scalar_t* F, scalar_t* L,    \
      scalar_t* k, scalar_t* K, scalar_t* kl, scalar_t* Kl, scalar_t* A, scalar_t* Bm, \
      scalar_t* stats, const scalar_t* refs, const double* consts, const double* rows, \
      const double* cfg, const double* alphas, int N, int B, int integrator,           \
      int max_iterations, int n_alpha, int bp_bound, int strategy, int seg,            \
      int rollout, void* stream) {                                                     \
    scalar_t* buf[13] = {X, U, Y, S, F, L, k, K, kl, Kl, A, Bm, stats};                \
    const int ints[9] = {N,        B,        integrator, max_iterations, n_alpha,      \
                         bp_bound, strategy, seg,        rollout};                     \
    return cddp::launch_msipddp_solve<scalar_t, cddp::STRUCT, M, TRACK>(               \
        buf, refs, consts, rows, cfg, alphas, ints, static_cast<cudaStream_t>(stream)); \
  }                                                                                    \
  CDDP_REGISTER(cddp_msipddp_solve_##MODEL##_m##M##SUFFIX,                             \
                (cddp::msipddp_solve_kernel<scalar_t, cddp::STRUCT, M, TRACK>),        \
                cddp::kSolveThreads, 0)
