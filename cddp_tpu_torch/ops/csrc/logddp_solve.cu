// Whole LogDDP solve: one thread runs the complete relaxed log-barrier solve
// of one instance.
//
// Replaces cddp_tpu/ops/pallas/mega_logddp.py::make_log_solve_kernel (:192)
// for box-only path stacks, the quadratic cost and cold seeds. The
// Pallas kernel runs a tile of instances in lock step and freezes finished
// lanes with masks; here every thread follows its own control flow, which is
// the per-instance semantics of solvers/logddp.py::_drive directly:
//
//   cost0; for each iteration:
//     the nominal merit and violation refreshed under the current mu;
//     backward pass (Euler linearization A = I + dt Fx, B = dt Fu) with the
//       relaxed log-barrier's beta', beta'' of every box row folded into the
//       Q-expansion, the joint [k | K] solve with the leading-minors check,
//       and the regularization retry, at most bp_bound attempts; exhaustion
//       ends the solve at status 4 (the reference's quirk);
//     first-success line search over the alpha ladder, each trial judged by
//       the 4-branch (merit, violation) rule against the nominal point;
//     mu decays on success and grows x5 (capped at mu_initial) on failure;
//       the convergence and regularization-limit exits.
//
// X, U, k, K are the seeds on entry and the solution on exit, updated in
// place (batch-last, [t][i][b]). A trial only sums its cost, barrier cost and
// violation; the accepted one is rolled again with writes, repeating the
// trial's arithmetic exactly. The barrier rows read z = ub - g of the doubled
// box form (the lower sides are -inf and masked out), computed as the plain
// version computes them.
//
// Bound: latency. Each instance reads and writes its trajectories several
// times per iteration (the refresh reads 5 values per step, a backward
// attempt reads 5 and writes 8, a trial reads 13), and its working set
// (about 1 KB an instance) does not stay in L2 across a fleet. Every sweep
// stages step t+1's nominal values in shared memory with cp.async while it
// computes step t (sweep_stage.cuh::NominalStage), so no load waits just
// before its use. A register budget (blocks of 128 threads at 64, 72, 80
// or 96 registers) measured slower than these blocks of 256 threads at the
// compiler's choice (PERF.md, section 6).
//
// TRACK (the `_track` launchers) is the tracking variant
// (mega_logddp.py:194,209-230): step t's running reference is row t of the
// shared (N, nx) reference `refs` (models.cuh::running_ref) in every sweep's
// running cost and in the backward sweep's lx; the terminal cost and its
// derivatives keep the goal.
#include "ipddp_step.cuh"
#include "models.cuh"
#include "sweep_stage.cuh"

namespace cddp {

// Solver options baked into one launch (mega_logddp.py::_solve_cfg).
template <typename T>
struct LogCfg {
  T tol, atol, reg0, reg_uf, reg_max, reg_min, mu0, mu_f, mu_min, delta, two_delta,
      delta_sq, log_delta, armijo, mat, one_m_vat, max_viol, mvfac;
  T alphas[kMaxAlpha];
  int max_iterations, n_alpha, bp_bound, integrator;

  static LogCfg from_host(const double* h, const double* alphas, int max_iterations,
                          int n_alpha, int bp_bound, int integrator) {
    LogCfg c{};
    T* v[] = {&c.tol,   &c.atol,      &c.reg0,     &c.reg_uf,    &c.reg_max, &c.reg_min,
              &c.mu0,   &c.mu_f,      &c.mu_min,   &c.delta,     &c.two_delta,
              &c.delta_sq, &c.log_delta, &c.armijo, &c.mat,      &c.one_m_vat,
              &c.max_viol, &c.mvfac};
    for (int i = 0; i < int(sizeof(v) / sizeof(v[0])); ++i) *v[i] = T(h[i]);
    for (int i = 0; i < n_alpha && i < kMaxAlpha; ++i) c.alphas[i] = T(alphas[i]);
    c.max_iterations = max_iterations;
    c.n_alpha = n_alpha;
    c.bp_bound = bp_bound;
    c.integrator = integrator;
    return c;
  }
};

// Status codes (cddp_tpu_torch.solution.Status), written as floats.
constexpr int kLogMaxIter = 0, kLogOptimal = 1, kLogAcceptable = 2, kLogRegLimitNC = 3,
              kLogRegLimitConv = 4;

// (beta, beta', beta'') of the relaxed log-barrier (constraints/barrier.py
// beta_derivatives): the log branch for z > delta with the 1e-12 guard,
// the quadratic extension below.
template <typename T>
__device__ __forceinline__ void beta3(T z, const LogCfg<T>& cfg, T& b, T& b1, T& b2) {
  if (z > cfg.delta) {
    const T zl = nan_max(z, T(1e-12));
    b = -dlog(zl);
    b1 = T(-1) / zl;
    b2 = T(1) / (zl * zl);
  } else {
    const T term = (z - cfg.two_delta) / cfg.delta;
    b = T(0.5) * (term * term - T(1)) - cfg.log_delta;
    b1 = term / cfg.delta;
    b2 = T(1) / cfg.delta_sq;
  }
}

// One step's barrier rows: z = ub - g = -G of the doubled box form.
template <typename T, int M, int NX, int NU>
__device__ __forceinline__ void barrier_z(const BoxRows<T, M, NX, NU>& rows,
                                          const T (&x)[NX], const T (&u)[NU],
                                          T (&z)[M]) {
  rows.shifted(x, u, z);
#pragma unroll
  for (int r = 0; r < M; ++r) z[r] = -z[r];
}

template <typename T, class Mdl, int M, bool TRACK>
struct LogSolver {
  static constexpr int NX = Mdl::NX, NU = Mdl::NU;
  using Staged = NominalStage<T, NX, NU>;
  const Consts<T, Mdl>& c;
  const BoxRows<T, M, NX, NU>& rows;
  const LogCfg<T>& cfg;
  const T* refs;
  T* X;
  T* U;
  T* k;
  T* K;
  size_t Bs;
  int b;
  int N;
  Staged ns;

  __device__ T& at(T* p, int t, int i, int I) const { return p[(size_t(t) * I + i) * Bs + b]; }
  __device__ T& at(T* p, int t, int i, int j, int I, int J) const {
    return p[((size_t(t) * I + i) * J + j) * Bs + b];
  }

  template <int D>
  __device__ void load(T* p, int t, T (&v)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = at(p, t, i, D);
  }

  // mu * sum beta(z) over the rows, and the violation sum max(g - ub, 0).
  __device__ void barrier_cost(const T (&x)[NX], const T (&u)[NU], T mu, T& bc,
                               T& viol) const {
    T z[M], s = T(0);
    barrier_z<T, M, NX, NU>(rows, x, u, z);
    viol = T(0);
#pragma unroll
    for (int r = 0; r < M; ++r) {
      T bb, b1, b2;
      beta3(z[r], cfg, bb, b1, b2);
      s = s + bb;
      viol = viol + nan_max(-z[r], T(0));
    }
    bc = mu * s;
  }

  __device__ T initial_cost() const {
    T J = T(0), x[NX], u[NU];
    int stage = 0;
    ns.fetch(0, stage, false);
    for (int t = 0; t < N; ++t, stage ^= 1) {
      ns.advance(t + 1, t + 1 < N, stage, false);
      ns.st.get(stage, Staged::vX, x);
      ns.st.get(stage, Staged::vU, u);
      T rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
      J = J + running_cost(c, rf, x, u);
    }
    load(X, N, x);
    return J + terminal_cost(c, x);
  }

  // The nominal trajectory's barrier cost and violation under mu.
  __device__ void merit_terms(T mu, T& bc, T& cv) const {
    T x[NX], u[NU];
    bc = T(0);
    cv = T(0);
    int stage = 0;
    ns.fetch(0, stage, false);
    for (int t = 0; t < N; ++t, stage ^= 1) {
      ns.advance(t + 1, t + 1 < N, stage, false);
      ns.st.get(stage, Staged::vX, x);
      ns.st.get(stage, Staged::vU, u);
      T bct, vt;
      barrier_cost(x, u, mu, bct, vt);
      bc = bc + bct;
      cv = cv + vt;
    }
  }

  // One backward attempt at regularization reg; writes k, K. Returns ok
  // (every step's regularized Quu finite and positive definite).
  __device__ bool backward(T reg, T mu, T& dv0, T& inf_du) const {
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
    dv0 = T(0);
    inf_du = T(0);
    bool ok = true;
    int stage = 0;
    ns.fetch(N - 1, stage, false);
    for (int t = N - 1; t >= 0; --t, stage ^= 1) {
      ns.advance(t - 1, t > 0, stage, false);
      T x[NX], u[NU], Fx[NX][NX], Fu[NX][NU], A[NX][NX], Bm[NX][NU];
      ns.st.get(stage, Staged::vX, x);
      ns.st.get(stage, Staged::vU, u);
      Mdl::fxfu(x, u, c.p, Fx, Fu);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) A[i][j] = c.dt * Fx[i][j] + (i == j ? T(1) : T(0));
#pragma unroll
        for (int j = 0; j < NU; ++j) Bm[i][j] = c.dt * Fu[i][j];
      }
      // Barrier rows: dB/dg = -beta'(z) (upper side), beta''(z).
      T z[M], d1[M], d2[M];
      barrier_z<T, M, NX, NU>(rows, x, u, z);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        T bb, b1;
        beta3(z[r], cfg, bb, b1, d2[r]);
        d1[r] = -b1;
      }
      // Q-expansion (ops/kernels/riccati.py::q_expansion) plus the barrier
      // terms mu G' d1, mu G'(d2 G).
      T Qx[NX], Qu[NU], Qxx[NX][NX], Qux[NU][NX], Quu[NU][NU], rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T lx = T(0), av = T(0), g = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) lx = lx + (x[j] - rf[j]) * (T(2) * c.Q[i][j]);
#pragma unroll
        for (int l = 0; l < NX; ++l) av = av + A[l][i] * Vx[l];
#pragma unroll
        for (int r = 0; r < M; ++r) g = g + d1[r] * rows.Gx[r][i];
        Qx[i] = (lx + av) + mu * g;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T lu = T(0), bv = T(0), g = T(0);
#pragma unroll
        for (int j = 0; j < NU; ++j) lu = lu + u[j] * (T(2) * c.R[i][j]);
#pragma unroll
        for (int l = 0; l < NX; ++l) bv = bv + Bm[l][i] * Vx[l];
#pragma unroll
        for (int r = 0; r < M; ++r) g = g + d1[r] * rows.Gu[r][i];
        Qu[i] = (lu + bv) + mu * g;
      }
      {
        T AtV[NX][NX], BtV[NU][NX];
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
            T s = T(0), g = T(0);
#pragma unroll
            for (int l = 0; l < NX; ++l) s = s + AtV[i][l] * A[l][j];
#pragma unroll
            for (int r = 0; r < M; ++r) g = g + rows.Gx[r][i] * (d2[r] * rows.Gx[r][j]);
            Qxx[i][j] = (T(2) * c.Q[i][j] + s) + mu * g;
          }
#pragma unroll
        for (int i = 0; i < NU; ++i) {
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            T s = T(0), g = T(0);
#pragma unroll
            for (int l = 0; l < NX; ++l) s = s + BtV[i][l] * A[l][j];
#pragma unroll
            for (int r = 0; r < M; ++r) g = g + rows.Gu[r][i] * (d2[r] * rows.Gx[r][j]);
            Qux[i][j] = (T(0) + s) + mu * g;
          }
#pragma unroll
          for (int j = 0; j < NU; ++j) {
            T s = T(0), g = T(0);
#pragma unroll
            for (int l = 0; l < NX; ++l) s = s + BtV[i][l] * Bm[l][j];
#pragma unroll
            for (int r = 0; r < M; ++r) g = g + rows.Gu[r][i] * (d2[r] * rows.Gu[r][j]);
            Quu[i][j] = (T(2) * c.R[i][j] + s) + mu * g;
          }
        }
      }

      // Joint [k | K] solve of sym(Quu + reg I), zero on a failed check
      // (ops/linalg.py::solve_and_check).
      T H[NU][NU], Hinv[NU][NU], kt[NU], Kt[NU][NX];
      bool fin = true;
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          const T a = Quu[i][j] + (i == j ? reg : T(0));
          const T bt = Quu[j][i] + (i == j ? reg : T(0));
          H[i][j] = T(0.5) * (a + bt);
          fin = fin & isfinite(H[i][j]);
        }
      inverse<T, NU>(H, Hinv);
      const bool pd = leading_minors_pd<T, NU>(H) & fin;
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T s = T(0);
#pragma unroll
        for (int l = 0; l < NU; ++l) s = s + Hinv[i][l] * Qu[l];
        kt[i] = pd ? -s : T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T a = T(0);
#pragma unroll
          for (int l = 0; l < NU; ++l) a = a + Hinv[i][l] * Qux[l][j];
          Kt[i][j] = pd ? -a : T(0);
        }
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        at(k, t, i, NU) = kt[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) at(K, t, i, j, NU, NX) = Kt[i][j];
      }

      // Value update (ops/kernels/riccati.py::value_update).
      T d0 = T(0);
#pragma unroll
      for (int i = 0; i < NU; ++i) d0 = d0 + Qu[i] * kt[i];
      dv0 = dv0 + d0;
      T KtQ[NX][NU];
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T s = T(0);
#pragma unroll
          for (int l = 0; l < NU; ++l) s = s + Kt[l][i] * Quu[l][j];
          KtQ[i][j] = s;
        }
      T Vxx_n[NX][NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0), bq = T(0), d = T(0);
#pragma unroll
        for (int l = 0; l < NU; ++l) {
          a = a + KtQ[i][l] * kt[l];
          bq = bq + Qux[l][i] * kt[l];
          d = d + Kt[l][i] * Qu[l];
        }
        Vx[i] = Qx[i] + a + bq + d;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T p = T(0), q = T(0), w = T(0);
#pragma unroll
          for (int l = 0; l < NU; ++l) {
            p = p + KtQ[i][l] * Kt[l][j];
            q = q + Qux[l][i] * Kt[l][j];
            w = w + Kt[l][i] * Qux[l][j];
          }
          Vxx_n[i][j] = Qxx[i][j] + p + q + w;
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) Vxx[i][j] = T(0.5) * (Vxx_n[i][j] + Vxx_n[j][i]);
#pragma unroll
      for (int i = 0; i < NU; ++i) inf_du = nan_max(inf_du, dabs(Qu[i]));
      ok = ok & pd;
    }
    return ok;
  }

  // One trial from x0 at step alpha: cost, barrier cost and violation of the
  // closed-loop rollout u = U + alpha k + K (x - X). With write, the trial
  // replaces the nominal in place (the nominal x_{t+1} is read before it is
  // overwritten: it comes from the stage). Returns finiteness of every x
  // and u.
  __device__ bool trial(T alpha, T mu, bool write, T& J, T& bc, T& cv) const {
    T x[NX], xb[NX];
    load(X, 0, x);
    load(X, 0, xb);
    bool ok = true;
    J = T(0);
    bc = T(0);
    cv = T(0);
    int stage = 0;
    ns.fetch(0, stage, true);
    for (int t = 0; t < N; ++t, stage ^= 1) {
      ns.advance(t + 1, t + 1 < N, stage, true);
      T u[NU], xn[NX];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j)
          a = a + ns.st.get(stage, Staged::vK + i * NX + j) * (x[j] - xb[j]);
        u[i] = (ns.st.get(stage, Staged::vU + i) + alpha * ns.st.get(stage, Staged::vk + i)) + a;
      }
      T rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
      J = J + running_cost(c, rf, x, u);
      T bct, vt;
      barrier_cost(x, u, mu, bct, vt);
      bc = bc + bct;
      cv = cv + vt;
      integrate<T, Mdl>(cfg.integrator, x, u, c.p, c.dt, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) ok = ok & isfinite(xn[i]);
#pragma unroll
      for (int i = 0; i < NU; ++i) ok = ok & isfinite(u[i]);
      ns.st.get(stage, Staged::vX, xb);
      if (write) {
#pragma unroll
        for (int i = 0; i < NU; ++i) at(U, t, i, NU) = u[i];
#pragma unroll
        for (int i = 0; i < NX; ++i) at(X, t + 1, i, NX) = xn[i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    J = J + terminal_cost(c, x);
    return ok;
  }
};

template <typename T, class Mdl, int M, bool TRACK>
__global__ void __launch_bounds__(kThreads) logddp_solve_kernel(
    T* __restrict__ X, T* __restrict__ U, T* __restrict__ k, T* __restrict__ K,
    T* __restrict__ stats, const T* __restrict__ refs, const __grid_constant__ Consts<T, Mdl> c,
    const __grid_constant__ BoxRows<T, M, Mdl::NX, Mdl::NU> rows,
    const __grid_constant__ LogCfg<T> cfg, int N, int B) {
  extern __shared__ __align__(16) unsigned char cddp_smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = B;
  using Sv = LogSolver<T, Mdl, M, TRACK>;
  const Sv sv{c, rows, cfg, refs, X, U, k, K, Bs, b, N,
              typename Sv::Staged{Sv::Staged::Stage::make(cddp_smem), X, U, k, K, Bs, b}};

  T mu = cfg.mu0;
  T cost = sv.initial_cost();
  T bc, cv;
  sv.merit_terms(mu, bc, cv);
  T merit = cost + bc;
  T reg = cfg.reg0, inf_du = T(INFINITY), alpha_pr = T(1);
  // Work done, for the operation count of a roofline bound: backward
  // attempts and trajectory sweeps (trials and the accepted trial's
  // rewrite); the nominal refreshes are one per iteration.
  int attempts = 0, sweeps = 0;
  int it = 0, status = kLogMaxIter;

  for (int iter = 0; iter < cfg.max_iterations; ++iter) {
    ++it;
    // preIterationSetup: the nominal merit and violation under the current mu.
    sv.merit_terms(mu, bc, cv);
    merit = cost + bc;

    // Backward pass with regularization retry (logddp.py:296-319).
    T dv0 = T(0);
    bool bp_limit = false;
    for (int attempt = 0; attempt < cfg.bp_bound; ++attempt) {
      const bool ok = sv.backward(reg, mu, dv0, inf_du);
      ++attempts;
      const T reg_next = ok ? reg : nan_min(reg * cfg.reg_uf, cfg.reg_max);
      const bool limit = !ok && reg_next >= cfg.reg_max;
      reg = reg_next;
      if (ok || limit) {
        bp_limit = limit;
        break;
      }
    }
    if (bp_limit) {
      // Regularization exhaustion counts as converged (:216-222).
      status = kLogRegLimitConv;
      break;
    }

    // First-success line search (logddp_solver.cpp:666-698).
    bool found = false;
    T a = T(1), J = T(0), tbc = T(0), tcv = T(0);
    for (int ia = 0; ia < cfg.n_alpha && !found; ++ia) {
      a = cfg.alphas[ia];
      const bool fin = sv.trial(a, mu, false, J, tbc, tcv);
      ++sweeps;
      const T tm = J + tbc;
      const T expected = a * dv0;
      const bool br1 = tcv > cfg.max_viol;
      const bool acc1 = tcv < cfg.one_m_vat * cv;
      const bool br2 = nan_max(tcv, cv) < cfg.mvfac && expected < T(0);
      const bool acc2 = tm < merit + cfg.armijo * expected;
      const bool acc3 = tm < merit - cfg.mat * cv || tcv < cfg.one_m_vat * cv;
      found = fin && (br1 ? acc1 : (br2 ? acc2 : acc3));
    }

    if (found) {
      T Jw, bcw, cvw;
      sv.trial(a, mu, true, Jw, bcw, cvw);
      ++sweeps;
      const T tm = J + tbc;
      const T dJ = cost - J, dL = merit - tm;
      cost = J;
      merit = tm;
      cv = tcv;
      alpha_pr = a;
      reg = nan_max(reg / cfg.reg_uf, cfg.reg_min);
      mu = nan_max(mu * cfg.mu_f, cfg.mu_min);
      // Convergence (logddp_solver.cpp:232-259): metric = max(inf_du, cv).
      const bool conv_opt = nan_max(inf_du, cv) <= cfg.tol;
      const bool conv_acc = dabs(dJ) < cfg.atol && dabs(dL) < cfg.atol;
      status = conv_opt ? kLogOptimal : (conv_acc ? kLogAcceptable : status);
      if (conv_opt || conv_acc) break;
    } else {
      reg = nan_min(reg * cfg.reg_uf, cfg.reg_max);
      mu = nan_min(mu * T(5), cfg.mu0);
      if (reg >= cfg.reg_max) {
        status = kLogRegLimitNC;
        break;
      }
    }
  }

  const T vals[10] = {cost, cv, inf_du, mu, reg, alpha_pr, T(it), T(status),
                      T(attempts), T(sweeps)};
#pragma unroll
  for (int i = 0; i < 10; ++i) stats[i * Bs + b] = vals[i];
}

template <typename T, class Mdl>
constexpr int logddp_solve_smem() {
  return stage_bytes<T>(NominalStage<T, Mdl::NX, Mdl::NU>::kValues, kThreads);
}

template <typename T, class Mdl, int M, bool TRACK>
int launch_logddp_solve(T* const* buf, const T* refs, const double* consts, const double* rows,
                        const double* cfg, const double* alphas, const int* ints,
                        cudaStream_t stream) {
  const int N = ints[0], B = ints[1];
  if (ints[4] > kMaxAlpha) return static_cast<int>(cudaErrorInvalidValue);
  const Consts<T, Mdl> c = Consts<T, Mdl>::from_host(consts);
  const auto r = BoxRows<T, M, Mdl::NX, Mdl::NU>::from_host(rows);
  const LogCfg<T> sc = LogCfg<T>::from_host(cfg, alphas, ints[3], ints[4], ints[5], ints[2]);
  const int blocks = (B + kThreads - 1) / kThreads;
  const int smem = logddp_solve_smem<T, Mdl>();
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)logddp_solve_kernel<T, Mdl, M, TRACK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  logddp_solve_kernel<T, Mdl, M, TRACK><<<blocks, kThreads, smem, stream>>>(
      buf[0], buf[1], buf[2], buf[3], buf[4], refs, c, r, sc, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// m (mega_ipddp.BOX_ROWS): a control box (4), a state box (6) or both
// (10) on the unicycle, the control box (2) on the pendulum, the torque box
// (6) on the attitude trio (goal form only); the goal form
// and (TRACK true, suffix _track) the tracking form, whose `refs` is the
// shared (N, nx) reference (NULL and unread in the goal form).
#define CDDP_LOGDDP_SOLVE(MODEL, STRUCT, M, TRACK, SUFFIX)                             \
  extern "C" int CDDP_EXPORT(cddp_logddp_solve_##MODEL##_m##M##SUFFIX)(                \
      scalar_t* X, scalar_t* U, scalar_t* k, scalar_t* K, scalar_t* stats,             \
      const scalar_t* refs, const double* consts, const double* rows,                  \
      const double* cfg, const double* alphas, int N, int B, int integrator,           \
      int max_iterations, int n_alpha, int bp_bound, void* stream) {                   \
    scalar_t* buf[5] = {X, U, k, K, stats};                                            \
    const int ints[6] = {N, B, integrator, max_iterations, n_alpha, bp_bound};         \
    return cddp::launch_logddp_solve<scalar_t, cddp::STRUCT, M, TRACK>(                \
        buf, refs, consts, rows, cfg, alphas, ints, static_cast<cudaStream_t>(stream)); \
  }                                                                                    \
  CDDP_REGISTER(cddp_logddp_solve_##MODEL##_m##M##SUFFIX,                              \
                (cddp::logddp_solve_kernel<scalar_t, cddp::STRUCT, M, TRACK>),         \
                cddp::kThreads,      \
                (cddp::logddp_solve_smem<scalar_t, cddp::STRUCT>()))

CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 4, false, )
CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 6, false, )
CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 10, false, )
CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 4, true, _track)
CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 6, true, _track)
CDDP_LOGDDP_SOLVE(unicycle, Unicycle, 10, true, _track)
CDDP_LOGDDP_SOLVE(pendulum, Pendulum, 2, false, )
CDDP_LOGDDP_SOLVE(pendulum, Pendulum, 2, true, _track)
CDDP_LOGDDP_SOLVE(euler_attitude, EulerAttitude, 6, false, )
CDDP_LOGDDP_SOLVE(quaternion_attitude, QuaternionAttitude, 6, false, )
CDDP_LOGDDP_SOLVE(mrp_attitude, MrpAttitude, 6, false, )
static_assert(cddp::logddp_solve_smem<double, cddp::Unicycle>() <= 232448 &&
                  cddp::logddp_solve_smem<double, cddp::Pendulum>() <= 232448 &&
                  cddp::logddp_solve_smem<double, cddp::QuaternionAttitude>() <= 232448,
              "a block's staging must fit its shared memory");
