// Whole IPDDP solve: one thread runs the complete interior-point solve of
// one instance. The kernel template; ipddp_solve.cu instantiates it without
// terminal constraints and ipddp_solve_terminal.cu with them, so that nvcc
// compiles the two translation units in parallel.
//
// Replaces cddp_tpu/ops/pallas/mega_ipddp.py::make_solve_kernel (:555) for
// stacks of control and state boxes and, with the template argument BALL
// (the stack row of a keep-out ball, -1 for none), one keep-out ball; the
// quadratic cost, tracked costates, and with MT and PT the terminal
// constraints (see below). The
// Pallas kernel runs a tile of instances in lock step
// and freezes finished lanes with masks; here every thread follows its own
// control flow, which is the per-instance semantics of
// solvers/ipddp.py::_drive directly:
//
//   initial cost, merit, residuals; for each iteration:
//     condensed backward (Euler linearization A = I + dt Fx, B = dt Fu)
//       with the regularization retry, at most bp_bound attempts;
//     early convergence test;
//     fraction-to-boundary caps alpha_pr_max, alpha_du_max from the Newton
//       step's dS, dY (a linear rollout of the new gains);
//     first-success filter line search over the alpha ladder;
//     on success: barrier update (ADAPTIVE or MONOTONIC/IPOPT), the accepted
//       trial written over the nominal, filter update, convergence tests;
//     on failure: regularization increase and the acceptable/limit exits.
//
// A ball row is curved, and its variant carries the "auto" stall latch
// (mega_ipddp.py latch_traced, :595) as the JAX kernel traces it only for
// ball stacks: the ball's g and its state-Jacobian row are evaluated from
// each step's staged x (no device array holds them); the armed
// constraint-Hessian fold adds y_ball (-2 scale) to lxx's head diagonal
// before each condensed step; the armed slack SOC re-closes s := -g in each
// trial where fraction-to-boundary allows; the stall detector counts
// stalled commits; a failed line search drops the SOC near feasibility or
// arms the latch at the regularization limit far from it. The box variants
// (BALL = -1) compile none of it.
//
// State (batch-last, [t][i][b]): X, U, Y, S, G, Lambda in and out, the
// control gains k, K and the costate gains k_lambda, K_lambda. The dual and
// slack gains are never stored: the max-step sweep and every trial recompute
// them from (y, s, g, mu) and (k, K) at each step, one constraint row at a
// time (ipddp_step.cuh::path_gain_row), as the JAX kernel does. A trial only
// sums its cost, merit and residuals; the accepted one is rolled again with
// writes, repeating the trial's arithmetic exactly. The filter (7 slots,
// ip_filter.cuh) lives in registers.
//
// Bound: latency. Per iteration each instance reads and writes its
// trajectories several times (one backward attempt: 5 + 3m values read and
// 6 + nx + nx^2 written per step; each trial: 3m + nu (1 + nx) + nx^2 +
// 3 nx + nu read per step), each load dependent and just before its use.
// Two things hide it: the register budget (at most 128 a thread in float32,
// so four blocks of 128 threads share an SM, twice the warps of 186
// registers at 256 threads), and every sweep stages step t+1's nominal
// values in shared memory with cp.async while it computes step t
// (sweep_stage.cuh), so the loads are in flight without taking registers.
//
// TRACK (the `_track` launchers) is the tracking variant
// (mega_ipddp.py:556,608-609,731-732): step t's running reference is row t
// of the shared (N, nx) reference `refs` (models.cuh::running_ref) in every
// sweep's running cost and in the backward sweep's lx, read with the same
// step t as the staged nominal x (which a ball row's g and Jacobian read);
// the terminal cost and its derivatives keep the goal.
//
// MT > 0 (the `_ti{MT}` launchers) adds MT linear terminal inequalities
// A x_N <= b (mega_ipddp.py mT regime, :847-944, :1010-1030, :1621-1640,
// :1825-1880; solvers/ipddp.py::_terminal_value_fold and _terminal_trial):
// their slacks and duals S_T, Y_T are per-instance state, folded into the
// terminal value of every backward attempt, stepped in the fraction-to-
// boundary caps from the Newton rollout's dx_N, updated in each trial with
// gains taken at the old x_N and the trial's real dx_N, and counted in the
// merit, theta and residuals; with terminal constraints the filter starts
// with the initial point and a mu decrease reseeds it with the committed one.
// PT > 0 (`_te{PT}`) is the terminal equality x_N = target, PT = nx and
// H = I (TerminalEqualityConstraint), in the JAX kernel's form
// (mega_ipddp.py:1155-1520): the p+1 LQR variants share K and P, so one base
// sweep of the condensed LQR also carries Phi(N, t+1) and accumulates the
// Gramian W = sum Phi B Quu^-1 B' Phi', the sensitivity dx_N / dlambda is
// -W; a linear rollout of the base gains gives dx_N; the multiplier step
// solves the SVD-floored (small_linalg.cuh::jacobi_sv_minmax) five-scale
// Cholesky ladder (chol_solve) for the least-squares residual; and a second
// sweep with the combined terminal linear term writes the gains. The
// multipliers Lambda_T_eq are per-instance state; a trial steps them by
// alpha_pr and adds lambda . h_T to the merit and |h_T| to theta and inf_pr;
// a failed line search raises the regularization twice. Float64 rounds the
// inequality rows as the plain driver does; the equality variants round
// apart (the Gramian against the driver's p+1 sweeps). The constants A, b
// and the target are one read-only array beside Consts (TermArgs::c);
// MT = PT = 0 compiles none of it.
//
// Gn (a user Gauss-Newton residual lane, lanes.cuh; mega_ipddp.py:603,
// :647-720) makes the cost a lane's in place of the quadratic one: the
// running cost sum r^2, the terminal cost sum r_T^2 + extra, and in the
// backward lx = 2 Jx'r, lu = 2 Ju'r, lxx = 2 Jx'Jx, luu = 2 Ju'Ju, lux =
// 2 Ju'Jx at each step and Vx = 2 J_T'r_T + grad extra, Vxx = sym(2 J_T'J_T)
// at x_N, each residual Jacobian column by one forward-mode pass of the lane
// (lanes.cuh::Dual), as the JAX kernel's jax.jvp takes them. The columns
// are kept in local memory, each written once a step. The instances'
// parameters cp (n_cp, B) and the lane's constants are CostArgs (by value).
// Gn void (the quadratic cost) compiles none of it.
#pragma once

#include <type_traits>

#include "ip_filter.cuh"
#include "ipddp_step.cuh"
#include "lanes.cuh"
#include "models.cuh"
#include "sweep_stage.cuh"

namespace cddp {

// Solver options baked into one launch (mega_ipddp.py::_solve_cfg). The
// stall latch's words (mega_ipddp.py::_make_cfg): soc_auto and chess_auto
// ("auto" slack SOC and constraint-Hessian fold), soc_stall (stalled
// commits that arm it) and far (100 tol, the detector's "far from
// feasibility" bar).
template <typename T>
struct IpCfg {
  T tol, atol, reg0, reg_uf, reg_max, reg_min, f, f01, f03, f06, power,
      mu_floor_adaptive, mu_min, min_ftb, btm, dual_weight, kappa_eps, armijo, mat,
      one_m_vat, max_viol, mvfac, sqrt_atol, barrier_accept_tol, tol10, fail_accept, far;
  T alphas[kMaxAlpha];
  int max_iterations, n_alpha, bp_bound, integrator, adaptive, theta_l2, f_max, soc_auto,
      chess_auto, soc_stall;

  // ints: integrator, max_iterations, n_alpha, bp_bound, adaptive, theta_l2,
  // f_max, soc_auto, chess_auto, soc_stall.
  static IpCfg from_host(const double* h, const double* alphas, const int* ints) {
    IpCfg c{};
    T* v[] = {&c.tol, &c.atol, &c.reg0, &c.reg_uf, &c.reg_max, &c.reg_min, &c.f,
              &c.f01, &c.f03, &c.f06, &c.power, &c.mu_floor_adaptive, &c.mu_min,
              &c.min_ftb, &c.btm, &c.dual_weight, &c.kappa_eps, &c.armijo, &c.mat,
              &c.one_m_vat, &c.max_viol, &c.mvfac, &c.sqrt_atol,
              &c.barrier_accept_tol, &c.tol10, &c.fail_accept, &c.far};
    for (int i = 0; i < int(sizeof(v) / sizeof(v[0])); ++i) *v[i] = T(h[i]);
    int* n[] = {&c.integrator, &c.max_iterations, &c.n_alpha, &c.bp_bound, &c.adaptive,
                &c.theta_l2, &c.f_max, &c.soc_auto, &c.chess_auto, &c.soc_stall};
    for (int i = 0; i < int(sizeof(n) / sizeof(n[0])); ++i) *n[i] = ints[i];
    for (int i = 0; i < c.n_alpha && i < kMaxAlpha; ++i) c.alphas[i] = T(alphas[i]);
    return c;
  }
};

// Status codes (cddp_tpu_torch.solution.Status), written as floats.
constexpr int kIpMaxIter = 0, kIpOptimal = 1, kIpAcceptable = 2, kIpRegLimit = 3;

// What one backward attempt reports besides the gains it writes.
template <typename T>
struct BackStats {
  T dv0, dv1, inf_du, inf_pr, inf_comp, step;
};

// What one line-search trial reports.
template <typename T>
struct TrialOut {
  T J, sumlog, theta, inf_pr, inf_comp, inf_comp_new;
  bool ok;
};

// With terminal constraints also the terminal slacks' sum of logs and
// lambda_T . h_T.
template <typename T>
struct TermTrialOut : TrialOut<T> {
  T sumlog_T, lam_h;
};

// The terminal constraints' kernel arguments: the constants c (A (MT, nx)
// row-major, b (MT), target (PT)), the per-instance state S_T, Y_T (MT, B)
// and Lambda_T_eq (PT, B), batch-last, in and out, the last backward's
// multiplier step dL (PT, B), scratch, and the terminal equality's
// multiplier-ladder floor (jacobian_regularization value and exponent).
// Empty without terminal constraints, so that those variants' parameters,
// and their code, are what they were before terminal constraints.
template <typename T, int MT, int PT>
struct TermArgs {
  const T* c;
  T* ST;
  T* YT;
  T* Lte;
  T* dL;
  T jac_val, jac_exp;
};
template <typename T>
struct TermArgs<T, 0, 0> {};

constexpr double kEpsDual = 1e-10;  // ipddp.EPS_DUAL

template <typename T, class Mdl, int M, int BALL, bool TRACK, int MT = 0, int PT = 0,
          class Gn = void>
struct IpSolver {
  static constexpr int NX = Mdl::NX, NU = Mdl::NU;
  static constexpr bool kBall = BALL >= 0;
  static constexpr bool kTerm = MT > 0 || PT > 0;
  static constexpr bool kGn = !std::is_void_v<Gn>;
  static_assert(!kGn || (!kBall && !TRACK && !kTerm),
                "a GN lane's kernel takes a box stack, the goal form, no terminal rows");
  static_assert(PT == 0 || PT == NX, "the terminal equality is x_N = target: PT = nx");
  static_assert(PT == 0 || BALL < 0, "the terminal equality takes box stacks");
  // Staged values of one step (sweep_stage.cuh): Y, S, G, U always; X[t]
  // (backward, max-step sweep) or the nominal X[t+1] (trial) at vX; k, K
  // for the max-step sweep and the trial; Kl, L, kl for the trial.
  static constexpr int vY = 0, vS = M, vG = 2 * M, vU = 3 * M, vk = vU + NU, vK = vk + NU,
                       vX = vK + NU * NX, vKl = vX + NX, vL = vKl + NX * NX, vkl = vL + NX,
                       kValues = vkl + NX;
  using Stage = SweepStage<T, kValues>;
  const Consts<T, Mdl>& c;
  const BoxRows<T, M, NX, NU>& rows;  // the ball's row, if any, is a zero row
  const BallRow<T, NX>& ball;
  const IpCfg<T>& cfg;
  const TermArgs<T, MT, PT>& term;
  const CostArgs<T, Gn>& gn;
  const T* refs;
  T* X;
  T* U;
  T* Y;
  T* S;
  T* G;
  T* L;
  T* k;
  T* K;
  T* kl;
  T* Kl;
  size_t Bs;
  int b;
  int N;
  Stage st;

  __device__ T& at(T* p, int t, int i, int I) const { return p[(size_t(t) * I + i) * Bs + b]; }
  __device__ T& at(T* p, int t, int i, int j, int I, int J) const {
    return p[((size_t(t) * I + i) * J + j) * Bs + b];
  }

  template <int D>
  __device__ void load(T* p, int t, T (&v)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = at(p, t, i, D);
  }

  // Stage step t's nominal values for a sweep (gains: k, K; trial: the
  // nominal X[t+1] in place of X[t], and Kl, L, kl) and close the group.
  __device__ void fetch(int t, int stage, bool gains, bool trial) const {
    st.template fetch<M>(stage, vY, Y, t, Bs, b);
    st.template fetch<M>(stage, vS, S, t, Bs, b);
    st.template fetch<M>(stage, vG, G, t, Bs, b);
    st.template fetch<NU>(stage, vU, U, t, Bs, b);
    st.template fetch<NX>(stage, vX, X, trial ? t + 1 : t, Bs, b);
    if (gains) {
      st.template fetch<NU>(stage, vk, k, t, Bs, b);
      st.template fetch<NU * NX>(stage, vK, K, t, Bs, b);
    }
    if (trial) {
      st.template fetch<NX * NX>(stage, vKl, Kl, t, Bs, b);
      st.template fetch<NX>(stage, vL, L, t, Bs, b);
      st.template fetch<NX>(stage, vkl, kl, t, Bs, b);
    }
    Stage::commit();
  }

  // Before step t of a sweep whose next step is t_next (or none): stage
  // t_next, then wait for step t's values.
  __device__ void advance(int t_next, bool has_next, int stage, bool gains, bool trial) const {
    if (has_next)
      fetch(t_next, stage ^ 1, gains, trial);
    else
      Stage::commit();
    Stage::wait_prior();
  }

  // Row r of the dual and slack gains at one step, recomputed from the
  // row's nominal (y, s, g), the step's nominal x (a ball row's Jacobian)
  // and its control gains (the backward computed the same numbers from the
  // same inputs).
  __device__ void gain_row(int r, const T (&x)[NX], T mu, T y, T s, T g, const T (&kt)[NU],
                           const T (&Kt)[NU][NX], T& ky, T (&Ky)[NX], T& ks,
                           T (&Ks)[NX]) const {
    if constexpr (kBall) {
      if (r == BALL) {
        T gx[NX];
        ball.gx(x, gx);
        path_gain_row<T, NX, NU>(y, condense_row(y, s, g, mu), gx, rows.Gu[r], kt, Kt, ky, Ky,
                                 ks, Ks);
        return;
      }
    }
    path_gain_row<T, NX, NU>(y, condense_row(y, s, g, mu), rows.Gx[r], rows.Gu[r], kt, Kt, ky,
                             Ky, ks, Ks);
  }

  // The stack's g at (x, u): the box rows, then the ball row over its zero.
  __device__ void eval(const T (&x)[NX], const T (&u)[NU], T (&g)[M]) const {
    rows.eval(x, u, g);
    if constexpr (kBall) g[BALL] = ball.g(x);
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

  // --- terminal constraints (MT, PT > 0) -----------------------------------
  __device__ T tA(int i, int j) const { return __ldg(term.c + i * NX + j); }
  __device__ T tb(int i) const { return __ldg(term.c + MT * NX + i); }
  __device__ T ttarget(int i) const { return __ldg(term.c + MT * NX + MT + i); }
  __device__ T& sT(int i) const { return term.ST[size_t(i) * Bs + b]; }
  __device__ T& yT(int i) const { return term.YT[size_t(i) * Bs + b]; }
  __device__ T& lte(int i) const { return term.Lte[size_t(i) * Bs + b]; }
  __device__ T& dlam(int i) const { return term.dL[size_t(i) * Bs + b]; }

  // g_T = A x - b (TerminalStacker.ineq_evaluate).
  __device__ void g_term(const T (&x)[NX], T (&g)[MT > 0 ? MT : 1]) const {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      T a = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) a = a + x[j] * tA(i, j);
      g[i] = a - tb(i);
    }
  }

  // The terminal rows of the nominal at x (mu): their residual sums for
  // theta (inequality and equality groups), sum log s_T, lambda . h and the
  // inf-norms, maxed into inf_pr and inf_comp (_primal_comp, _theta,
  // _barrier_merit).
  __device__ void terminal_rows(const T (&x)[NX], T mu, T& ts_i, T& ts_e, T& sumlog, T& lam_h,
                                T& inf_pr, T& inf_comp) const {
    ts_i = T(0);
    ts_e = T(0);
    sumlog = T(0);
    lam_h = T(0);
    if constexpr (MT > 0) {
      T g[MT];
      g_term(x, g);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const T s = sT(i), y = yT(i), r = g[i] + s;
        sumlog = sumlog + dlog(nan_max(s, T(kEpsSlack)));
        ts_i = ts_i + (cfg.theta_l2 ? r * r : dabs(r));
        inf_pr = nan_max(inf_pr, dabs(r));
        inf_comp = nan_max(inf_comp, dabs(y * s - mu));
      }
    }
    if constexpr (PT > 0) {
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const T h = x[i] - ttarget(i);
        ts_e = ts_e + (cfg.theta_l2 ? h * h : dabs(h));
        inf_pr = nan_max(inf_pr, dabs(h));
        lam_h = lam_h + lte(i) * h;
      }
    }
  }

  // theta's sum: the path rows' sum, then the terminal groups' sums, added
  // in order.
  __device__ T theta_sum(T tsum, T ts_i, T ts_e) const {
    if constexpr (MT > 0) tsum = tsum + ts_i;
    if constexpr (PT > 0) tsum = tsum + ts_e;
    return tsum;
  }

  using Trial = std::conditional_t<kTerm, TermTrialOut<T>, TrialOut<T>>;

  // A trial's barrier merit at mu (computeBarrierMerit).
  __device__ T merit_of(const Trial& o, T mu) const {
    T v = o.J - mu * o.sumlog;
    if constexpr (MT > 0) v = v - mu * o.sumlog_T;
    if constexpr (PT > 0) v = v + o.lam_h;
    return v;
  }

  // The terminal value with the terminal inequalities folded in
  // (_terminal_value_fold): Vx += A' (y + clip((y g + mu) / s_safe)),
  // Vxx = sym(Vxx + A' Sigma A), y floored at EPS_DUAL; their residuals'
  // inf-norms into inf_pr, inf_comp.
  __device__ void fold_terminal(const T (&xN)[NX], T mu, T (&Vx)[NX], T (&Vxx)[NX][NX],
                                T& inf_pr, T& inf_comp) const {
    if constexpr (MT > 0) {
      constexpr T cap = max_ratio<T>();
      const T floor = nan_max(mu * T(1e-3), T(kEpsSlack));
      T g[MT], grad[MT], sig[MT];
      g_term(xN, g);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const T s = sT(i), y0 = yT(i);
        const T ss = nan_max(s, floor), y = nan_max(y0, T(kEpsDual));
        sig[i] = clip(y / ss, T(0), cap);
        grad[i] = y + clip((y * g[i] + mu) / ss, -cap, cap);
        inf_pr = nan_max(inf_pr, dabs(g[i] + s));
        inf_comp = nan_max(inf_comp, dabs(y0 * s - mu));
      }
      T Mt[NX][NX];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T a = T(0);
#pragma unroll
        for (int i = 0; i < MT; ++i) a = a + grad[i] * tA(i, j);
        Vx[j] = Vx[j] + a;
#pragma unroll
        for (int k2 = 0; k2 < NX; ++k2) {
          T w = T(0);
#pragma unroll
          for (int i = 0; i < MT; ++i) w = w + tA(i, j) * (sig[i] * tA(i, k2));
          Mt[j][k2] = Vxx[j][k2] + w;
        }
      }
#pragma unroll
      for (int j = 0; j < NX; ++j)
#pragma unroll
        for (int k2 = 0; k2 < NX; ++k2) Vxx[j][k2] = T(0.5) * (Mt[j][k2] + Mt[k2][j]);
    }
  }

  // --- a GN lane (Gn) ----------------------------------------------------------
  __device__ LaneParams<T> cp() const { return LaneParams<T>{gn.cp, Bs, b, gn.ncp}; }

  // Step t's running cost: the quadratic one, or the lane's sum r^2.
  __device__ T run_cost(int t, const T (&x)[NX], const T (&u)[NU]) const {
    if constexpr (kGn) {
      T r[Gn::NRES];
      Gn::res(x, u, cp(), gn.w, t, r);
      T s = T(0);
#pragma unroll
      for (int k2 = 0; k2 < Gn::NRES; ++k2) s = s + r[k2] * r[k2];
      return s;
    } else {
      T rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
      return running_cost(c, rf, x, u);
    }
  }

  // The terminal cost: the quadratic one, or the lane's sum r_T^2 + extra.
  __device__ T term_cost(const T (&x)[NX]) const {
    if constexpr (kGn) {
      T r[Gn::NTRES];
      Gn::tres(x, cp(), gn.w, r);
      T s = T(0);
#pragma unroll
      for (int k2 = 0; k2 < Gn::NTRES; ++k2) s = s + r[k2] * r[k2];
      return s + Gn::textra(x, cp(), gn.w);
    } else {
      return terminal_cost(c, x);
    }
  }

  // Column j of the Jacobians of the lane's residuals at (x, u): j < NX a
  // state column, else control column j - NX (one forward-mode pass).
  template <int NR>
  __device__ void gn_column(int t, int j, const T (&x)[NX], const T (&u)[NU],
                            T (&col)[NR]) const {
    Dual<T> xd[NX], ud[NU], r[NR];
#pragma unroll
    for (int i = 0; i < NX; ++i) xd[i] = Dual<T>{x[i], i == j ? T(1) : T(0)};
#pragma unroll
    for (int i = 0; i < NU; ++i) ud[i] = Dual<T>{u[i], i + NX == j ? T(1) : T(0)};
    Gn::res(xd, ud, cp(), gn.w, t, r);
#pragma unroll
    for (int k2 = 0; k2 < NR; ++k2) col[k2] = r[k2].d;
  }

  // Step t's Gauss-Newton derivatives (ResidualObjective's): lx = 2 Jx'r,
  // lu = 2 Ju'r, lxx = 2 Jx'Jx, luu = 2 Ju'Ju, lux = 2 Ju'Jx, each sum over
  // the residuals in order, then doubled.
  __device__ void gn_stage(int t, const T (&x)[NX], const T (&u)[NU], T (&lx)[NX], T (&lu)[NU],
                           T (&lxx)[NX][NX], T (&luu)[NU][NU], T (&lux)[NU][NX]) const {
    constexpr int NR = Gn::NRES;
    T r0[NR], J[NX + NU][NR];
    Gn::res(x, u, cp(), gn.w, t, r0);
#pragma unroll 1
    for (int j = 0; j < NX + NU; ++j) gn_column(t, j, x, u, J[j]);
    auto dot = [&](const T (&a)[NR], const T (&b2)[NR]) {
      T s = T(0);
#pragma unroll
      for (int k2 = 0; k2 < NR; ++k2) s = s + a[k2] * b2[k2];
      return T(2) * s;
    };
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      lx[i] = dot(J[i], r0);
#pragma unroll
      for (int j = 0; j < NX; ++j) lxx[i][j] = dot(J[i], J[j]);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lu[i] = dot(J[NX + i], r0);
#pragma unroll
      for (int j = 0; j < NU; ++j) luu[i][j] = dot(J[NX + i], J[NX + j]);
#pragma unroll
      for (int j = 0; j < NX; ++j) lux[i][j] = dot(J[NX + i], J[j]);
    }
  }

  // The terminal value at x_N: Vx = 2 J_T'r_T + the extra's gradient, Vxx =
  // sym(2 J_T'J_T) (the extra is affine).
  __device__ void gn_terminal_value(const T (&xN)[NX], T (&Vx)[NX], T (&Vxx)[NX][NX]) const {
    constexpr int NR = Gn::NTRES;
    T r0[NR], J[NX][NR];
    Gn::tres(xN, cp(), gn.w, r0);
#pragma unroll 1
    for (int j = 0; j < NX; ++j) {
      Dual<T> xd[NX], r[NR];
#pragma unroll
      for (int i = 0; i < NX; ++i) xd[i] = Dual<T>{xN[i], i == j ? T(1) : T(0)};
      Gn::tres(xd, cp(), gn.w, r);
#pragma unroll
      for (int k2 = 0; k2 < NR; ++k2) J[j][k2] = r[k2].d;
      Vx[j] = Gn::textra(xd, cp(), gn.w).d;
    }
    T H[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T a = T(0);
#pragma unroll
      for (int k2 = 0; k2 < NR; ++k2) a = a + J[i][k2] * r0[k2];
      Vx[i] = T(2) * a + Vx[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T h = T(0);
#pragma unroll
        for (int k2 = 0; k2 < NR; ++k2) h = h + J[i][k2] * J[j][k2];
        H[i][j] = T(2) * h;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) Vxx[i][j] = T(0.5) * (H[i][j] + H[j][i]);
  }

  __device__ T initial_cost() const {
    T J = T(0), x[NX], u[NU];
    for (int t = 0; t < N; ++t) {
      load(X, t, x);
      load(U, t, u);
      if constexpr (kGn) {
        J = J + run_cost(t, x, u);
      } else {
        T rf[NX];
        running_ref<TRACK>(c, refs, t, rf);
        J = J + running_cost(c, rf, x, u);
      }
    }
    load(X, N, x);
    return J + term_cost(x);
  }

  // inf_pr, inf_comp and theta of the nominal (Y, S, G) and its terminal
  // rows.
  __device__ void residuals(T mu, T& inf_pr, T& inf_comp, T& theta) const {
    T tsum = T(0), rmax = T(0), cmax = T(0);
    for (int t = 0; t < N; ++t) {
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const T y = at(Y, t, r, M), s = at(S, t, r, M), g = at(G, t, r, M);
        const T rr = g + s;
        tsum = tsum + (cfg.theta_l2 ? rr * rr : dabs(rr));
        rmax = nan_max(rmax, dabs(rr));
        cmax = nan_max(cmax, dabs(y * s - mu));
      }
    }
    if constexpr (kTerm) {
      T xN[NX], ts_i, ts_e, sumlog_T, lam_h;
      load(X, N, xN);
      terminal_rows(xN, mu, ts_i, ts_e, sumlog_T, lam_h, rmax, cmax);
      tsum = theta_sum(tsum, ts_i, ts_e);
    }
    inf_pr = rmax;
    inf_comp = cmax;
    theta = nan_max(cfg.theta_l2 ? dsqrt(tsum) : tsum, rmax);
  }

  // The nominal's terminal terms of the merit at mu: - mu sum log s_T +
  // lambda . h.
  __device__ T terminal_merit(T mu) const {
    T xN[NX], ts_i, ts_e, sumlog_T, lam_h, rmax = T(0), cmax = T(0);
    load(X, N, xN);
    terminal_rows(xN, mu, ts_i, ts_e, sumlog_T, lam_h, rmax, cmax);
    T v = T(0);
    if constexpr (MT > 0) v = v - mu * sumlog_T;
    if constexpr (PT > 0) v = v + lam_h;
    return v;
  }

  __device__ T sum_log_s() const {
    T sl = T(0);
    for (int t = 0; t < N; ++t)
#pragma unroll
      for (int r = 0; r < M; ++r) sl = sl + dlog(nan_max(at(S, t, r, M), T(kEpsSlack)));
    return sl;
  }

  // One backward attempt at regularization reg; writes k, K, k_lambda,
  // K_lambda. Returns ok (every step's condensed Quu positive definite).
  // armed_w (0 or 1) weights a ball variant's constraint-Hessian fold.
  // The terminal cost's value function at x_N: Vx = 2 Qf (x_N - goal),
  // Vxx = sym(2 Qf).
  __device__ void terminal_value(const T (&xN)[NX], T (&Vx)[NX], T (&Vxx)[NX][NX]) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) s = s + (xN[j] - c.goal[j]) * (T(2) * c.Qf[i][j]);
      Vx[i] = s;
#pragma unroll
      for (int j = 0; j < NX; ++j) Vxx[i][j] = T(0.5) * (T(2) * c.Qf[i][j] + T(2) * c.Qf[j][i]);
    }
  }

  __device__ void store_value(int t, const T (&Vx)[NX], const T (&Vxx)[NX][NX]) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      at(kl, t, i, NX) = Vx[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) at(Kl, t, i, j, NX, NX) = Vxx[i][j];
    }
  }

  // The running cost's constant Hessians (2 Q, 2 R, 0).
  __device__ void cost_hessians(T (&lxx)[NX][NX], T (&luu)[NU][NU], T (&lux)[NU][NX]) const {
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) lxx[i][j] = T(2) * c.Q[i][j];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NU; ++j) luu[i][j] = T(2) * c.R[i][j];
#pragma unroll
      for (int j = 0; j < NX; ++j) lux[i][j] = T(0);
    }
  }

  // Step t's running-cost gradient at the staged (x, u).
  __device__ void cost_gradient(int t, const T (&x)[NX], const T (&u)[NU], T (&lx)[NX],
                                T (&lu)[NU]) const {
    T rf[NX];
    running_ref<TRACK>(c, refs, t, rf);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T a = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) a = a + (x[j] - rf[j]) * (T(2) * c.Q[i][j]);
      lx[i] = a;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T a = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) a = a + u[j] * (T(2) * c.R[i][j]);
      lu[i] = a;
    }
  }

  // (The value function, cost Hessians and gradient are written out here as
  // they were before terminal constraints, not through terminal_value,
  // cost_hessians and cost_gradient, so that the variants without them keep
  // their SASS.)
  __device__ bool backward(T reg, T mu, T armed_w, BackStats<T>& bs) const {
    T xN[NX], Vx[NX], Vxx[NX][NX];
    load(X, N, xN);
    if constexpr (kGn) {
      gn_terminal_value(xN, Vx, Vxx);
    } else {
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T s = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) s = s + (xN[j] - c.goal[j]) * (T(2) * c.Qf[i][j]);
        Vx[i] = s;
#pragma unroll
        for (int j = 0; j < NX; ++j)
          Vxx[i][j] = T(0.5) * (T(2) * c.Qf[i][j] + T(2) * c.Qf[j][i]);
      }
    }
    T inf_pr_T = T(0), inf_comp_T = T(0);
    fold_terminal(xN, mu, Vx, Vxx, inf_pr_T, inf_comp_T);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      at(kl, N, i, NX) = Vx[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) at(Kl, N, i, j, NX, NX) = Vxx[i][j];
    }
    T lxx[NX][NX], luu[NU][NU], lux[NU][NX];
    if constexpr (!kGn) {
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) lxx[i][j] = T(2) * c.Q[i][j];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) luu[i][j] = T(2) * c.R[i][j];
#pragma unroll
        for (int j = 0; j < NX; ++j) lux[i][j] = T(0);
      }
    }
    bs = BackStats<T>{T(0), T(0), T(0), T(0), T(0), T(0)};
    bool ok = true;
    int stage = 0;
    fetch(N - 1, stage, false, false);
    for (int t = N - 1; t >= 0; --t, stage ^= 1) {
      advance(t - 1, t > 0, stage, false, false);
      T x[NX], u[NU], y[M], s[M], g[M], A[NX][NX], Bm[NX][NU], lx[NX], lu[NU];
      st.get(stage, vX, x);
      st.get(stage, vU, u);
      st.get(stage, vY, y);
      st.get(stage, vS, s);
      st.get(stage, vG, g);
      linearize(x, u, A, Bm);
      if constexpr (kGn) {
        gn_stage(t, x, u, lx, lu, lxx, luu, lux);
      } else {
        T rf[NX];
        running_ref<TRACK>(c, refs, t, rf);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T a = T(0);
#pragma unroll
          for (int j = 0; j < NX; ++j) a = a + (x[j] - rf[j]) * (T(2) * c.Q[i][j]);
          lx[i] = a;
        }
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          T a = T(0);
#pragma unroll
          for (int j = 0; j < NU; ++j) a = a + u[j] * (T(2) * c.R[i][j]);
          lu[i] = a;
        }
      }
      Condensed<T, M> cd;
      condense<T, M>(y, s, g, mu, cd);
      IpStep<T, NX, NU> o;
      if constexpr (kBall) {
        // The ball's Jacobian row at this step's x, and the armed fold
        // lxx[i][i] += (armed_w y_ball) (-2 scale) on the head dims
        // (mega_ipddp.py:1073-1092): a multiply, not a branch on armed_w,
        // so that a non-finite y gives NaN as the JAX kernel's does.
        T Gx[M][NX], lxx_t[NX][NX];
#pragma unroll
        for (int r = 0; r < M; ++r)
#pragma unroll
          for (int j = 0; j < NX; ++j) Gx[r][j] = rows.Gx[r][j];
        ball.gx(x, Gx[BALL]);
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) lxx_t[i][j] = lxx[i][j];
        if (cfg.chess_auto) {
          const T h = (armed_w * y[BALL]) * (T(-2) * ball.sf);
#pragma unroll
          for (int i = 0; i < NX; ++i)
            if (i < ball.d) lxx_t[i][i] = lxx[i][i] + h;
        }
        condensed_step<T, NX, NU, M>(A, Bm, lx, lu, lxx_t, luu, lux, y, Gx, rows.Gu, cd, reg,
                                     Vx, Vxx, o);
      } else {
        condensed_step<T, NX, NU, M>(A, Bm, lx, lu, lxx, luu, lux, y, rows.Gx, rows.Gu,
                                     cd, reg, Vx, Vxx, o);
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        at(k, t, i, NU) = o.k[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) at(K, t, i, j, NU, NX) = o.K[i][j];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        at(kl, t, i, NX) = Vx[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) at(Kl, t, i, j, NX, NX) = Vxx[i][j];
      }
      bs.dv0 = bs.dv0 + o.dv0;
      bs.dv1 = bs.dv1 + o.dv1;
      bs.inf_du = nan_max(bs.inf_du, o.qu_absmax);
      bs.inf_pr = nan_max(bs.inf_pr, o.pr_absmax);
      bs.inf_comp = nan_max(bs.inf_comp, o.comp_absmax);
#pragma unroll
      for (int i = 0; i < NU; ++i) bs.step = nan_max(bs.step, dabs(o.k[i]));
      ok = ok & o.ok;
    }
    if constexpr (MT > 0) {
      bs.inf_pr = nan_max(bs.inf_pr, inf_pr_T);
      bs.inf_comp = nan_max(bs.inf_comp, inf_comp_T);
    }
    return ok;
  }

  // One step of the terminal equality's stage data and sequential LQR
  // (_backward_terminal_eq's stage build with the path condensation, and
  // _solve_sequential_lqr, ipddp_solver.cpp:413-476) at staged (x, u, y, s,
  // g) and regularization reg, from the value (p, P) after step t. Writes
  // the gains (k, K), the value before step t over (p, P), Qu, the
  // regularized Quu's inverse, and returns whether Quu passed the leading
  // minors and k, K, p, P are finite. pr_max, comp_max: the step's path
  // residuals' inf-norms.
  __device__ bool te_step(int t, const T (&x)[NX], const T (&u)[NU], const T (&y)[M],
                          const T (&s)[M], const T (&g)[M], T mu, T reg, T (&A)[NX][NX],
                          T (&Bm)[NX][NU], T (&p)[NX], T (&P)[NX][NX], T (&k)[NU],
                          T (&K)[NU][NX], T (&Qu)[NU], T (&Hinv)[NU][NU], T& pr_max,
                          T& comp_max) const {
    T lx[NX], lu[NU], lxx[NX][NX], luu[NU][NU], lux[NU][NX];
    linearize(x, u, A, Bm);
    cost_gradient(t, x, u, lx, lu);
    cost_hessians(lxx, luu, lux);
    Condensed<T, M> cd;
    condense<T, M>(y, s, g, mu, cd);
    // Qs = sym(sym(lxx) + Gx' Sigma Gx), qs = lx + Gx' (y + S^-1 rhat),
    // Ms = lux' + Gx' Sigma Gu, Rs = sym(sym(luu) + Gu' Sigma Gu) + reg I.
    T Qs[NX][NX], qs[NX], Rs[NU][NU], rs[NU], Ms[NX][NU];
    {
      T Qa[NX][NX], Ra[NU][NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T q = T(0);
#pragma unroll
        for (int r = 0; r < M; ++r) q = q + rows.Gx[r][i] * (y[r] + cd.sir[r]);
        qs[i] = lx[i] + q;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T a = T(0);
#pragma unroll
          for (int r = 0; r < M; ++r) a = a + rows.Gx[r][i] * cd.sigma[r] * rows.Gx[r][j];
          Qa[i][j] = T(0.5) * (lxx[i][j] + lxx[j][i]) + a;
        }
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T a = T(0);
#pragma unroll
          for (int r = 0; r < M; ++r) a = a + rows.Gx[r][i] * cd.sigma[r] * rows.Gu[r][j];
          Ms[i][j] = lux[j][i] + a;
        }
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T q = T(0);
#pragma unroll
        for (int r = 0; r < M; ++r) q = q + rows.Gu[r][i] * (y[r] + cd.sir[r]);
        rs[i] = lu[i] + q;
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T a = T(0);
#pragma unroll
          for (int r = 0; r < M; ++r) a = a + rows.Gu[r][i] * cd.sigma[r] * rows.Gu[r][j];
          Ra[i][j] = T(0.5) * (luu[i][j] + luu[j][i]) + a;
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i)
#pragma unroll
        for (int j = 0; j < NX; ++j) Qs[i][j] = T(0.5) * (Qa[i][j] + Qa[j][i]);
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j)
          Rs[i][j] = T(0.5) * (Ra[i][j] + Ra[j][i]) + (i == j ? reg : T(0));
    }
    T pm = T(0), cm = T(0);
#pragma unroll
    for (int r = 0; r < M; ++r) {
      pm = nan_max(pm, dabs(cd.pr[r]));
      cm = nan_max(cm, dabs(cd.comp[r]));
    }
    pr_max = pm;
    comp_max = cm;

    // The LQR step: BtP = B' P, Quu = sym(Rs + BtP B), Qux = BtP A + Ms',
    // Qx = qs + A' p, Qu = rs + B' p.
    T BtP[NU][NX], Quu[NU][NU], Qux[NU][NX], Qx[NX];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T a = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) a = a + Bm[l][i] * P[l][j];
        BtP[i][j] = a;
      }
    {
      T Qm[NU][NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          T a = T(0);
#pragma unroll
          for (int l = 0; l < NX; ++l) a = a + BtP[i][l] * Bm[l][j];
          Qm[i][j] = Rs[i][j] + a;
        }
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          T a = T(0);
#pragma unroll
          for (int l = 0; l < NX; ++l) a = a + BtP[i][l] * A[l][j];
          Qux[i][j] = a + Ms[j][i];
        }
        T a = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) a = a + Bm[l][i] * p[l];
        Qu[i] = rs[i] + a;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j) Quu[i][j] = T(0.5) * (Qm[i][j] + Qm[j][i]);
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T a = T(0);
#pragma unroll
      for (int l = 0; l < NX; ++l) a = a + A[l][i] * p[l];
      Qx[i] = qs[i] + a;
    }
    inverse<T, NU>(Quu, Hinv);
    const bool pd = leading_minors_pd<T, NU>(Quu);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T a = T(0);
#pragma unroll
      for (int l = 0; l < NU; ++l) a = a + Hinv[i][l] * Qu[l];
      k[i] = pd ? -a : T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T w = T(0);
#pragma unroll
        for (int l = 0; l < NU; ++l) w = w + Hinv[i][l] * Qux[l][j];
        K[i][j] = pd ? -w : T(0);
      }
    }
    // P = sym(Qs + A' P A + Qux' K + K' Qux + K' Quu K),
    // p = Qx + Qux' k + K' Qu + (K' Quu) k.
    T AtP[NX][NX], KtQ[NX][NU], Pn[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T a = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) a = a + A[l][i] * P[l][j];
        AtP[i][j] = a;
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        T a = T(0);
#pragma unroll
        for (int l = 0; l < NU; ++l) a = a + K[l][i] * Quu[l][j];
        KtQ[i][j] = a;
      }
    }
    bool fin = pd;
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T apa = T(0), qk = T(0), kq = T(0), kqk = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) apa = apa + AtP[i][l] * A[l][j];
#pragma unroll
        for (int l = 0; l < NU; ++l) {
          qk = qk + Qux[l][i] * K[l][j];
          kq = kq + K[l][i] * Qux[l][j];
          kqk = kqk + KtQ[i][l] * K[l][j];
        }
        Pn[i][j] = Qs[i][j] + apa + qk + kq + kqk;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T a = T(0), b2 = T(0), d = T(0);
#pragma unroll
      for (int l = 0; l < NU; ++l) {
        a = a + Qux[l][i] * k[l];
        b2 = b2 + K[l][i] * Qu[l];
        d = d + KtQ[i][l] * k[l];
      }
      p[i] = Qx[i] + a + b2 + d;
      fin = fin & isfinite(p[i]);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        P[i][j] = T(0.5) * (Pn[i][j] + Pn[j][i]);
        fin = fin & isfinite(P[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      fin = fin & isfinite(k[i]);
#pragma unroll
      for (int j = 0; j < NX; ++j) fin = fin & isfinite(K[i][j]);
    }
    return fin;
  }

  // One backward attempt of the terminal-equality regime at reg (the JAX
  // kernel's, mega_ipddp.py:1155-1520): the base sweep with the Gramian, the
  // base rollout's dx_N, the multiplier step (written to dL) and the
  // combined sweep, which writes k, K, k_lambda, K_lambda. dV is zero, as
  // the plain driver reports it. Returns ok (both sweeps).
  __device__ bool backward_te(T reg, T mu, BackStats<T>& bs) const {
    if constexpr (PT > 0) {
      T xN[NX], Vx[NX], Vxx[NX][NX], h[PT], q[NX];
      load(X, N, xN);
      terminal_value(xN, Vx, Vxx);
      T inf_pr = T(0), inf_comp = T(0);
      fold_terminal(xN, mu, Vx, Vxx, inf_pr, inf_comp);
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        h[i] = xN[i] - ttarget(i);
        inf_pr = nan_max(inf_pr, dabs(h[i]));
        q[i] = Vx[i] + lte(i);  // q_base = Vx + H' Lambda_T_eq, H = I
      }

      // Base sweep: the gains of variant 0, the Gramian W and Phi(N, t).
      T p[NX], P[NX][NX], Phi[NX][NX], W[NX][NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        p[i] = q[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          P[i][j] = Vxx[i][j];
          Phi[i][j] = i == j ? T(1) : T(0);
          W[i][j] = T(0);
        }
      }
      bool ok = true;
      int stage = 0;
      fetch(N - 1, stage, false, false);
      for (int t = N - 1; t >= 0; --t, stage ^= 1) {
        advance(t - 1, t > 0, stage, false, false);
        T x[NX], u[NU], y[M], s[M], g[M], A[NX][NX], Bm[NX][NU], kt[NU], Kt[NU][NX], Qu[NU],
            Hinv[NU][NU], pm, cm;
        st.get(stage, vX, x);
        st.get(stage, vU, u);
        st.get(stage, vY, y);
        st.get(stage, vS, s);
        st.get(stage, vG, g);
        ok = ok & te_step(t, x, u, y, s, g, mu, reg, A, Bm, p, P, kt, Kt, Qu, Hinv, pm, cm);
        inf_pr = nan_max(inf_pr, pm);
        inf_comp = nan_max(inf_comp, cm);
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          at(k, t, i, NU) = kt[i];
#pragma unroll
          for (int j = 0; j < NX; ++j) at(K, t, i, j, NU, NX) = Kt[i][j];
        }
        // W += (Phi B) Quu^-1 (Phi B)', Phi <- Phi (A + B K).
        T FB[NX][NU], FBH[NX][NU], Acl[NX][NX], Pn[NX][NX];
        matmul<T, NX, NX, NU>(Phi, Bm, FB);
        matmul<T, NX, NU, NU>(FB, Hinv, FBH);
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            T a = T(0), bk = T(0);
#pragma unroll
            for (int l = 0; l < NU; ++l) {
              a = a + FBH[i][l] * FB[j][l];
              bk = bk + Bm[i][l] * Kt[l][j];
            }
            W[i][j] = W[i][j] + a;
            Acl[i][j] = A[i][j] + bk;
          }
        matmul<T, NX, NX, NX>(Phi, Acl, Pn);
#pragma unroll
        for (int i = 0; i < NX; ++i)
#pragma unroll
          for (int j = 0; j < NX; ++j) Phi[i][j] = Pn[i][j];
      }

      // The base gains' linear rollout from dx_0 = 0: dx_N of variant 0.
      T dx[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) dx[i] = T(0);
      stage = 0;
      fetch(0, stage, true, false);
      for (int t = 0; t < N; ++t, stage ^= 1) {
        advance(t + 1, t + 1 < N, stage, true, false);
        T x[NX], u[NU], kt[NU], Kt[NU][NX], A[NX][NX], Bm[NX][NU], du[NU], dxn[NX];
        st.get(stage, vX, x);
        st.get(stage, vU, u);
        st.get(stage, vk, kt);
        st.get(stage, vK, Kt);
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          T a = T(0);
#pragma unroll
          for (int j = 0; j < NX; ++j) a = a + Kt[i][j] * dx[j];
          du[i] = kt[i] + a;
        }
        linearize(x, u, A, Bm);
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          T a = T(0), d = T(0);
#pragma unroll
          for (int j = 0; j < NX; ++j) a = a + A[i][j] * dx[j];
#pragma unroll
          for (int j = 0; j < NU; ++j) d = d + Bm[i][j] * du[j];
          dxn[i] = a + d;
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) dx[i] = dxn[i];
      }

      // The multiplier step (ipddp_solver.cpp:550-617): A_small = H S = -W,
      // rhs = -h - dx_N, the SVD floor and the five-scale ladder, the first
      // smallest finite residual winning.
      T As[PT][PT], rhs[PT], AtA[PT][PT], Atb[PT];
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        rhs[i] = -h[i] - dx[i];
#pragma unroll
        for (int j = 0; j < PT; ++j) As[i][j] = -W[i][j];
      }
      T trace = T(0), rn = T(0);
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        T bsum = T(0);
#pragma unroll
        for (int r = 0; r < PT; ++r) bsum = bsum + As[r][i] * rhs[r];
        Atb[i] = bsum;
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          T a = T(0);
#pragma unroll
          for (int r = 0; r < PT; ++r) a = a + As[r][i] * As[r][j];
          AtA[i][j] = a;
        }
        trace = trace + AtA[i][i];
        rn = rn + rhs[i] * rhs[i];
      }
      const T trace_term = trace > T(1) ? trace / T(PT) : T(1);
      const T base_floor =
          nan_max(T(1e-10), term.jac_val * dpow(nan_max(mu, T(0)), term.jac_exp));
      T sv_max, sv_min;
      jacobi_sv_minmax<T, PT>(As, sv_max, sv_min);
      const T reg_base = nan_max(nan_max(base_floor, T(1e-6) * trace_term),
                                 nan_max(T(1e-8) * sv_max - sv_min, T(0)));
      const T lambda_cap = T(100) * (T(1) + dsqrt(rn));
      T best[PT], best_res = T(INFINITY);
#pragma unroll
      for (int i = 0; i < PT; ++i) best[i] = T(0);
      const T scales[5] = {T(1), T(10), T(100), T(1e3), T(1e4)};
#pragma unroll
      for (int sc = 0; sc < 5; ++sc) {
        const T reg_i = nan_max(reg_base * scales[sc], T(1e-12));
        T shifted[PT][PT], lam[PT];
#pragma unroll
        for (int i = 0; i < PT; ++i)
#pragma unroll
          for (int j = 0; j < PT; ++j) shifted[i][j] = AtA[i][j] + (i == j ? reg_i : T(0));
        bool good = chol_solve<T, PT>(shifted, Atb, lam);
        T nsq = T(0);
#pragma unroll
        for (int i = 0; i < PT; ++i) nsq = nsq + lam[i] * lam[i];
        const T norm = dsqrt(nsq);
        if (norm > lambda_cap) {
#pragma unroll
          for (int i = 0; i < PT; ++i) lam[i] = lam[i] * lambda_cap / nan_max(norm, T(1e-12));
        }
        T rsq = T(0);
#pragma unroll
        for (int i = 0; i < PT; ++i) {
          T a = T(0);
#pragma unroll
          for (int j = 0; j < PT; ++j) a = a + As[i][j] * lam[j];
          rsq = rsq + (a - rhs[i]) * (a - rhs[i]);
          good = good & isfinite(lam[i]);
        }
        const T res = dsqrt(rsq);
        good = good & isfinite(res);
        if (good && res < best_res) {
          best_res = res;
#pragma unroll
          for (int i = 0; i < PT; ++i) best[i] = lam[i];
        }
      }
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        dlam(i) = best[i];
        p[i] = q[i] + best[i];  // the combined terminal linear term
#pragma unroll
        for (int j = 0; j < NX; ++j) P[i][j] = Vxx[i][j];
      }
      store_value(N, p, P);

      // The combined sweep: the gains, the costate gains and the stats.
      bs = BackStats<T>{T(0), T(0), T(0), inf_pr, inf_comp, T(0)};
      stage = 0;
      fetch(N - 1, stage, false, false);
      for (int t = N - 1; t >= 0; --t, stage ^= 1) {
        advance(t - 1, t > 0, stage, false, false);
        T x[NX], u[NU], y[M], s[M], g[M], A[NX][NX], Bm[NX][NU], kt[NU], Kt[NU][NX], Qu[NU],
            Hinv[NU][NU], pm, cm;
        st.get(stage, vX, x);
        st.get(stage, vU, u);
        st.get(stage, vY, y);
        st.get(stage, vS, s);
        st.get(stage, vG, g);
        ok = ok & te_step(t, x, u, y, s, g, mu, reg, A, Bm, p, P, kt, Kt, Qu, Hinv, pm, cm);
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          at(k, t, i, NU) = kt[i];
#pragma unroll
          for (int j = 0; j < NX; ++j) at(K, t, i, j, NU, NX) = Kt[i][j];
          bs.inf_du = nan_max(bs.inf_du, dabs(Qu[i]));
          bs.step = nan_max(bs.step, dabs(kt[i]));
        }
        store_value(t, p, P);
      }
      return ok;
    } else {
      return false;
    }
  }

  // Fraction-to-boundary caps from the Newton step (computeMaxStepSizes):
  // dS, dY along the linear rollout of the gains from dx_0 = 0.
  __device__ void max_steps(T mu, T& apr, T& adu) const {
    constexpr T cap = max_ratio<T>();
    const T tau = nan_max(cfg.min_ftb, T(1) - mu);
    T dx[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = T(0);
    apr = T(1);
    adu = T(1);
    int stage = 0;
    fetch(0, stage, true, false);
    for (int t = 0; t < N; ++t, stage ^= 1) {
      advance(t + 1, t + 1 < N, stage, true, false);
      T x[NX], u[NU], kt[NU], Kt[NU][NX];
      st.get(stage, vX, x);
      st.get(stage, vU, u);
      st.get(stage, vk, kt);
      st.get(stage, vK, Kt);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const T y = st.get(stage, vY + r), s = st.get(stage, vS + r);
        T ky, Ky[NX], ks, Ks[NX];
        gain_row(r, x, mu, y, s, st.get(stage, vG + r), kt, Kt, ky, Ky, ks, Ks);
        T a = T(0), d = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          a = a + Ks[j] * dx[j];
          d = d + Ky[j] * dx[j];
        }
        const T dS = ks + a;
        const T dY = clip(ky + d, -cap, cap);
        if (dS < T(0)) apr = nan_min(apr, -tau * s / dS);
        if (dY < T(0)) adu = nan_min(adu, -tau * y / dY);
      }
      T du[NU], A[NX][NX], Bm[NX][NU], dxn[NX];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + Kt[i][j] * dx[j];
        du[i] = kt[i] + a;
      }
      linearize(x, u, A, Bm);
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0), d = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + A[i][j] * dx[j];
#pragma unroll
        for (int j = 0; j < NU; ++j) d = d + Bm[i][j] * du[j];
        dxn[i] = a + d;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) dx[i] = dxn[i];
    }
    if constexpr (MT > 0) {
      // The terminal inequalities' Newton steps from dx_N
      // (solvers/ipddp.py::_terminal_steps).
      const T floor = nan_max(mu * T(1e-3), T(kEpsSlack));
      T xN[NX], g[MT];
      load(X, N, xN);
      g_term(xN, g);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const T s = sT(i), y = yT(i);
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + tA(i, j) * dx[j];
        const T dS = -(g[i] + s) - a;
        const T ss = nan_max(s, floor);
        const T ratio = clip(y / ss, T(0), cap);
        const T affine = clip(-(s * y - mu) / ss, -cap, cap);
        const T dY = clip(affine - ratio * dS, -cap, cap);
        if (dS < T(0)) apr = nan_min(apr, -tau * s / dS);
        if (dY < T(0)) adu = nan_min(adu, -tau * y / dY);
      }
    }
    apr = clip(apr, T(0), T(1));
    adu = clip(adu, T(0), T(1));
  }

  // One trial at (a_pr, a_du) from the nominal (the scan body of
  // ipddp.py::_forward_pass, plus its terminal costate and residuals).
  // With write, the trial replaces the nominal in place: the nominal x_{t+1}
  // is read before it is overwritten, and inf_comp_new is the
  // complementarity residual under mu_new. soc: a ball variant's armed
  // slack SOC is on.
  __device__ Trial trial(T a_pr, T a_du, T mu, T mu_new, bool write, bool soc) const {
    const T tau = nan_max(cfg.min_ftb, T(1) - mu);
    T x[NX], xb[NX];
    load(X, 0, x);
    load(X, 0, xb);
    Trial o{};
    o.ok = true;
    T tsum = T(0);
    int stage = 0;
    fetch(0, stage, true, true);
    for (int t = 0; t < N; ++t, stage ^= 1) {
      advance(t + 1, t + 1 < N, stage, true, true);
      T kt[NU], Kt[NU][NX], dx[NX];
      st.get(stage, vk, kt);
      st.get(stage, vK, Kt);
#pragma unroll
      for (int i = 0; i < NX; ++i) dx[i] = x[i] - xb[i];
      T lam_n[NX], u[NU], s_n[M], y_n[M], g_n[M], xn[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + st.get(stage, vKl + i * NX + j) * dx[j];
        lam_n[i] = st.get(stage, vL + i) + a_pr * st.get(stage, vkl + i) + a;
      }
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const T y = st.get(stage, vY + r), s = st.get(stage, vS + r);
        T ky, Ky[NX], ks, Ks[NX];
        gain_row(r, xb, mu, y, s, st.get(stage, vG + r), kt, Kt, ky, Ky, ks, Ks);
        T a = T(0), d = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          a = a + Ks[j] * dx[j];
          d = d + Ky[j] * dx[j];
        }
        s_n[r] = s + a_pr * ks + a;
        y_n[r] = y + a_du * ky + d;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T a = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) a = a + Kt[i][j] * dx[j];
        u[i] = st.get(stage, vU + i) + a_pr * kt[i] + a;
      }
      if constexpr (kGn) {
        o.J = o.J + run_cost(t, x, u);
      } else {
        T rf[NX];
        running_ref<TRACK>(c, refs, t, rf);
        o.J = o.J + running_cost(c, rf, x, u);
      }
      eval(x, u, g_n);
      if constexpr (kBall) {
        // The armed slack SOC (mega_ipddp.py:1729-1745): s := -g at the
        // trial point on every row where fraction-to-boundary allows,
        // before the feasibility re-check.
        if (soc) {
#pragma unroll
          for (int r = 0; r < M; ++r) {
            const T s_soc = -g_n[r];
            if (ftb_ok(s_soc, st.get(stage, vS + r), tau)) s_n[r] = s_soc;
          }
        }
      }
      integrate<T, Mdl>(cfg.integrator, x, u, c.p, c.dt, xn);
#pragma unroll
      for (int r = 0; r < M; ++r) {
        o.ok = o.ok & ftb_ok(s_n[r], st.get(stage, vS + r), tau) &
               ftb_ok(y_n[r], st.get(stage, vY + r), tau) & isfinite(s_n[r]) & isfinite(y_n[r]);
        o.sumlog = o.sumlog + dlog(nan_max(s_n[r], T(kEpsSlack)));
        const T rr = g_n[r] + s_n[r];
        tsum = tsum + (cfg.theta_l2 ? rr * rr : dabs(rr));
        o.inf_pr = nan_max(o.inf_pr, dabs(rr));
        o.inf_comp = nan_max(o.inf_comp, dabs(y_n[r] * s_n[r] - mu));
        o.inf_comp_new = nan_max(o.inf_comp_new, dabs(y_n[r] * s_n[r] - mu_new));
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) o.ok = o.ok & isfinite(xn[i]) & isfinite(lam_n[i]);
#pragma unroll
      for (int i = 0; i < NU; ++i) o.ok = o.ok & isfinite(u[i]);
      st.get(stage, vX, xb);
      if (write) {
#pragma unroll
        for (int i = 0; i < NU; ++i) at(U, t, i, NU) = u[i];
#pragma unroll
        for (int r = 0; r < M; ++r) {
          at(Y, t, r, M) = y_n[r];
          at(S, t, r, M) = s_n[r];
          at(G, t, r, M) = g_n[r];
        }
#pragma unroll
        for (int i = 0; i < NX; ++i) {
          at(L, t, i, NX) = lam_n[i];
          at(X, t + 1, i, NX) = xn[i];
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    o.J = o.J + term_cost(x);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T a = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) a = a + at(Kl, N, i, j, NX, NX) * (x[j] - xb[j]);
      const T lam = at(L, N, i, NX) + a_pr * at(kl, N, i, NX) + a;
      o.ok = o.ok & isfinite(lam);
      if (write) at(L, N, i, NX) = lam;
    }
    T ts_i = T(0), ts_e = T(0);
    if constexpr (MT > 0) {
      // The terminal inequalities (_terminal_trial): gains at the old x_N
      // (xb), applied with the trial's real dx_N; the slack test keeps the
      // fraction-to-boundary slop.
      constexpr T cap = max_ratio<T>();
      const T floor = nan_max(mu * T(1e-3), T(kEpsSlack));
      T g0[MT], gn[MT];
      g_term(xb, g0);
      g_term(x, gn);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const T s = sT(i), y = yT(i);
        const T ks = -(g0[i] + s);
        const T ss = nan_max(s, floor);
        const T ratio = clip(y / ss, T(0), cap);
        T a = T(0), d = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const T dxj = x[j] - xb[j];
          a = a + (-tA(i, j)) * dxj;
          d = d + (-(ratio * (-tA(i, j)))) * dxj;
        }
        const T sn = s + a_pr * ks + a;
        const T ky = clip((-(y * s - mu) - y * ks) / ss, -cap, cap);
        const T yn = y + a_du * ky + d;
        const T s_floor = nan_max((T(1) - tau) * s, floor);
        const T slop = (T(kFtbSlop) * machine_eps<T>()) * (T(1) + dabs(s) + dabs(sn));
        o.ok = o.ok & (sn > T(0)) & (sn >= s_floor - slop) & ftb_ok(yn, y, tau) &
               isfinite(sn) & isfinite(yn);
        o.sumlog_T = o.sumlog_T + dlog(nan_max(sn, T(kEpsSlack)));
        const T rr = gn[i] + sn;
        ts_i = ts_i + (cfg.theta_l2 ? rr * rr : dabs(rr));
        o.inf_pr = nan_max(o.inf_pr, dabs(rr));
        o.inf_comp = nan_max(o.inf_comp, dabs(yn * sn - mu));
        o.inf_comp_new = nan_max(o.inf_comp_new, dabs(yn * sn - mu_new));
        if (write) {
          sT(i) = sn;
          yT(i) = yn;
        }
      }
    }
    if constexpr (PT > 0) {
      // The terminal equality: the multiplier step, |h_T| into theta and
      // inf_pr, lambda . h_T into the merit.
#pragma unroll
      for (int i = 0; i < PT; ++i) {
        const T lam = lte(i) + a_pr * dlam(i);
        const T h = x[i] - ttarget(i);
        o.ok = o.ok & isfinite(lam);
        ts_e = ts_e + (cfg.theta_l2 ? h * h : dabs(h));
        o.inf_pr = nan_max(o.inf_pr, dabs(h));
        o.lam_h = o.lam_h + lam * h;
        if (write) lte(i) = lam;
      }
    }
    tsum = theta_sum(tsum, ts_i, ts_e);
    o.theta = nan_max(cfg.theta_l2 ? dsqrt(tsum) : tsum, o.inf_pr);
    return o;
  }

  // updateBarrierParameters (ipddp.py::_update_barrier_and_filter): mu_new.
  __device__ T barrier(T mu, T inf_pr, T inf_du, T inf_comp) const {
    const T superlinear = dpow(mu, cfg.power);
    if (cfg.adaptive) {
      const T kkt = nan_max(nan_max(inf_pr, inf_du), inf_comp);
      const T threshold = nan_max(cfg.f * mu, T(2) * mu);
      const T ratio = kkt / nan_max(mu, T(1e-20));
      T factor = ratio < T(0.01) ? cfg.f01
                                 : (ratio < T(0.1) ? cfg.f03 : (ratio < T(0.5) ? cfg.f06 : cfg.f));
      factor = mu > T(1e-20) ? factor : cfg.f;
      const T cand = nan_max(nan_min(factor * mu, superlinear), cfg.mu_floor_adaptive);
      return kkt <= threshold ? cand : mu;
    }
    const T kkt = nan_max(nan_max(inf_pr, inf_du * cfg.dual_weight), inf_comp);
    const T cand = nan_max(cfg.mu_min, nan_min(cfg.f * mu, superlinear));
    return kkt <= cfg.kappa_eps * mu ? cand : mu;
  }
};

// Threads of a block: kSolveThreads, halved while the block's two stages of
// the step's values outgrow its shared memory (232,448 bytes): the
// quaternion attitude's m = 6 in float64 stages 115 values a thread, 235,520
// bytes at 128 threads, and runs in blocks of 64.
template <typename T, class Mdl, int M, int BALL>
constexpr int ipddp_solve_threads() {
  int threads = kSolveThreads;
  while (threads > 32 &&
         stage_bytes<T>(IpSolver<T, Mdl, M, BALL, false>::kValues, threads) > 232448)
    threads /= 2;
  return threads;
}

template <typename T, class Mdl, int M, int BALL, bool TRACK, int MT, int PT,
          int TH = ipddp_solve_threads<T, Mdl, M, BALL>(), class Gn = void>
__global__ void __launch_bounds__(TH, solve_min_blocks<T>()) ipddp_solve_kernel(
    T* __restrict__ X, T* __restrict__ U, T* __restrict__ Y, T* __restrict__ S,
    T* __restrict__ G, T* __restrict__ L, T* __restrict__ k, T* __restrict__ K,
    T* __restrict__ kl, T* __restrict__ Kl, T* __restrict__ stats, const T* __restrict__ refs,
    const __grid_constant__ Consts<T, Mdl> c,
    const __grid_constant__ BoxRows<T, M, Mdl::NX, Mdl::NU> rows,
    const __grid_constant__ BallRow<T, Mdl::NX> ball, const __grid_constant__ IpCfg<T> cfg,
    int N, int B, const __grid_constant__ TermArgs<T, MT, PT> term,
    const __grid_constant__ CostArgs<T, Gn> gn) {
  extern __shared__ __align__(16) unsigned char cddp_smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = B;
  using Sv = IpSolver<T, Mdl, M, BALL, TRACK, MT, PT, Gn>;
  const Sv sv{c, rows, ball, cfg, term, gn, refs, X, U, Y, S, G, L, k, K, kl, Kl, Bs, b, N,
              Sv::Stage::make(cddp_smem)};

  T mu = stats[4 * Bs + b];
  T cost = sv.initial_cost();
  T inf_pr, inf_comp, theta;
  sv.residuals(mu, inf_pr, inf_comp, theta);
  T merit = cost - mu * sv.sum_log_s();
  if constexpr (Sv::kTerm) merit = merit + sv.terminal_merit(mu);
  T filter_theta = nan_max(theta, T(1e-8));
  Filter<T> filt;
  filt.clear();
  // With terminal constraints the filter starts with the initial point.
  if constexpr (Sv::kTerm) filt.accept(merit, filter_theta);
  T reg = cfg.reg0, inf_du = T(0), step_norm = T(0), alpha_pr = T(1);
  // Work done, for the operation count of a roofline bound: backward
  // attempts and trajectory sweeps (trials, the accepted trial's rewrite).
  int attempts = 0, sweeps = 0;
  int it = 0, status = kIpMaxIter;
  // The stall latch (a ball variant's only): the SOC not yet dropped, the
  // latch armed, consecutive stalled commits, the best committed inf_pr
  // (+inf until the first commit, ipddp.py:1651-1656).
  bool soc_on = true, armed = false;
  int stall = 0;
  T best_inf_pr = T(INFINITY);

  for (int iter = 0; iter < cfg.max_iterations; ++iter) {
    ++it;
    // Backward pass with regularization retry (ipddp.py:1694-1708).
    BackStats<T> bs;
    bool bp_limit = false;
    for (int attempt = 0; attempt < cfg.bp_bound; ++attempt) {
      bool ok;
      if constexpr (PT > 0) {
        ok = sv.backward_te(reg, mu, bs);
      } else {
        ok = sv.backward(reg, mu, armed ? T(1) : T(0), bs);
      }
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
      status = kIpRegLimit;
      break;
    }
    // Early convergence (checkEarlyConvergence, ipddp_solver.cpp:925-958).
    const T tol_e = nan_max(cfg.tol, cfg.btm * mu);
    if (inf_pr < tol_e && inf_du < tol_e && inf_comp < tol_e &&
        dabs(alpha_pr) * step_norm < cfg.tol10) {
      status = kIpOptimal;
      break;
    }

    // First-success filter line search (ipddp_solver.cpp:1784-1839).
    T apr_max, adu_max;
    sv.max_steps(mu, apr_max, adu_max);
    T f_mf, f_cv;
    bool nonempty;
    filt.back(f_mf, f_cv, nonempty);
    const T cv_old = nonempty ? f_cv : T(0);
    const T high_ref = nonempty ? f_cv : filter_theta;
    bool found = false;
    T a_pr = T(1), a_du = T(1);
    typename Sv::Trial tr{};
    for (int ia = 0; ia < cfg.n_alpha && !found; ++ia) {
      a_pr = nan_min(cfg.alphas[ia], apr_max);
      a_du = nan_min(cfg.alphas[ia], adu_max);
      tr = sv.trial(a_pr, a_du, mu, mu, false, cfg.soc_auto && soc_on && armed);
      ++sweeps;
      const T phi = sv.merit_of(tr, mu);
      const bool fin = tr.ok && isfinite(phi) && isfinite(tr.theta) &&
                       isfinite(tr.inf_pr) && isfinite(tr.inf_comp);
      const T expected = a_pr * bs.dv0;
      const bool br1 = tr.theta > cfg.max_viol;
      const bool acc1 = tr.theta < cfg.one_m_vat * high_ref;
      const bool br2 = nan_max(tr.theta, cv_old) < cfg.mvfac && expected < T(0);
      const bool acc2 = phi < merit + cfg.armijo * expected;
      const bool acc3 = phi < merit - cfg.mat * tr.theta || tr.theta < cfg.one_m_vat * cv_old;
      found = fin && (br1 ? acc1 : (br2 ? acc2 : acc3));
    }

    if (found) {
      // Commit (ipddp.py:1788-1895): barrier update, the trial written over
      // the nominal, the filter update, convergence under the new mu.
      const T mu_new = sv.barrier(mu, tr.inf_pr, inf_du, tr.inf_comp);
      const typename Sv::Trial w =
          sv.trial(a_pr, a_du, mu, mu_new, true, cfg.soc_auto && soc_on && armed);
      if constexpr (Sv::kBall) {
        // The stall detector (mega_ipddp.py:2111-2135, ipddp.py
        // stall_detector_update), its constants in T as the JAX kernel's
        // weak-typed ones: in float32, 1 - 1e-12 rounds to 1.
        if (cfg.soc_auto || cfg.chess_auto) {
          const bool mu_stuck = mu_new >= mu * T(1.0 - 1e-12);
          const bool improved = tr.inf_pr < best_inf_pr * T(1.0 - 1e-3);
          const bool stalled = tr.inf_pr > cfg.far && (mu_stuck || !improved) && !armed;
          stall = stalled ? stall + 1 : 0;
          armed = armed || stall >= cfg.soc_stall;
          best_inf_pr = nan_min(best_inf_pr, tr.inf_pr);
        }
      }
      ++sweeps;
      const T dJ = cost - tr.J;
      const T ft_new = nan_max(tr.theta, T(1e-8));
      const T phi_tr = sv.merit_of(tr, mu);
      filt.accept(phi_tr, ft_new);
      if (filt.size() > cfg.f_max) filt.prune();
      if (mu_new < mu && mu_new > T(0)) {
        filt.clear();
        // With terminal constraints the cleared filter is reseeded with the
        // committed point (ipddp.py:1335).
        if constexpr (Sv::kTerm) filt.accept(phi_tr, ft_new);
      }
      inf_pr = tr.inf_pr;
      inf_comp = w.inf_comp_new;
      merit = sv.merit_of(tr, mu_new);
      filter_theta = ft_new;
      cost = tr.J;
      alpha_pr = a_pr;
      reg = nan_max(reg / cfg.reg_uf, cfg.reg_min);
      mu = mu_new;
      // checkConvergence (ipddp_solver.cpp:1953-2025).
      const T tol2 = nan_max(cfg.tol, cfg.btm * mu);
      const bool step_small = step_norm < cfg.tol10;
      const bool conv_opt = inf_pr < tol2 && inf_du < tol2 && inf_comp < tol2 && step_small;
      const bool acc_kkt = inf_pr < cfg.sqrt_atol && inf_du < cfg.sqrt_atol &&
                           inf_comp < cfg.sqrt_atol;
      const bool acc = acc_kkt && mu <= cfg.barrier_accept_tol &&
                       ((it > 10 && dabs(dJ) < cfg.atol) ||
                        (it >= 1 && step_small && inf_pr < T(1e-4)));
      const bool conv_acc = cfg.atol > T(0) && acc;
      status = conv_opt ? kIpOptimal : (conv_acc ? kIpAcceptable : status);
      if (conv_opt || conv_acc) break;
    } else {
      // handleForwardPassFailure (ipddp_solver.cpp:2037-2082); a terminal
      // equality raises the regularization twice (ipddp.py:1900).
      T reg_n = nan_min(reg * cfg.reg_uf, cfg.reg_max);
      if constexpr (PT > 0) reg_n = nan_min(reg_n * cfg.reg_uf, cfg.reg_max);
      const bool limit = reg_n >= cfg.reg_max;
      if constexpr (Sv::kBall) {
        // The latch's fail path (mega_ipddp.py:2209-2230): near
        // feasibility an armed SOC is dropped; at the regularization limit
        // far from feasibility an unarmed latch arms and the solve retries
        // from the initial regularization. Either keeps reg or status.
        if (cfg.soc_auto && soc_on && armed && inf_pr < cfg.tol10) {
          soc_on = false;
          continue;
        }
        if ((cfg.soc_auto || cfg.chess_auto) && limit && !armed && inf_pr > cfg.far) {
          armed = true;
          reg = cfg.reg0;
          continue;
        }
      }
      const T acc_tol = nan_max(cfg.fail_accept, cfg.btm * mu);
      const bool acceptable = cfg.atol > T(0) && inf_pr < acc_tol && inf_du < acc_tol &&
                              inf_comp < acc_tol;
      status = (limit && acceptable) ? kIpAcceptable : (limit ? kIpRegLimit : status);
      reg = reg_n;
      if (limit) break;
    }
  }

  const T vals[11] = {cost,     inf_pr,    inf_du,     inf_comp,  mu,       reg,
                      alpha_pr, T(it),     T(status),  T(attempts), T(sweeps)};
#pragma unroll
  for (int i = 0; i < 11; ++i) stats[i * Bs + b] = vals[i];
  if constexpr (Sv::kBall) {
    // The latch's final state (a box variant has none and leaves the rows).
    stats[11 * Bs + b] = soc_on ? T(1) : T(0);
    stats[12 * Bs + b] = armed ? T(1) : T(0);
  }
}

template <typename T, class Mdl, int M, int BALL>
constexpr int ipddp_solve_smem() {
  return stage_bytes<T>(IpSolver<T, Mdl, M, BALL, false>::kValues,
                        ipddp_solve_threads<T, Mdl, M, BALL>());
}

template <typename T, class Mdl, int M, int BALL, bool TRACK, int MT, int PT, class Gn = void>
int launch_ipddp_solve(T* const* buf, const T* refs, const double* consts, const double* rows,
                       const double* ball, const double* cfg, const double* alphas,
                       const int* ints, const T* term_c, T* const* term_state,
                       cudaStream_t stream, const T* cp = nullptr, int ncp = 0,
                       const double* weights = nullptr) {
  const int N = ints[0], B = ints[1];
  if (ints[4] > kMaxAlpha) return static_cast<int>(cudaErrorInvalidValue);
  const Consts<T, Mdl> c = Consts<T, Mdl>::from_host(consts);
  const auto r = BoxRows<T, M, Mdl::NX, Mdl::NU>::from_host(rows);
  const auto bl = BallRow<T, Mdl::NX>::from_host(ball);
  const IpCfg<T> sc = IpCfg<T>::from_host(cfg, alphas, ints + 2);
  TermArgs<T, MT, PT> term{};
  if constexpr (MT > 0 || PT > 0)
    term = {term_c, term_state[0], term_state[1], term_state[2], term_state[3], T(cfg[27]),
            T(cfg[28])};
  const auto gn = CostArgs<T, Gn>::from_host(cp, ncp, weights);
  constexpr int TH = ipddp_solve_threads<T, Mdl, M, BALL>();
  const int blocks = (B + TH - 1) / TH;
  const int smem = ipddp_solve_smem<T, Mdl, M, BALL>();
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)ipddp_solve_kernel<T, Mdl, M, BALL, TRACK, MT, PT, TH, Gn>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ipddp_solve_kernel<T, Mdl, M, BALL, TRACK, MT, PT, TH, Gn><<<blocks, TH, smem, stream>>>(
      buf[0], buf[1], buf[2], buf[3], buf[4], buf[5], buf[6], buf[7], buf[8], buf[9],
      buf[10], refs, c, r, bl, sc, N, B, term, gn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// A stack of m rows with the keep-out ball at row BALL (-1: none) and MT
// terminal inequality and PT terminal equality rows, named NAME; TRACK true
// (NAME suffix _track) is the tracking form, whose `refs` is the shared
// (N, nx) reference (NULL and unread in the goal form). term_c (the
// terminal constants), ST, YT, Lte (their state, in and out) and dL (PT, B
// scratch) are NULL and unread without terminal constraints.
#define CDDP_IPDDP_SOLVE(MODEL, STRUCT, M, BALL, TRACK, MT, PT, NAME)                  \
  extern "C" int CDDP_EXPORT(cddp_ipddp_solve_##MODEL##_##NAME)(                       \
      scalar_t* X, scalar_t* U, scalar_t* Y, scalar_t* S, scalar_t* G, scalar_t* L,    \
      scalar_t* k, scalar_t* K, scalar_t* kl, scalar_t* Kl, scalar_t* stats,           \
      const scalar_t* refs, const scalar_t* term_c, scalar_t* ST, scalar_t* YT,        \
      scalar_t* Lte, scalar_t* dL, const double* consts, const double* rows,           \
      const double* ball, const double* cfg, const double* alphas, int N, int B,       \
      int integrator, int max_iterations, int n_alpha, int bp_bound, int adaptive,     \
      int theta_l2, int f_max, int soc_auto, int chess_auto, int soc_stall,            \
      void* stream) {                                                                  \
    scalar_t* buf[11] = {X, U, Y, S, G, L, k, K, kl, Kl, stats};                       \
    scalar_t* term_state[4] = {ST, YT, Lte, dL};                                       \
    const int ints[12] = {N,        B,        integrator, max_iterations,              \
                          n_alpha,  bp_bound, adaptive,   theta_l2,                    \
                          f_max,    soc_auto, chess_auto, soc_stall};                  \
    return cddp::launch_ipddp_solve<scalar_t, cddp::STRUCT, M, BALL, TRACK, MT, PT>(   \
        buf, refs, consts, rows, ball, cfg, alphas, ints, term_c, term_state,          \
        static_cast<cudaStream_t>(stream));                                            \
  }                                                                                    \
  namespace cddp_ipddp_solve_##MODEL##_##NAME {                                        \
  constexpr int TH = cddp::ipddp_solve_threads<scalar_t, cddp::STRUCT, M, BALL>();      \
  CDDP_REGISTER(cddp_ipddp_solve_##MODEL##_##NAME,                                     \
                (cddp::ipddp_solve_kernel<scalar_t, cddp::STRUCT, M, BALL, TRACK, MT, PT, TH>), \
                TH, (cddp::ipddp_solve_smem<scalar_t, cddp::STRUCT, M, BALL>()))           \
  }

// A GN lane GN_STRUCT (lanes.cuh) on the model STRUCT's control box of M
// rows, goal form, no terminal constraints: launcher
// cddp_ipddp_solve_<MODEL>_<GN>_m<M>, whose arguments are the goal form's
// (refs and the terminal pointers NULL and unread) then the instances' cost
// parameters cp (n_cp, B), n_cp and the lane's weights.
#define CDDP_IPDDP_SOLVE_GN(MODEL, STRUCT, GN, GN_STRUCT, M)                             \
  extern "C" int CDDP_EXPORT(cddp_ipddp_solve_##MODEL##_##GN##_m##M)(                  \
      scalar_t* X, scalar_t* U, scalar_t* Y, scalar_t* S, scalar_t* G, scalar_t* L,    \
      scalar_t* k, scalar_t* K, scalar_t* kl, scalar_t* Kl, scalar_t* stats,           \
      const scalar_t* refs, const scalar_t* term_c, scalar_t* ST, scalar_t* YT,        \
      scalar_t* Lte, scalar_t* dL, const double* consts, const double* rows,           \
      const double* ball, const double* cfg, const double* alphas, int N, int B,       \
      int integrator, int max_iterations, int n_alpha, int bp_bound, int adaptive,     \
      int theta_l2, int f_max, int soc_auto, int chess_auto, int soc_stall,            \
      const scalar_t* cp, int ncp, const double* weights, void* stream) {              \
    scalar_t* buf[11] = {X, U, Y, S, G, L, k, K, kl, Kl, stats};                       \
    scalar_t* term_state[4] = {ST, YT, Lte, dL};                                       \
    const int ints[12] = {N,        B,        integrator, max_iterations,              \
                          n_alpha,  bp_bound, adaptive,   theta_l2,                    \
                          f_max,    soc_auto, chess_auto, soc_stall};                  \
    return cddp::launch_ipddp_solve<scalar_t, cddp::STRUCT, M, -1, false, 0, 0,        \
                                    cddp::GN_STRUCT>(                                  \
        buf, refs, consts, rows, ball, cfg, alphas, ints, term_c, term_state,          \
        static_cast<cudaStream_t>(stream), cp, ncp, weights);                          \
  }                                                                                    \
  namespace cddp_ipddp_solve_##MODEL##_##GN##_m##M {                                   \
  constexpr int TH = cddp::ipddp_solve_threads<scalar_t, cddp::STRUCT, M, -1>();       \
  CDDP_REGISTER(cddp_ipddp_solve_##MODEL##_##GN##_m##M,                                \
                (cddp::ipddp_solve_kernel<scalar_t, cddp::STRUCT, M, -1, false, 0, 0, TH, \
                                          cddp::GN_STRUCT>),                           \
                TH, (cddp::ipddp_solve_smem<scalar_t, cddp::STRUCT, M, -1>()))             \
  }
