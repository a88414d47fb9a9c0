// Whole CLDDP solve: one thread runs the complete solve of one instance.
//
// Replaces cddp_tpu/ops/pallas/mega_clddp.py::make_solve_kernel (:303). The
// Pallas kernel runs a tile of instances in lock step and freezes finished
// lanes with masks; here every thread follows its own control flow, which
// is the per-instance semantics of solvers/clddp.py::_solve directly:
//
//   cost0; for each iteration:
//     backward pass (Euler linearization A = I + dt*Fx, B = dt*Fu of the
//       continuous dynamics, whatever the rollout integrator) with the
//       regularization retry, at most bp_bound attempts;
//     Armijo alpha ladder from the nominal X[0]: first success, or best
//       merit with enable_parallel;
//     acceptance, regularization and convergence bookkeeping.
//
// X, U, k, K are the seeds on entry and the solution on exit, updated in
// place (batch-last, [t][i][b]). A trial rollout only accumulates its cost;
// the accepted step is rolled out once more and written over the nominal,
// so the kernel needs no candidate buffers. The accepted rollout repeats
// the trial's arithmetic exactly, so it reproduces the trial's trajectory.
//
// Bound: latency. Every backward attempt reads X, U (5 values per step)
// and writes k, K (8); every trial rollout reads 13 values per step. The
// state, value function and gains of one step live in registers; the
// trajectories (263 values per instance at N=20) do not, and a fleet's do
// not stay in L2. Every sweep stages step t+1's nominal values in shared
// memory with cp.async while it computes step t
// (sweep_stage.cuh::NominalStage), so no load waits just before its use. A
// register budget (blocks of 128 threads at 64, 72 or 80 registers)
// measured no faster than these blocks of 256 threads (PERF.md, section 6).
//
// TRACK (the `_track` launcher) is the tracking variant
// (mega_clddp.py:304,345-349): step t's running reference is row t of the
// shared (N, nx) reference `refs` (models.cuh::running_ref) in every
// rollout's running cost and in the backward sweep's lx; the terminal cost
// and its derivatives keep the goal.
#include "clddp_step.cuh"
#include "models.cuh"
#include "sweep_stage.cuh"

namespace cddp {

// Solver options baked into one launch (mega_clddp.py::_Cfg).
template <typename T>
struct SolveCfg {
  T tolerance, acceptable_tolerance, armijo, reg0, reg_uf, reg_max, reg_min,
      s_max, a0, a_r, a_min;
  int max_iterations, n_alpha, bp_bound, parallel_ls, integrator;

  static SolveCfg from_host(const double* h, int max_iterations, int n_alpha,
                            int bp_bound, int parallel_ls, int integrator) {
    return SolveCfg{T(h[0]), T(h[1]), T(h[2]),  T(h[3]), T(h[4]),  T(h[5]),
                    T(h[6]), T(h[7]), T(h[8]),  T(h[9]), T(h[10]), max_iterations,
                    n_alpha, bp_bound, parallel_ls, integrator};
  }
};

// Status codes (cddp_tpu_torch.solution.Status), written as floats.
constexpr int kMaxIter = 0, kOptimal = 1, kAcceptable = 2, kRegLimit = 3;

template <typename T, class M, bool TRACK>
struct Solver {
  static constexpr int NX = M::NX, NU = M::NU;
  using Staged = NominalStage<T, NX, NU>;
  const Consts<T, M>& c;
  const T* refs;
  T* X;
  T* U;
  T* k;
  T* K;
  size_t B;
  int b;
  int N_;
  Staged ns;

  __device__ T& x_at(int t, int i) const { return X[(size_t(t) * NX + i) * B + b]; }
  __device__ T& u_at(int t, int i) const { return U[(size_t(t) * NU + i) * B + b]; }
  __device__ T& k_at(int t, int i) const { return k[(size_t(t) * NU + i) * B + b]; }
  __device__ T& K_at(int t, int i, int j) const {
    return K[((size_t(t) * NU + i) * NX + j) * B + b];
  }

  __device__ void load_x(int t, T (&x)[NX]) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x_at(t, i);
  }

  __device__ T initial_cost() const {
    T J = T(0), x[NX], u[NU];
    int stage = 0;
    ns.fetch(0, stage, false);
    for (int t = 0; t < N(); ++t, stage ^= 1) {
      ns.advance(t + 1, t + 1 < N(), stage, false);
      ns.st.get(stage, Staged::vX, x);
      ns.st.get(stage, Staged::vU, u);
      T rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
      J = J + running_cost(c, rf, x, u);
    }
    load_x(N(), x);
    return J + terminal_cost(c, x);
  }

  __device__ int N() const { return N_; }

  // One backward attempt at regularization reg; writes k, K. Returns ok and
  // sets dV, Qu_err and |Vx|_1 (terminal included).
  __device__ bool backward(T reg, T& dv0, T& dv1, T& qerr, T& nvx) const {
    T xN[NX];
    load_x(N(), xN);
    T Vx[NX], Vxx[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) s = s + c.Qf[i][j] * (xN[j] - c.goal[j]);
      Vx[i] = T(2) * s;
#pragma unroll
      for (int j = 0; j < NX; ++j) Vxx[i][j] = T(2) * c.Qf[i][j];
    }
    nvx = T(0);
#pragma unroll
    for (int i = 0; i < NX; ++i) nvx = nvx + dabs(Vx[i]);
    dv0 = T(0);
    dv1 = T(0);
    qerr = T(0);
    T ok = T(1);

    T lxx[NX][NX], luu[NU][NU], lux[NU][NX];
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

    int stage = 0;
    ns.fetch(N() - 1, stage, false);
    for (int t = N() - 1; t >= 0; --t, stage ^= 1) {
      ns.advance(t - 1, t > 0, stage, false);
      T x[NX], u[NU], Fx[NX][NX], Fu[NX][NU];
      ns.st.get(stage, Staged::vX, x);
      ns.st.get(stage, Staged::vU, u);
      M::fxfu(x, u, c.p, Fx, Fu);
      T rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
      T A[NX][NX], Bm[NX][NU], lx[NX], lu[NU], lb[NU], ub[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
#pragma unroll
        for (int j = 0; j < NX; ++j) A[i][j] = (i == j ? T(1) : T(0)) + c.dt * Fx[i][j];
#pragma unroll
        for (int j = 0; j < NU; ++j) Bm[i][j] = c.dt * Fu[i][j];
        T s = T(0);
#pragma unroll
        for (int j = 0; j < NX; ++j) s = s + c.Q[i][j] * (x[j] - rf[j]);
        lx[i] = T(2) * s;
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T s = T(0);
#pragma unroll
        for (int j = 0; j < NU; ++j) s = s + c.R[i][j] * u[j];
        lu[i] = T(2) * s;
        lb[i] = c.lb[i] - u[i];
        ub[i] = c.ub[i] - u[i];
      }
      StepOut<T, NX, NU> o;
      clddp_backward_step<T, NX, NU>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, Vx,
                                     Vxx, reg, o);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        k_at(t, i) = o.k[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) K_at(t, i, j) = o.K[i][j];
      }
      dv0 = dv0 + o.dv0;
      dv1 = dv1 + o.dv1;
      qerr = nan_max(qerr, o.qu_absmax);
      T a = T(0);
#pragma unroll
      for (int i = 0; i < NX; ++i) a = a + dabs(Vx[i]);
      nvx = nvx + a;
      ok = ok * (o.fail ? T(0) : T(1));
    }
    return ok > T(0.5);
  }

  // Closed-loop rollout from the nominal X[0] at step alpha; returns its
  // cost. With write, the new trajectory replaces the nominal in place: the
  // nominal x_{t+1} is read (from the stage) before it is overwritten.
  __device__ T rollout(T alpha, int integrator, bool write) const {
    T x[NX], xb[NX];
    load_x(0, x);
    load_x(0, xb);
    T J = T(0);
    int stage = 0;
    ns.fetch(0, stage, true);
    for (int t = 0; t < N(); ++t, stage ^= 1) {
      ns.advance(t + 1, t + 1 < N(), stage, true);
      T ub[NU], kf[NU], Kf[NU][NX], u[NU], xn[NX];
      ns.st.get(stage, Staged::vU, ub);
      ns.st.get(stage, Staged::vk, kf);
      ns.st.get(stage, Staged::vK, Kf);
      T rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
      J = J + rollout_step<T, M>(c, rf, integrator, true, alpha, x, xb, ub, kf, Kf, u, xn);
      ns.st.get(stage, Staged::vX, xb);
      if (write) {
#pragma unroll
        for (int i = 0; i < NU; ++i) u_at(t, i) = u[i];
#pragma unroll
        for (int i = 0; i < NX; ++i) x_at(t + 1, i) = xn[i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) x[i] = xn[i];
    }
    return J + terminal_cost(c, x);
  }
};

template <typename T, class M, bool TRACK>
__global__ void __launch_bounds__(kThreads) clddp_solve_kernel(
    T* __restrict__ X, T* __restrict__ U, T* __restrict__ k, T* __restrict__ K,
    T* __restrict__ stats, const T* __restrict__ refs,
    const __grid_constant__ Consts<T, M> c, const SolveCfg<T> cfg, int N, int B) {
  extern __shared__ __align__(16) unsigned char cddp_smem[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  using Sv = Solver<T, M, TRACK>;
  const Sv s{c, refs, X, U, k, K, size_t(B), b, N,
             typename Sv::Staged{Sv::Staged::Stage::make(cddp_smem), X, U, k, K, size_t(B), b}};

  T cost = s.initial_cost();
  T reg = cfg.reg0, inf_du = T(INFINITY), alpha_pr = T(1);
  // Work done, for the operation count of a roofline bound: backward
  // attempts and rollouts (trials and the accepted step's rewrite).
  int attempts = 0, rollouts = 0;
  int it = 0, status = kMaxIter;

  for (int iter = 0; iter < cfg.max_iterations; ++iter) {
    ++it;
    // Backward pass with regularization retry (cddp_solver_base.cpp:94-111).
    T dv0 = T(0), dv1 = T(0);
    bool bp_limit = false;
    for (int attempt = 0; attempt < cfg.bp_bound; ++attempt) {
      T qerr, nvx;
      const bool ok = s.backward(reg, dv0, dv1, qerr, nvx);
      ++attempts;
      const T scaling = nan_max(T(cfg.s_max), nvx / T(N * M::NX)) / cfg.s_max;
      inf_du = qerr / scaling;
      const T reg_next = ok ? reg : nan_min(reg * cfg.reg_uf, cfg.reg_max);
      const bool limit = !ok && reg_next >= cfg.reg_max;
      reg = reg_next;
      if (ok || limit) {
        bp_limit = limit;
        break;
      }
    }
    if (bp_limit) {
      // Regularization exhausted -> not converged (cddp_solver_base.cpp:200-204).
      status = kRegLimit;
      break;
    }

    // Early convergence on inf_du (clddp_solver.cpp:206-213), else the
    // Armijo line search (alpha ladder generated as line_search_alphas).
    const bool early = inf_du < cfg.tolerance;
    bool fp_ok = false;
    T J_new = T(INFINITY), alpha_new = T(1);
    if (!early) {
      T alpha = cfg.a0;
      for (int ia = 0; ia < cfg.n_alpha; ++ia) {
        const T J = s.rollout(alpha, cfg.integrator, false);
        ++rollouts;
        const T dJ = cost - J;
        const T expected = -alpha * (dv0 + T(0.5) * alpha * dv1);
        // jnp.sign as a where-chain: +-1, +-0 on zero, NaN propagates.
        const T sign_dJ = dJ > T(0) ? T(1) : (dJ < T(0) ? T(-1) : dJ * T(0));
        const T ratio = expected > T(0) ? dJ / expected : sign_dJ;
        const bool accept = ratio > cfg.armijo;
        const bool take = accept && (!cfg.parallel_ls || J < J_new);
        if (take) {
          J_new = J;
          alpha_new = alpha;
          fp_ok = true;
          if (!cfg.parallel_ls) break;
        }
        const T a_next = alpha * cfg.a_r;
        alpha = a_next < cfg.a_min ? cfg.a_min : a_next;
      }
      if (fp_ok) {
        s.rollout(alpha_new, cfg.integrator, true);
        ++rollouts;
      }
    }

    const T dJ = cost - J_new;
    const T reg_new = fp_ok ? nan_max(reg / cfg.reg_uf, cfg.reg_min)
                            : (early ? reg : nan_min(reg * cfg.reg_uf, cfg.reg_max));
    const bool fp_limit = !fp_ok && !early && reg_new >= cfg.reg_max;
    const bool conv_acc = fp_ok && dJ > T(0) && dJ < cfg.acceptable_tolerance;
    if (fp_ok) {
      cost = J_new;
      alpha_pr = alpha_new;
    }
    reg = reg_new;
    status = early ? kOptimal : (conv_acc ? kAcceptable : (fp_limit ? kRegLimit : status));
    if (early || conv_acc || fp_limit) break;
  }

  const size_t Bs = B;
  stats[b] = cost;
  stats[Bs + b] = inf_du;
  stats[2 * Bs + b] = reg;
  stats[3 * Bs + b] = alpha_pr;
  stats[4 * Bs + b] = T(it);
  stats[5 * Bs + b] = T(status);
  stats[6 * Bs + b] = T(attempts);
  stats[7 * Bs + b] = T(rollouts);
}

template <typename T, class M>
constexpr int clddp_solve_smem() {
  return stage_bytes<T>(NominalStage<T, M::NX, M::NU>::kValues, kThreads);
}

template <typename T, class M, bool TRACK>
int launch_clddp_solve(T* X, T* U, T* k, T* K, T* stats, const T* refs,
                       const double* consts, const double* cfg, int N, int B, int integrator,
                       int max_iterations, int n_alpha, int bp_bound,
                       int parallel_ls, cudaStream_t stream) {
  const Consts<T, M> c = Consts<T, M>::from_host(consts);
  const SolveCfg<T> sc = SolveCfg<T>::from_host(cfg, max_iterations, n_alpha,
                                                bp_bound, parallel_ls, integrator);
  const int blocks = (B + kThreads - 1) / kThreads;
  const int smem = clddp_solve_smem<T, M>();
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)clddp_solve_kernel<T, M, TRACK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  clddp_solve_kernel<T, M, TRACK><<<blocks, kThreads, smem, stream>>>(X, U, k, K, stats, refs, c,
                                                                       sc, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// The goal form and (TRACK true, suffix _track) the tracking form; `refs`
// is the shared (N, nx) reference, NULL and unread in the goal form.
#define CDDP_CLDDP_SOLVE(MODEL, STRUCT, TRACK, SUFFIX)                                   \
  extern "C" int CDDP_EXPORT(cddp_clddp_solve_##MODEL##SUFFIX)(                          \
      scalar_t* X, scalar_t* U, scalar_t* k, scalar_t* K, scalar_t* stats,               \
      const scalar_t* refs, const double* consts, const double* cfg, int N, int B,       \
      int integrator, int max_iterations, int n_alpha, int bp_bound, int parallel_ls,    \
      void* stream) {                                                                    \
    return cddp::launch_clddp_solve<scalar_t, cddp::STRUCT, TRACK>(                      \
        X, U, k, K, stats, refs, consts, cfg, N, B, integrator, max_iterations, n_alpha, \
        bp_bound, parallel_ls, static_cast<cudaStream_t>(stream));                       \
  }                                                                                      \
  CDDP_REGISTER(cddp_clddp_solve_##MODEL##SUFFIX,                                        \
                (cddp::clddp_solve_kernel<scalar_t, cddp::STRUCT, TRACK>), cddp::kThreads, \
                (cddp::clddp_solve_smem<scalar_t, cddp::STRUCT>()))

// The models of rollout.CLDDP_MODELS (goal form) and
// rollout.CLDDP_TRACK_MODELS (tracking form); each one's staging fits a
// block's shared memory in both types. The Euler and quaternion attitude
// models (nu = 3) walk their BoxQP's 27 active sets in the runtime loop
// (clddp_step.cuh); the MRP model is left out (ROADMAP C.12).
CDDP_CLDDP_SOLVE(unicycle, Unicycle, false, )
CDDP_CLDDP_SOLVE(unicycle, Unicycle, true, _track)
CDDP_CLDDP_SOLVE(pendulum, Pendulum, false, )
CDDP_CLDDP_SOLVE(pendulum, Pendulum, true, _track)
CDDP_CLDDP_SOLVE(cartpole, CartPole, false, )
CDDP_CLDDP_SOLVE(cartpole, CartPole, true, _track)
CDDP_CLDDP_SOLVE(euler_attitude, EulerAttitude, false, )
CDDP_CLDDP_SOLVE(quaternion_attitude, QuaternionAttitude, false, )
static_assert(cddp::clddp_solve_smem<double, cddp::Unicycle>() <= 232448 &&
                  cddp::clddp_solve_smem<double, cddp::Pendulum>() <= 232448 &&
                  cddp::clddp_solve_smem<double, cddp::CartPole>() <= 232448 &&
                  cddp::clddp_solve_smem<double, cddp::QuaternionAttitude>() <= 232448,
              "a block's staging must fit its shared memory");
