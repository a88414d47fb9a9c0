// Closed-loop line-search rollout: one thread per problem instance.
//
// Replaces cddp_tpu/ops/pallas/rollout.py::make_forward_kernel (:616). Per
// time step: u = clamp(Ub + alpha*k + K (x - Xb)), the quadratic running
// cost, one explicit integrator step; the terminal cost closes the sum.
// The state and cost live in registers for the whole horizon.
//
// Bound: device memory (13 values read and 5 written per instance and step
// at nx=3, nu=2, against a few dozen flops). Trajectories are batch-last,
// so warps read and write consecutive addresses; the problem constants are
// a by-value kernel parameter, read from the constant bank.
//
// A discrete model (the car) takes its exact map in place of the integrator
// step (rollout.py:680-683; models.cuh::integrate); its rollout reads and
// writes 22 values a step at nx=4, nu=2 (Xb, Ub, k, K in; X, U out).
//
// TRACK (the `_track` launchers) is the tracking variant (rollout.py:618,
// the refs row at :669-670): step t's running cost tracks row t of the
// shared (N, nx) reference `refs` (models.cuh::running_ref); the terminal
// cost tracks the goal in both forms.
#include "models.cuh"

namespace cddp {

template <typename T, class M, bool TRACK>
__global__ void __launch_bounds__(kThreads) forward_rollout_kernel(
    const T* __restrict__ Xb, const T* __restrict__ Ub, const T* __restrict__ kk,
    const T* __restrict__ KK, const T* __restrict__ x0, const T* __restrict__ alpha,
    T* __restrict__ Xo, T* __restrict__ Uo, T* __restrict__ Jo,
    const T* __restrict__ refs, const __grid_constant__ Consts<T, M> c, int N, int B,
    int integrator, int clamp) {
  constexpr int NX = M::NX, NU = M::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = B;
  const T a = alpha[b];
  T x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[i * Bs + b];
  T J = T(0);

  for (int t = 0; t < N; ++t) {
    T xb[NX], ub[NU], kf[NU], Kf[NU][NX], u[NU], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xb[i] = Xb[(size_t(t) * NX + i) * Bs + b];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      ub[i] = Ub[(size_t(t) * NU + i) * Bs + b];
      kf[i] = kk[(size_t(t) * NU + i) * Bs + b];
#pragma unroll
      for (int j = 0; j < NX; ++j) Kf[i][j] = KK[((size_t(t) * NU + i) * NX + j) * Bs + b];
    }
    T rf[NX];
    running_ref<TRACK>(c, refs, t, rf);
    J = J + rollout_step<T, M>(c, rf, integrator, clamp != 0, a, x, xb, ub, kf, Kf, u, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      Xo[(size_t(t) * NX + i) * Bs + b] = xn[i];
      x[i] = xn[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) Uo[(size_t(t) * NU + i) * Bs + b] = u[i];
  }
  Jo[b] = J + terminal_cost(c, x);
}

template <typename T, class M, bool TRACK>
int launch_forward_rollout(const T* Xb, const T* Ub, const T* k, const T* K,
                           const T* x0, const T* alpha, T* X, T* U, T* J, const T* refs,
                           const double* consts, int N, int B, int integrator,
                           int clamp, cudaStream_t stream) {
  const Consts<T, M> c = Consts<T, M>::from_host(consts);
  const int blocks = (B + kThreads - 1) / kThreads;
  forward_rollout_kernel<T, M, TRACK><<<blocks, kThreads, 0, stream>>>(
      Xb, Ub, k, K, x0, alpha, X, U, J, refs, c, N, B, integrator, clamp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// The goal form and (TRACK true, suffix _track) the tracking form; `refs`
// is the shared (N, nx) reference, NULL and unread in the goal form.
#define CDDP_FORWARD_ROLLOUT(MODEL, STRUCT, TRACK, SUFFIX)                               \
  extern "C" int CDDP_EXPORT(cddp_forward_rollout_##MODEL##SUFFIX)(                      \
      const scalar_t* Xb, const scalar_t* Ub, const scalar_t* k, const scalar_t* K,      \
      const scalar_t* x0, const scalar_t* alpha, scalar_t* X, scalar_t* U, scalar_t* J,  \
      const scalar_t* refs, const double* consts, int N, int B, int integrator,          \
      int clamp, void* stream) {                                                         \
    return cddp::launch_forward_rollout<scalar_t, cddp::STRUCT, TRACK>(                  \
        Xb, Ub, k, K, x0, alpha, X, U, J, refs, consts, N, B, integrator, clamp,         \
        static_cast<cudaStream_t>(stream));                                              \
  }                                                                                      \
  CDDP_REGISTER(cddp_forward_rollout_##MODEL##SUFFIX,                                    \
                (cddp::forward_rollout_kernel<scalar_t, cddp::STRUCT, TRACK>),           \
                cddp::kThreads, 0)

// The models of rollout.ROLLOUT_MODELS (goal form) and
// rollout.CLDDP_TRACK_MODELS (tracking form).
CDDP_FORWARD_ROLLOUT(unicycle, Unicycle, false, )
CDDP_FORWARD_ROLLOUT(unicycle, Unicycle, true, _track)
CDDP_FORWARD_ROLLOUT(pendulum, Pendulum, false, )
CDDP_FORWARD_ROLLOUT(pendulum, Pendulum, true, _track)
CDDP_FORWARD_ROLLOUT(cartpole, CartPole, false, )
CDDP_FORWARD_ROLLOUT(cartpole, CartPole, true, _track)
CDDP_FORWARD_ROLLOUT(car, Car, false, )
CDDP_FORWARD_ROLLOUT(quadrotor, Quadrotor, false, )
CDDP_FORWARD_ROLLOUT(quadrotor_rate, QuadrotorRate, false, )
CDDP_FORWARD_ROLLOUT(euler_attitude, EulerAttitude, false, )
CDDP_FORWARD_ROLLOUT(quaternion_attitude, QuaternionAttitude, false, )
CDDP_FORWARD_ROLLOUT(mrp_attitude, MrpAttitude, false, )
CDDP_FORWARD_ROLLOUT(sc_linear_fuel, SpacecraftLinearFuel, false, )
CDDP_FORWARD_ROLLOUT(sc_nonlinear, SpacecraftNonlinear, false, )
CDDP_FORWARD_ROLLOUT(sc_landing2d, SpacecraftLanding2D, false, )
CDDP_FORWARD_ROLLOUT(sc_twobody, SpacecraftTwobody, false, )
CDDP_FORWARD_ROLLOUT(bicycle, Bicycle, false, )
CDDP_FORWARD_ROLLOUT(dubins_car, DubinsCar, false, )
CDDP_FORWARD_ROLLOUT(dreyfus_rocket, DreyfusRocket, false, )
CDDP_FORWARD_ROLLOUT(acrobot, Acrobot, false, )
