// Open-loop rollout X[t+1] = f_d(X[t], U[t]): one thread per instance.
//
// Replaces cddp_tpu/ops/pallas/ip_rollout.py::_make_ol_kernel (:612), the
// rollout that seeds every solve (the IPDDP cold start rolls X out of U0).
// Each thread carries its state in registers across the horizon and takes
// one explicit integrator step (models.cuh) per time step, or a discrete
// model's exact map (ip_rollout.py:626-629; the car).
//
// Bound: device memory. Per instance and step it reads nu values of U and
// writes nx of X (5 values at the unicycle's nx=3, nu=2, 3 at the
// pendulum's, 9 at HCW's nx=6, nu=3) against a few dozen flops and at most
// one sin/cos pair. U and X are batch-last, so the loads
// and stores of a warp are coalesced.
#include "models.cuh"

namespace cddp {

// The model's constants: the timestep and the parameter vector.
template <typename T, class M>
struct ModelConsts {
  T dt;
  T p[M::NP > 0 ? M::NP : 1];

  static ModelConsts from_host(const double* h) {
    ModelConsts c{};
    c.dt = T(h[0]);
    for (int i = 0; i < M::NP; ++i) c.p[i] = T(h[1 + i]);
    return c;
  }
};

template <typename T, class M>
__global__ void __launch_bounds__(kThreads) open_loop_rollout_kernel(
    const T* __restrict__ U, const T* __restrict__ x0, T* __restrict__ X,
    const __grid_constant__ ModelConsts<T, M> c, int N, int B, int integrator) {
  constexpr int NX = M::NX, NU = M::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = B;
  T x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[i * Bs + b];
  for (int t = 0; t < N; ++t) {
    T u[NU], xn[NX];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = U[(size_t(t) * NU + i) * Bs + b];
    integrate<T, M>(integrator, x, u, c.p, c.dt, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      X[(size_t(t) * NX + i) * Bs + b] = xn[i];
      x[i] = xn[i];
    }
  }
}

template <typename T, class M>
int launch_open_loop_rollout(const T* U, const T* x0, T* X, const double* consts,
                             int N, int B, int integrator, cudaStream_t stream) {
  const ModelConsts<T, M> c = ModelConsts<T, M>::from_host(consts);
  const int blocks = (B + kThreads - 1) / kThreads;
  open_loop_rollout_kernel<T, M><<<blocks, kThreads, 0, stream>>>(U, x0, X, c, N, B,
                                                                  integrator);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

#define CDDP_OPEN_LOOP_ROLLOUT(MODEL, STRUCT)                                          \
  extern "C" int CDDP_EXPORT(cddp_open_loop_rollout_##MODEL)(                          \
      const scalar_t* U, const scalar_t* x0, scalar_t* X, const double* consts, int N, \
      int B, int integrator, void* stream) {                                           \
    return cddp::launch_open_loop_rollout<scalar_t, cddp::STRUCT>(                     \
        U, x0, X, consts, N, B, integrator, static_cast<cudaStream_t>(stream));        \
  }                                                                                    \
  CDDP_REGISTER(cddp_open_loop_rollout_##MODEL,                                        \
                (cddp::open_loop_rollout_kernel<scalar_t, cddp::STRUCT>), cddp::kThreads, 0)

// Every model of the registry.
CDDP_OPEN_LOOP_ROLLOUT(unicycle, Unicycle)
CDDP_OPEN_LOOP_ROLLOUT(pendulum, Pendulum)
CDDP_OPEN_LOOP_ROLLOUT(cartpole, CartPole)
CDDP_OPEN_LOOP_ROLLOUT(hcw, HCW)
CDDP_OPEN_LOOP_ROLLOUT(car, Car)
CDDP_OPEN_LOOP_ROLLOUT(forklift, Forklift)
CDDP_OPEN_LOOP_ROLLOUT(quadrotor, Quadrotor)
CDDP_OPEN_LOOP_ROLLOUT(quadrotor_rate, QuadrotorRate)
CDDP_OPEN_LOOP_ROLLOUT(euler_attitude, EulerAttitude)
CDDP_OPEN_LOOP_ROLLOUT(quaternion_attitude, QuaternionAttitude)
CDDP_OPEN_LOOP_ROLLOUT(mrp_attitude, MrpAttitude)
