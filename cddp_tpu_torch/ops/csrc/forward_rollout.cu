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
#include "models.cuh"

namespace cddp {

template <typename T, class M>
__global__ void __launch_bounds__(kThreads) forward_rollout_kernel(
    const T* __restrict__ Xb, const T* __restrict__ Ub, const T* __restrict__ kk,
    const T* __restrict__ KK, const T* __restrict__ x0, const T* __restrict__ alpha,
    T* __restrict__ Xo, T* __restrict__ Uo, T* __restrict__ Jo,
    const __grid_constant__ Consts<T, M> c, int N, int B, int integrator,
    int clamp) {
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
    J = J + rollout_step<T, M>(c, integrator, clamp != 0, a, x, xb, ub, kf, Kf, u, xn);
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

template <typename T, class M>
int launch_forward_rollout(const T* Xb, const T* Ub, const T* k, const T* K,
                           const T* x0, const T* alpha, T* X, T* U, T* J,
                           const double* consts, int N, int B, int integrator,
                           int clamp, cudaStream_t stream) {
  const Consts<T, M> c = Consts<T, M>::from_host(consts);
  const int blocks = (B + kThreads - 1) / kThreads;
  forward_rollout_kernel<T, M><<<blocks, kThreads, 0, stream>>>(
      Xb, Ub, k, K, x0, alpha, X, U, J, c, N, B, integrator, clamp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

extern "C" int CDDP_EXPORT(cddp_forward_rollout_unicycle)(
    const scalar_t* Xb, const scalar_t* Ub, const scalar_t* k, const scalar_t* K,
    const scalar_t* x0, const scalar_t* alpha, scalar_t* X, scalar_t* U,
    scalar_t* J, const double* consts, int N, int B, int integrator, int clamp,
    void* stream) {
  return cddp::launch_forward_rollout<scalar_t, cddp::Unicycle>(
      Xb, Ub, k, K, x0, alpha, X, U, J, consts, N, B, integrator, clamp,
      static_cast<cudaStream_t>(stream));
}
CDDP_REGISTER(cddp_forward_rollout_unicycle,
              (cddp::forward_rollout_kernel<scalar_t, cddp::Unicycle>), cddp::kThreads, 0)
