// Interior-point forward trial: one thread per problem instance.
//
// Replaces cddp_tpu/ops/pallas/ip_rollout.py::_make_ip_forward_kernel (:248),
// one trial of the IPDDP line search (the scan body of solvers/ipddp.py
// _forward_pass, ipddp.py:1091-1131). Per time step:
//   dx = x - Xb;  lam = lam + a_pr k_lam + K_lam dx;
//   s = s + a_pr k_s + K_s dx;  y = y + a_du k_y + K_y dx;
//   u = Ub + a_pr k_u + K_u dx;  J += l(x, u);  g = box rows(x, u);
//   optional slack re-closure s := -g where it passes fraction-to-boundary;
//   feasible &= ftb(s) & ftb(y) & all finite;  x = f_d(x, u).
// The state, the cost and the feasibility flag stay in registers for the
// whole horizon.
//
// Bound: device memory. Per instance and step it reads 18 + 6m values of
// nominal trajectory and gains (42 at the box fleet's m=4) and writes
// 2 nx + nu + 3m (20), against about 150 flops and one sin/cos pair. All
// tensors are batch-last, so every load and store of a warp is coalesced;
// the problem constants and box rows are a by-value kernel parameter.
//
// TRACK (the `_track` launchers) is the tracking variant: the JAX kernel's
// "quadratic_track" cost lane (ip_rollout.py:136-163), whose per-step stage
// parameter is the reference row. Step t's running cost tracks row t of the
// shared (N, nx) reference `refs` (models.cuh::running_ref).
//
// Cost (a user cost lane, lanes.cuh) replaces the quadratic cost with the
// lane's Cost::cost(x, u, cp, w, t): cp is each instance's parameters,
// batch-last (n_cp, B), read through the read-only data cache, and w the
// lane's constants (CostArgs, by value). void: the quadratic cost.
//
// The kernel template and its launcher macros; ip_forward.cu instantiates
// it for the registered models, a lane library (ops/kernels/build.py) for a
// header's lanes.
#pragma once

#include "ipddp_step.cuh"
#include "lanes.cuh"
#include "models.cuh"

namespace cddp {

template <typename T, class Mdl, int M, bool TRACK, class Cost = void>
__global__ void __launch_bounds__(kThreads) ip_forward_kernel(
    const T* __restrict__ Xb, const T* __restrict__ Ub, const T* __restrict__ Y,
    const T* __restrict__ S, const T* __restrict__ kuv, const T* __restrict__ Kuv,
    const T* __restrict__ klam, const T* __restrict__ Klam, const T* __restrict__ lam,
    const T* __restrict__ kyv, const T* __restrict__ Kyv, const T* __restrict__ ksv,
    const T* __restrict__ Ksv, const T* __restrict__ x0, const T* __restrict__ apr,
    const T* __restrict__ adu, const T* __restrict__ tauv, const T* __restrict__ socv,
    T* __restrict__ Xo, T* __restrict__ Uo, T* __restrict__ So, T* __restrict__ Yo,
    T* __restrict__ Go, T* __restrict__ Lo, T* __restrict__ Jo, T* __restrict__ Fo,
    const T* __restrict__ refs, const __grid_constant__ Consts<T, Mdl> c,
    const __grid_constant__ BoxRows<T, M, Mdl::NX, Mdl::NU> rows, int N, int B,
    int integrator, int slack_soc, const __grid_constant__ CostArgs<T, Cost> ca) {
  constexpr int NX = Mdl::NX, NU = Mdl::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = B;
  const T a_pr = apr[b], a_du = adu[b], tau = tauv[b];
  const bool soc_on = socv[b] > T(0.5);
  auto at2 = [&](const T* p, int t, int i, int I) { return p[(size_t(t) * I + i) * Bs + b]; };
  auto at3 = [&](const T* p, int t, int i, int j, int I, int J) {
    return p[((size_t(t) * I + i) * J + j) * Bs + b];
  };

  T x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = x0[i * Bs + b];
  T J = T(0);
  bool ok = true;

  for (int t = 0; t < N; ++t) {
    T dx[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = x[i] - at2(Xb, t, i, NX);
    // v + a k + K dx, with the product summed on its own first.
    auto step = [&](const T* v, const T* k, const T* K, int I, int i, T a) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) s = s + at3(K, t, i, j, I, NX) * dx[j];
      return at2(v, t, i, I) + a * at2(k, t, i, I) + s;
    };
    T lam_n[NX], u[NU], s_old[M], s_n[M], y_old[M], y_n[M], g[M], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) lam_n[i] = step(lam, klam, Klam, NX, i, a_pr);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      s_old[i] = at2(S, t, i, M);
      y_old[i] = at2(Y, t, i, M);
      s_n[i] = step(S, ksv, Ksv, M, i, a_pr);
      y_n[i] = step(Y, kyv, Kyv, M, i, a_du);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = step(Ub, kuv, Kuv, NU, i, a_pr);
    if constexpr (std::is_void_v<Cost>) {
      T rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
      J = J + running_cost(c, rf, x, u);
    } else {
      J = J + Cost::cost(x, u, LaneParams<T>{ca.cp, Bs, b, ca.ncp}, ca.w, t);
    }
    rows.eval(x, u, g);
    if (slack_soc) {
#pragma unroll
      for (int i = 0; i < M; ++i)
        s_n[i] = (soc_on && ftb_ok(-g[i], s_old[i], tau)) ? -g[i] : s_n[i];
    }
    integrate<T, Mdl>(integrator, x, u, c.p, c.dt, xn);
#pragma unroll
    for (int i = 0; i < M; ++i)
      ok = ok & ftb_ok(s_n[i], s_old[i], tau) & ftb_ok(y_n[i], y_old[i], tau) &
           isfinite(s_n[i]) & isfinite(y_n[i]);
#pragma unroll
    for (int i = 0; i < NX; ++i) ok = ok & isfinite(xn[i]) & isfinite(lam_n[i]);
#pragma unroll
    for (int i = 0; i < NU; ++i) ok = ok & isfinite(u[i]);

#pragma unroll
    for (int i = 0; i < NX; ++i) {
      Xo[(size_t(t) * NX + i) * Bs + b] = xn[i];
      Lo[(size_t(t) * NX + i) * Bs + b] = lam_n[i];
      x[i] = xn[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) Uo[(size_t(t) * NU + i) * Bs + b] = u[i];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      So[(size_t(t) * M + i) * Bs + b] = s_n[i];
      Yo[(size_t(t) * M + i) * Bs + b] = y_n[i];
      Go[(size_t(t) * M + i) * Bs + b] = g[i];
    }
  }
  Jo[b] = J;
  Fo[b] = ok ? T(1) : T(0);
}

template <typename T, class Mdl, int M, bool TRACK, class Cost = void>
int launch_ip_forward(const T* const* in, T* const* out, const T* refs, const double* consts,
                      const double* rows, int N, int B, int integrator, int slack_soc,
                      cudaStream_t stream, const T* cp = nullptr, int ncp = 0,
                      const double* weights = nullptr) {
  const Consts<T, Mdl> c = Consts<T, Mdl>::from_host(consts);
  const auto r = BoxRows<T, M, Mdl::NX, Mdl::NU>::from_host(rows);
  const auto ca = CostArgs<T, Cost>::from_host(cp, ncp, weights);
  const int blocks = (B + kThreads - 1) / kThreads;
  ip_forward_kernel<T, Mdl, M, TRACK, Cost><<<blocks, kThreads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10],
      in[11], in[12], in[13], in[14], in[15], in[16], in[17], out[0], out[1], out[2],
      out[3], out[4], out[5], out[6], out[7], refs, c, r, N, B, integrator, slack_soc, ca);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// m (ip_rollout.KERNEL_ROWS): a control box (4), a state box (6) or both
// (10) on the unicycle, the control box on the pendulum (2), on HCW (6) and
// on the quadrotor (8: its four rotor forces), and in the goal form only the
// car's control box (4, its exact map in place of the integrator step,
// ip_rollout.py:341-344), QuadrotorRate's thrust and rate box (8) and the
// attitude trio's torque box (6), the thrust boxes of the other spacecraft
// models (6), the lander's thrust and gimbal box (4) and the small models'
// control boxes (the bicycle's 4, the others' 2);
// the goal form and (TRACK true, suffix _track) the tracking form, whose
// `refs` is the shared (N, nx) reference (NULL and unread in the goal form).
#define CDDP_IP_FORWARD(MODEL, STRUCT, M, TRACK, SUFFIX)                               \
  extern "C" int CDDP_EXPORT(cddp_ip_forward_##MODEL##_m##M##SUFFIX)(                  \
      const scalar_t* Xb, const scalar_t* Ub, const scalar_t* Y, const scalar_t* S,    \
      const scalar_t* ku, const scalar_t* Ku, const scalar_t* klam,                    \
      const scalar_t* Klam, const scalar_t* lam, const scalar_t* ky,                   \
      const scalar_t* Ky, const scalar_t* ks, const scalar_t* Ks, const scalar_t* x0,  \
      const scalar_t* apr, const scalar_t* adu, const scalar_t* tau,                   \
      const scalar_t* soc, scalar_t* X, scalar_t* U, scalar_t* So, scalar_t* Yo,       \
      scalar_t* G, scalar_t* L, scalar_t* J, scalar_t* F, const scalar_t* refs,        \
      const double* consts, const double* rows, int N, int B, int integrator,          \
      int slack_soc, void* stream) {                                                   \
    const scalar_t* in[18] = {Xb, Ub, Y,  S,  ku, Ku, klam, Klam, lam,                 \
                              ky, Ky, ks, Ks, x0, apr, adu, tau, soc};                 \
    scalar_t* out[8] = {X, U, So, Yo, G, L, J, F};                                     \
    return cddp::launch_ip_forward<scalar_t, cddp::STRUCT, M, TRACK>(                  \
        in, out, refs, consts, rows, N, B, integrator, slack_soc,                      \
        static_cast<cudaStream_t>(stream));                                            \
  }                                                                                    \
  CDDP_REGISTER(cddp_ip_forward_##MODEL##_m##M##SUFFIX,                                \
                (cddp::ip_forward_kernel<scalar_t, cddp::STRUCT, M, TRACK>),           \
                cddp::kThreads, 0)

// A cost lane COST_STRUCT (lanes.cuh) on the model STRUCT's control box of m
// rows, goal form: launcher cddp_ip_forward_<MODEL>_<COST>_m<M>, which takes
// the instances' cost parameters cp (n_cp, B) and the lane's weights after
// the quadratic form's tensors.
#define CDDP_IP_FORWARD_LANE(MODEL, STRUCT, COST, COST_STRUCT, M)                       \
  extern "C" int CDDP_EXPORT(cddp_ip_forward_##MODEL##_##COST##_m##M)(                 \
      const scalar_t* Xb, const scalar_t* Ub, const scalar_t* Y, const scalar_t* S,    \
      const scalar_t* ku, const scalar_t* Ku, const scalar_t* klam,                    \
      const scalar_t* Klam, const scalar_t* lam, const scalar_t* ky,                   \
      const scalar_t* Ky, const scalar_t* ks, const scalar_t* Ks, const scalar_t* x0,  \
      const scalar_t* apr, const scalar_t* adu, const scalar_t* tau,                   \
      const scalar_t* soc, scalar_t* X, scalar_t* U, scalar_t* So, scalar_t* Yo,       \
      scalar_t* G, scalar_t* L, scalar_t* J, scalar_t* F, const scalar_t* cp, int ncp, \
      const double* weights, const double* consts, const double* rows, int N, int B,   \
      int integrator, int slack_soc, void* stream) {                                   \
    const scalar_t* in[18] = {Xb, Ub, Y,  S,  ku, Ku, klam, Klam, lam,                 \
                              ky, Ky, ks, Ks, x0, apr, adu, tau, soc};                 \
    scalar_t* out[8] = {X, U, So, Yo, G, L, J, F};                                     \
    return cddp::launch_ip_forward<scalar_t, cddp::STRUCT, M, false, cddp::COST_STRUCT>( \
        in, out, nullptr, consts, rows, N, B, integrator, slack_soc,                   \
        static_cast<cudaStream_t>(stream), cp, ncp, weights);                          \
  }                                                                                    \
  CDDP_REGISTER(cddp_ip_forward_##MODEL##_##COST##_m##M,                               \
                (cddp::ip_forward_kernel<scalar_t, cddp::STRUCT, M, false,             \
                                         cddp::COST_STRUCT>),                          \
                cddp::kThreads, 0)
