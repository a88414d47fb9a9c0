// Model device functions and the explicit integrators.
//
// Each registered model (ops/kernels/rollout.py::_REGISTRY) is a struct with
// its dimensions, its parameter count, the continuous dynamics f(x, u, p)
// (cddp_tpu/ops/pallas/rollout.py:49-50) and the analytic Jacobians
// (Fx, Fu) (cddp_tpu/ops/pallas/mega_clddp.py:94-99). integrate() is the
// four explicit steppers with the stage arithmetic of rollout.py:580-613;
// rollout_step() is one closed-loop step with its running cost.
#pragma once

#include "small_linalg.cuh"

namespace cddp {

__device__ __forceinline__ float dsin(float v) { return sinf(v); }
__device__ __forceinline__ double dsin(double v) { return sin(v); }
__device__ __forceinline__ float dcos(float v) { return cosf(v); }
__device__ __forceinline__ double dcos(double v) { return cos(v); }

struct Unicycle {
  static constexpr int NX = 3;
  static constexpr int NU = 2;
  static constexpr int NP = 0;

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p,
                           T (&dx)[NX]) {
    dx[0] = u[0] * dcos(x[2]);
    dx[1] = u[0] * dsin(x[2]);
    dx[2] = u[1];
  }

  template <typename T>
  __device__ static void fxfu(const T (&x)[NX], const T (&u)[NU], const T* p,
                              T (&Fx)[NX][NX], T (&Fu)[NX][NU]) {
    const T s = dsin(x[2]), c = dcos(x[2]);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) Fx[i][j] = T(0);
    Fx[0][2] = -u[0] * s;
    Fx[1][2] = u[0] * c;
    Fu[0][0] = c;
    Fu[0][1] = T(0);
    Fu[1][0] = s;
    Fu[1][1] = T(0);
    Fu[2][0] = T(0);
    Fu[2][1] = T(1);
  }
};

enum Integrator { kEuler = 0, kHeun = 1, kRk3 = 2, kRk4 = 3 };

// One explicit step x -> out; `kind` is uniform across the launch.
template <typename T, class M>
__device__ __forceinline__ void integrate(int kind, const T (&x)[M::NX],
                                          const T (&u)[M::NU], const T* p, T dt,
                                          T (&out)[M::NX]) {
  constexpr int NX = M::NX;
  T k1[NX], k2[NX], k3[NX], k4[NX], xs[NX];
  M::f(x, u, p, k1);
  if (kind == kEuler) {
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = x[i] + dt * k1[i];
  } else if (kind == kHeun) {
#pragma unroll
    for (int i = 0; i < NX; ++i) xs[i] = x[i] + dt * k1[i];
    M::f(xs, u, p, k2);
#pragma unroll
    for (int i = 0; i < NX; ++i) out[i] = x[i] + T(0.5) * dt * (k1[i] + k2[i]);
  } else if (kind == kRk3) {
#pragma unroll
    for (int i = 0; i < NX; ++i) xs[i] = x[i] + T(0.5) * dt * k1[i];
    M::f(xs, u, p, k2);
#pragma unroll
    for (int i = 0; i < NX; ++i) xs[i] = x[i] + dt * (T(2) * k2[i] - k1[i]);
    M::f(xs, u, p, k3);
#pragma unroll
    for (int i = 0; i < NX; ++i)
      out[i] = x[i] + dt / T(6) * (k1[i] + T(4) * k2[i] + k3[i]);
  } else {
#pragma unroll
    for (int i = 0; i < NX; ++i) xs[i] = x[i] + T(0.5) * dt * k1[i];
    M::f(xs, u, p, k2);
#pragma unroll
    for (int i = 0; i < NX; ++i) xs[i] = x[i] + T(0.5) * dt * k2[i];
    M::f(xs, u, p, k3);
#pragma unroll
    for (int i = 0; i < NX; ++i) xs[i] = x[i] + dt * k3[i];
    M::f(xs, u, p, k4);
#pragma unroll
    for (int i = 0; i < NX; ++i)
      out[i] = x[i] + dt / T(6) * (k1[i] + T(2) * k2[i] + T(2) * k3[i] + k4[i]);
  }
}

// Problem constants shared by the whole batch, passed by value as a kernel
// parameter; the layout is LaneConsts.host in ops/kernels/rollout.py.
template <typename T, class M>
struct Consts {
  T dt;
  T Q[M::NX][M::NX];  // dt-prescaled
  T R[M::NU][M::NU];  // dt-prescaled
  T Qf[M::NX][M::NX];
  T goal[M::NX];
  T lb[M::NU];
  T ub[M::NU];
  T p[M::NP > 0 ? M::NP : 1];

  static Consts from_host(const double* h) {
    Consts c{};
    int o = 0;
    c.dt = T(h[o++]);
    for (int i = 0; i < M::NX; ++i)
      for (int j = 0; j < M::NX; ++j) c.Q[i][j] = T(h[o++]);
    for (int i = 0; i < M::NU; ++i)
      for (int j = 0; j < M::NU; ++j) c.R[i][j] = T(h[o++]);
    for (int i = 0; i < M::NX; ++i)
      for (int j = 0; j < M::NX; ++j) c.Qf[i][j] = T(h[o++]);
    for (int i = 0; i < M::NX; ++i) c.goal[i] = T(h[o++]);
    for (int i = 0; i < M::NU; ++i) c.lb[i] = T(h[o++]);
    for (int i = 0; i < M::NU; ++i) c.ub[i] = T(h[o++]);
    for (int i = 0; i < M::NP; ++i) c.p[i] = T(h[o++]);
    return c;
  }
};

// Step t's running reference, as the kernels' TRACK template flag selects
// it. The goal form (TRACK false) is c.goal and never reads `refs`. The
// tracking form reads row t of `refs`, the (N, nx) reference trajectory
// (QuadraticObjective.reference_states rows 0..N-1) that the whole batch
// shares, through the read-only data cache: every thread of a launch reads
// the same N*nx values, so a row costs one cached line per warp. The
// reference is not part of Consts, whose by-value size would grow with N.
// The terminal cost always tracks c.goal.
template <bool TRACK, typename T, class M>
__device__ __forceinline__ void running_ref(const Consts<T, M>& c,
                                            const T* __restrict__ refs, int t,
                                            T (&r)[M::NX]) {
#pragma unroll
  for (int i = 0; i < M::NX; ++i) {
    if constexpr (TRACK) {
      r[i] = __ldg(refs + size_t(t) * M::NX + i);
    } else {
      r[i] = c.goal[i];
    }
  }
}

// e'Qe + u'Ru with e = x - ref (the step's running reference), summed from
// zero (QuadraticObjective, dt-prescaled Q and R).
template <typename T, class M>
__device__ __forceinline__ T running_cost(const Consts<T, M>& c, const T (&ref)[M::NX],
                                          const T (&x)[M::NX], const T (&u)[M::NU]) {
  constexpr int NX = M::NX, NU = M::NU;
  T e[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) e[i] = x[i] - ref[i];
  T s = T(0);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) s = s + e[i] * c.Q[i][j] * e[j];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) s = s + u[i] * c.R[i][j] * u[j];
  return s;
}

template <typename T, class M>
__device__ __forceinline__ T terminal_cost(const Consts<T, M>& c, const T (&x)[M::NX]) {
  T s = T(0);
#pragma unroll
  for (int i = 0; i < M::NX; ++i)
#pragma unroll
    for (int j = 0; j < M::NX; ++j)
      s = s + (x[i] - c.goal[i]) * c.Qf[i][j] * (x[j] - c.goal[j]);
  return s;
}

// One step of a closed-loop line-search rollout: u = ub + alpha*kf +
// Kf (x - xb), clamped to the box when `clamp`; one explicit integrator
// step x -> xn. Returns the running cost of (x, u) against the step's
// reference `ref`. The rollout kernel and the whole-solve kernel both step
// through here, so their trajectories and costs round alike.
template <typename T, class M>
__device__ __forceinline__ T rollout_step(
    const Consts<T, M>& c, const T (&ref)[M::NX], int integrator, bool clamp, T alpha,
    const T (&x)[M::NX],
    const T (&xb)[M::NX], const T (&ub)[M::NU], const T (&kf)[M::NU],
    const T (&Kf)[M::NU][M::NX], T (&u)[M::NU], T (&xn)[M::NX]) {
  constexpr int NX = M::NX, NU = M::NU;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    T ui = ub[i] + alpha * kf[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) ui = ui + Kf[i][j] * (x[j] - xb[j]);
    u[i] = clamp ? nan_min(nan_max(ui, c.lb[i]), c.ub[i]) : ui;
  }
  const T l = running_cost(c, ref, x, u);
  integrate<T, M>(integrator, x, u, c.p, c.dt, xn);
  return l;
}

}  // namespace cddp
