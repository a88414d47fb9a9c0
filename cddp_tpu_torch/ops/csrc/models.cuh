// Model device functions and the explicit integrators.
//
// Each registered model (ops/kernels/rollout.py::_REGISTRY) is a struct with
// its dimensions, its parameter count NP (the registry's parameter vector,
// in the JAX lane order), the continuous dynamics f(x, u, p)
// (cddp_tpu/ops/pallas/rollout.py:49-72, :173-180, :259-264) and the analytic
// Jacobians (Fx, Fu) (cddp_tpu/ops/pallas/mega_clddp.py:94-205): the TPU
// kernels' model lanes. A discrete model (DISCRETE true: the car) has
// instead step(x, u, p, dt, out), its exact map (rollout.py:183-194), which
// integrate() takes in place of a stepper, so every kernel that steps a
// model (the rollouts, the interior-point forward pass) gets the branch
// from one place, as the TPU kernels take it (rollout.py:680-683,
// ip_rollout.py:341-344, :626-629). No whole-solve kernel is built for a
// discrete model: they need fxfu. Each writes the port's plain model's expressions in
// its order of operations, so that the float64 build (--fmad=false) rounds
// like it: the pendulum's analytic Jacobians are the JAX model's
// (pendulum.py:41-57), not the lane's g*cos/l; the cart-pole's and HCW's
// are what forward-mode AD of their dynamics gives, as the plain models
// take them (the JAX models have no analytic Jacobians).
// integrate() is the four explicit steppers with the stage arithmetic of
// rollout.py:580-613, or a discrete model's map; rollout_step() is one
// closed-loop step with its running cost.
#pragma once

#include <type_traits>

#include "small_linalg.cuh"

namespace cddp {

__device__ __forceinline__ float dsin(float v) { return sinf(v); }
__device__ __forceinline__ double dsin(double v) { return sin(v); }
__device__ __forceinline__ float dcos(float v) { return cosf(v); }
__device__ __forceinline__ double dcos(double v) { return cos(v); }
__device__ __forceinline__ float dtan(float v) { return tanf(v); }
__device__ __forceinline__ double dtan(double v) { return tan(v); }
__device__ __forceinline__ float dasin(float v) { return asinf(v); }
__device__ __forceinline__ double dasin(double v) { return asin(v); }

// Products, sums and differences that nvcc never contracts into a fused
// multiply-add (the float32 build contracts by default): a map with
// cancellation rounds as the plain version's separate torch operations do.
// Host builds (-ffp-contract=off) take the plain operators.
template <typename T>
__device__ __forceinline__ T mul_rn(T a, T b) {
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same_v<T, float>) return __fmul_rn(a, b); else return __dmul_rn(a, b);
#else
  return a * b;
#endif
}
template <typename T>
__device__ __forceinline__ T add_rn(T a, T b) {
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same_v<T, float>) return __fadd_rn(a, b); else return __dadd_rn(a, b);
#else
  return a + b;
#endif
}
template <typename T>
__device__ __forceinline__ T sub_rn(T a, T b) {
#ifdef __CUDA_ARCH__
  if constexpr (std::is_same_v<T, float>) return __fsub_rn(a, b); else return __dsub_rn(a, b);
#else
  return a - b;
#endif
}

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

// p = (length, mass, damping, gravity).
struct Pendulum {
  static constexpr int NX = 2;
  static constexpr int NU = 1;
  static constexpr int NP = 4;

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p,
                           T (&dx)[NX]) {
    const T l = p[0], m = p[1], b = p[2], g = p[3];
    dx[0] = x[1];
    dx[1] = (u[0] - b * x[1] + m * g * l * dsin(x[0])) / (m * l * l);
  }

  template <typename T>
  __device__ static void fxfu(const T (&x)[NX], const T (&u)[NU], const T* p,
                              T (&Fx)[NX][NX], T (&Fu)[NX][NU]) {
    const T l = p[0], m = p[1], b = p[2], g = p[3];
    const T ml2 = m * (l * l);
    Fx[0][0] = T(0);
    Fx[0][1] = T(1);
    Fx[1][0] = (g / l) * dcos(x[0]);
    Fx[1][1] = -b / ml2;
    Fu[0][0] = T(0);
    Fu[1][0] = T(1) / ml2;
  }
};

// p = (cart_mass, pole_mass, pole_length, gravity, damping); x = (x, theta,
// x_dot, theta_dot).
struct CartPole {
  static constexpr int NX = 4;
  static constexpr int NU = 1;
  static constexpr int NP = 5;

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p,
                           T (&dx)[NX]) {
    const T mc = p[0], mp = p[1], l = p[2], g = p[3], b = p[4];
    const T s = dsin(x[1]), c = dcos(x[1]), w2 = x[3] * x[3];
    const T den = mc + mp * s * s;
    dx[0] = x[2];
    dx[1] = x[3];
    dx[2] = (u[0] + mp * s * (l * w2 + g * c)) / den;
    dx[3] = (-u[0] * c - mp * l * w2 * c * s - (mc + mp) * g * s - b * x[3]) / (l * den);
  }

  // Forward-mode AD of f, written out: each product's tangent is a_t b +
  // b_t a, a quotient's (a_t - b_t (a / b)) / b, as the plain model's
  // torch.func.jacfwd computes them (bit for bit on the CPU).
  template <typename T>
  __device__ static void fxfu(const T (&x)[NX], const T (&u)[NU], const T* p,
                              T (&Fx)[NX][NX], T (&Fu)[NX][NU]) {
    const T mc = p[0], mp = p[1], l = p[2], g = p[3], b = p[4];
    const T s = dsin(x[1]), c = dcos(x[1]), w = x[3], F = u[0];
    const T ms = mp * s, inner = l * (w * w) + g * c, q = mp * l * (w * w);
    const T den = mc + ms * s, ld = l * den;
    const T xdd = (F + ms * inner) / den;
    const T tdd = (-F * c - q * c * s - (mc + mp) * g * s - b * w) / ld;
    const T den_t = c * ms + c * mp * s;  // d(den)/dtheta
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) Fx[i][j] = T(0);
    Fx[0][2] = T(1);
    Fx[1][3] = T(1);
    Fx[2][1] = (-s * g * ms + c * mp * inner - den_t * xdd) / den;
    Fx[2][3] = T(2) * w * l * ms / den;
    Fx[3][1] = (-s * -F - (c * (q * c) + -s * q * s) - c * ((mc + mp) * g) - den_t * l * tdd) / ld;
    Fx[3][3] = (-(T(2) * w * (mp * l) * c * s) - b) / ld;
    Fu[0][0] = T(0);
    Fu[1][0] = T(0);
    Fu[2][0] = T(1) / den;
    Fu[3][0] = -c / ld;
  }
};

// Hill-Clohessy-Wiltshire relative motion; p = (mean_motion, mass).
struct HCW {
  static constexpr int NX = 6;
  static constexpr int NU = 3;
  static constexpr int NP = 2;

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p,
                           T (&dx)[NX]) {
    const T n = p[0], mass = p[1];
    dx[0] = x[3];
    dx[1] = x[4];
    dx[2] = x[5];
    dx[3] = T(2) * n * x[4] + T(3) * n * n * x[0] + u[0] / mass;
    dx[4] = T(-2) * n * x[3] + u[1] / mass;
    dx[5] = -n * n * x[2] + u[2] / mass;
  }

  template <typename T>
  __device__ static void fxfu(const T (&x)[NX], const T (&u)[NU], const T* p,
                              T (&Fx)[NX][NX], T (&Fu)[NX][NU]) {
    const T n = p[0], im = T(1) / p[1];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) Fx[i][j] = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) Fu[i][j] = T(0);
    }
    Fx[0][3] = T(1);
    Fx[1][4] = T(1);
    Fx[2][5] = T(1);
    Fx[3][0] = T(3) * n * n;
    Fx[3][4] = T(2) * n;
    Fx[4][3] = T(-2) * n;
    Fx[5][2] = -n * n;
    Fu[3][0] = im;
    Fu[4][1] = im;
    Fu[5][2] = im;
  }
};

// Tassa's car (cddp_tpu/models/car.py:32-46): natively discrete, so it has
// the exact map step() and no f; p = (wheelbase). Over one step of length
// dt the wheels roll f = dt v; the order of operations is the JAX model's
// and the plain model's (models/car.py), and no operation is contracted
// (mul_rn, add_rn, sub_rn): b = d + f cos(delta) - sqrt(d^2 - (f
// sin(delta))^2) cancels to about (f sin(delta))^2 / 2d, so a fused
// multiply-add there put the float32 forward trial at 2.02x the plain
// version's error against float64 on an H100. Where
// |f sin(delta)| > d, sqrt and asin give NaN, as the plain map does:
// nothing is clamped.
struct Car {
  static constexpr int NX = 4;
  static constexpr int NU = 2;
  static constexpr int NP = 1;
  static constexpr bool DISCRETE = true;

  template <typename T>
  __device__ static void step(const T (&x)[NX], const T (&u)[NU], const T* p, T dt,
                              T (&out)[NX]) {
    const T d = p[0];
    const T f = mul_rn(dt, x[3]);
    const T sd = dsin(u[0]);
    const T fs = mul_rn(f, sd);
    const T b = sub_rn(add_rn(d, mul_rn(f, dcos(u[0]))),
                       dsqrt(sub_rn(mul_rn(d, d), mul_rn(fs, fs))));
    const T dtheta = dasin(mul_rn(sd, f) / d);
    out[0] = add_rn(x[0], mul_rn(b, dcos(x[2])));
    out[1] = add_rn(x[1], mul_rn(b, dsin(x[2])));
    out[2] = add_rn(x[2], dtheta);
    out[3] = add_rn(x[3], mul_rn(dt, u[1]));
  }
};

// Kinematic bicycle with the steering angle as a state (forklift.py:24-38);
// p = (wheelbase, steer_sign), steer_sign -1 for a rear-steered truck.
struct Forklift {
  static constexpr int NX = 5;
  static constexpr int NU = 2;
  static constexpr int NP = 2;

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p,
                           T (&dx)[NX]) {
    const T v = x[3];
    dx[0] = v * dcos(x[2]);
    dx[1] = v * dsin(x[2]);
    dx[2] = v * dtan(p[1] * x[4]) / p[0];
    dx[3] = u[0];
    dx[4] = u[1];
  }

  // Forward-mode AD of f, written out as the cart-pole's is: tan's tangent
  // is eff_t (1 + tan^2), a quotient by the constant wheelbase divides the
  // numerator's tangent.
  template <typename T>
  __device__ static void fxfu(const T (&x)[NX], const T (&u)[NU], const T* p,
                              T (&Fx)[NX][NX], T (&Fu)[NX][NU]) {
    const T s = dsin(x[2]), c = dcos(x[2]), v = x[3], L = p[0], sign = p[1];
    const T tn = dtan(sign * x[4]);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) Fx[i][j] = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) Fu[i][j] = T(0);
    }
    Fx[0][2] = -s * v;
    Fx[0][3] = c;
    Fx[1][2] = c * v;
    Fx[1][3] = s;
    Fx[2][3] = tn / L;
    Fx[2][4] = v * (sign * (T(1) + tn * tn)) / L;
    Fu[3][0] = T(1);
    Fu[4][1] = T(1);
  }
};

enum Integrator { kEuler = 0, kHeun = 1, kRk3 = 2, kRk4 = 3 };

// Whether a model struct is discrete (declares DISCRETE true); a struct
// without the member is continuous.
template <class M, class = void>
struct IsDiscrete : std::false_type {};
template <class M>
struct IsDiscrete<M, std::void_t<decltype(M::DISCRETE)>>
    : std::integral_constant<bool, M::DISCRETE> {};

// One step x -> out: a discrete model's exact map, or one explicit
// integrator step; `kind` is uniform across the launch (and unread for a
// discrete model).
template <typename T, class M>
__device__ __forceinline__ void integrate(int kind, const T (&x)[M::NX],
                                          const T (&u)[M::NU], const T* p, T dt,
                                          T (&out)[M::NX]) {
  if constexpr (IsDiscrete<M>::value) {
    M::step(x, u, p, dt, out);
  } else {
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
