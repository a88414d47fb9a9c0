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

// Quadrotor with quaternion attitude and rotor-force controls
// (cddp_tpu_torch/models/quadrotor.py; quadrotor.py:26-78 of the JAX
// package): x = (p, q wxyz, v, omega), u = the four rotor forces. p = (mass,
// arm_length, gravity, I (9, row-major), inv(I) (9, row-major)): the JAX
// lane vector (rollout.py:161-169), then the inverse inertia passed
// precomputed, the plain model's own (Quadrotor.inertia_inverse, LU as the
// JAX model's jnp.linalg.inv), not rebuilt here: the JAX lane's adjugate
// rounds apart from it. The expressions are the plain model's in its order:
// the guarded normalization divides (it does not multiply by an inverse
// norm), q_dot, the body torques, the third column of R, then inv(I) (tau
// - omega x I omega); the cross product and q_dot, whose terms cancel, are
// never contracted (mul_rn, sub_rn). No fxfu: no whole-solve kernel is
// built for it, and the per-pass kernels take A and B from the plain glue.
// Its Consts hold dense 13x13 Q and Qf: 3,176 bytes of kernel parameters
// in float64, within the 32,764 that CUDA 12.1+ allows on sm_70 and newer.
struct Quadrotor {
  static constexpr int NX = 13;
  static constexpr int NU = 4;
  static constexpr int NP = 21;

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p,
                           T (&dx)[NX]) {
    const T mass = p[0], arm = p[1], grav = p[2];
    const T* I = p + 3;
    const T* Ii = p + 12;
    const T wx = x[10], wy = x[11], wz = x[12];
    const T norm = dsqrt(x[3] * x[3] + x[4] * x[4] + x[5] * x[5] + x[6] * x[6]);
    const bool safe = norm > T(1e-6);
    const T den = norm > T(1e-6) ? norm : T(1e-6);
    const T qw = safe ? x[3] / den : T(1), qx = safe ? x[4] / den : T(0);
    const T qy = safe ? x[5] / den : T(0), qz = safe ? x[6] / den : T(0);

    dx[0] = x[7];
    dx[1] = x[8];
    dx[2] = x[9];
    dx[3] = T(0.5) * -add_rn(add_rn(mul_rn(qx, wx), mul_rn(qy, wy)), mul_rn(qz, wz));
    dx[4] = T(0.5) * sub_rn(add_rn(mul_rn(qw, wx), mul_rn(qy, wz)), mul_rn(qz, wy));
    dx[5] = T(0.5) * add_rn(sub_rn(mul_rn(qw, wy), mul_rn(qx, wz)), mul_rn(qz, wx));
    dx[6] = T(0.5) * sub_rn(add_rn(mul_rn(qw, wz), mul_rn(qx, wy)), mul_rn(qy, wx));

    const T f1 = u[0], f2 = u[1], f3 = u[2], f4 = u[3];
    const T thrust = f1 + f2 + f3 + f4;
    const T tau[3] = {arm * (f1 - f3), arm * (f2 - f4), T(0.1) * (f1 - f2 + f3 - f4)};
    const T tm = thrust / mass;
    dx[7] = tm * (T(2) * (qx * qz + qw * qy));
    dx[8] = tm * (T(2) * (qy * qz - qw * qx));
    dx[9] = tm * (T(1) - T(2) * (qx * qx + qy * qy)) - grav;

    T Iw[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) Iw[i] = I[3 * i] * wx + I[3 * i + 1] * wy + I[3 * i + 2] * wz;
    const T r[3] = {tau[0] - sub_rn(mul_rn(wy, Iw[2]), mul_rn(wz, Iw[1])),
                    tau[1] - sub_rn(mul_rn(wz, Iw[0]), mul_rn(wx, Iw[2])),
                    tau[2] - sub_rn(mul_rn(wx, Iw[1]), mul_rn(wy, Iw[0]))};
#pragma unroll
    for (int i = 0; i < 3; ++i)
      dx[10 + i] = Ii[3 * i] * r[0] + Ii[3 * i + 1] * r[1] + Ii[3 * i + 2] * r[2];
  }
};

// Quadrotor with body-rate and collective-thrust controls
// (cddp_tpu_torch/models/quadrotor_rate.py; quadrotor_rate.py:25-46 of the
// JAX package): x = (p, v, q wxyz), u = (thrust, wx, wy, wz); p = (mass,
// gravity). The plain model's order: q divided by its norm without a guard,
// the acceleration R(q) [0, 0, T] / m + [0, 0, -g], whose product is the
// third column of R times T exactly (its other terms are zeros), then
// q_dot = 0.5 Omega(w) q, never contracted. No fxfu, as the quadrotor's.
struct QuadrotorRate {
  static constexpr int NX = 10;
  static constexpr int NU = 4;
  static constexpr int NP = 2;

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p,
                           T (&dx)[NX]) {
    const T mass = p[0], grav = p[1];
    const T norm = dsqrt(x[6] * x[6] + x[7] * x[7] + x[8] * x[8] + x[9] * x[9]);
    const T qw = x[6] / norm, qx = x[7] / norm, qy = x[8] / norm, qz = x[9] / norm;
    const T thrust = u[0], wx = u[1], wy = u[2], wz = u[3];
    dx[0] = x[3];
    dx[1] = x[4];
    dx[2] = x[5];
    dx[3] = T(2) * (qx * qz + qy * qw) * thrust / mass;
    dx[4] = T(2) * (qy * qz - qx * qw) * thrust / mass;
    dx[5] = (T(1) - T(2) * (qx * qx + qy * qy)) * thrust / mass - grav;
    dx[6] = T(0.5) * sub_rn(sub_rn(mul_rn(-wx, qx), mul_rn(wy, qy)), mul_rn(wz, qz));
    dx[7] = T(0.5) * sub_rn(add_rn(mul_rn(wx, qw), mul_rn(wz, qy)), mul_rn(wy, qz));
    dx[8] = T(0.5) * add_rn(sub_rn(mul_rn(wy, qw), mul_rn(wz, qx)), mul_rn(wx, qz));
    dx[9] = T(0.5) * sub_rn(add_rn(mul_rn(wz, qw), mul_rn(wy, qx)), mul_rn(wx, qy));
  }
};

// The rigid-body attitude trio (cddp_tpu_torch/models/attitude.py;
// attitude.py:24-89 of the JAX package), nu = 3 body torques. p = (I (9,
// row-major), the JAX lane vector (rollout.py:547-553); LU (9, row-major) and
// pivots (3, 0-based): the plain model's torch.linalg.lu_factor of I,
// passed precomputed (_RigidBody.lu_factors)). The JAX lane inverts I by its
// adjugate (rollout.py:220-242), which rounds apart from the plain model's
// LU solve; here the plain model's substitution is repeated term by term on
// its own factors, and every sum of products is written in its order and
// never contracted (mul_rn, add_rn, sub_rn), so that f rounds like the
// plain model in both types (Euler's transcendental functions aside).
// fxfu is the analytic continuous Jacobian (the whole solves' Euler
// linearization A = I + dt Fx, B = dt Fu), which the plain model takes by
// forward-mode AD: held to it within rounding, not bit for bit.
namespace rigid {

template <typename T>
__device__ __forceinline__ T dot3(T a0, T b0, T a1, T b1, T a2, T b2) {
  return add_rn(add_rn(mul_rn(a0, b0), mul_rn(a1, b1)), mul_rn(a2, b2));
}

// x with I x = b by the plain model's LU factors and 0-based pivots: the row
// swaps in order, the unit lower factor forward, U backward.
template <typename T>
__device__ __forceinline__ void lu_substitute(const T* p, const T (&b_in)[3], T (&x)[3]) {
  const T* LU = p + 9;
  T b[3] = {b_in[0], b_in[1], b_in[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int j = static_cast<int>(p[18 + i]);
#pragma unroll
    for (int k = i + 1; k < 3; ++k) {
      if (j == k) {
        const T t = b[i];
        b[i] = b[k];
        b[k] = t;
      }
    }
  }
  const T y1 = sub_rn(b[1], mul_rn(LU[3], b[0]));
  const T y2 = sub_rn(sub_rn(b[2], mul_rn(LU[6], b[0])), mul_rn(LU[7], y1));
  x[2] = y2 / LU[8];
  x[1] = sub_rn(y1, mul_rn(LU[5], x[2])) / LU[4];
  x[0] = sub_rn(sub_rn(b[0], mul_rn(LU[1], x[1])), mul_rn(LU[2], x[2])) / LU[0];
}

// d omega / dt = I^-1 (tau - omega x (I omega)).
template <typename T>
__device__ __forceinline__ void omega_dot(const T* p, T wx, T wy, T wz, const T (&u)[3],
                                          T (&out)[3]) {
  T Iw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) Iw[i] = dot3(p[3 * i], wx, p[3 * i + 1], wy, p[3 * i + 2], wz);
  const T b[3] = {sub_rn(u[0], sub_rn(mul_rn(wy, Iw[2]), mul_rn(wz, Iw[1]))),
                  sub_rn(u[1], sub_rn(mul_rn(wz, Iw[0]), mul_rn(wx, Iw[2]))),
                  sub_rn(u[2], sub_rn(mul_rn(wx, Iw[1]), mul_rn(wy, Iw[0])))};
  lu_substitute(p, b, out);
}

// The rotational rows of the Jacobian: d(omega_dot)/d omega into Fx[W + i][W
// + j] and d(omega_dot)/d tau = I^-1 into Fu[W + i][j], where W is the
// first rate's index; column j of the first is I^-1 of -(e_j x I omega +
// omega x I e_j).
template <int NX, typename T>
__device__ __forceinline__ void omega_jacobians(const T* p, int W, T wx, T wy, T wz,
                                                T (&Fx)[NX][NX], T (&Fu)[NX][3]) {
  const T w[3] = {wx, wy, wz};
  T Iw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) Iw[i] = p[3 * i] * wx + p[3 * i + 1] * wy + p[3 * i + 2] * wz;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    T ej[3] = {T(0), T(0), T(0)};
    ej[j] = T(1);
    const T a[3] = {p[j], p[3 + j], p[6 + j]};  // I e_j
    const T m[3] = {-((ej[1] * Iw[2] - ej[2] * Iw[1]) + (w[1] * a[2] - w[2] * a[1])),
                    -((ej[2] * Iw[0] - ej[0] * Iw[2]) + (w[2] * a[0] - w[0] * a[2])),
                    -((ej[0] * Iw[1] - ej[1] * Iw[0]) + (w[0] * a[1] - w[1] * a[0]))};
    T col[3], inv[3];
    lu_substitute(p, m, col);
    lu_substitute(p, ej, inv);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      Fx[W + i][W + j] = col[i];
      Fu[W + i][j] = inv[i];
    }
  }
}

template <int NX, typename T>
__device__ __forceinline__ void zero(T (&Fx)[NX][NX], T (&Fu)[NX][3]) {
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) Fx[i][j] = T(0);
#pragma unroll
    for (int j = 0; j < 3; ++j) Fu[i][j] = T(0);
  }
}

}  // namespace rigid

// ZYX Euler angles and body rates, x = (psi, theta, phi, omega): the JAX
// model's guard on cos(theta) (sign(c) 1e-9 + [c == 0] 1e-9 where |c| <
// 1e-9); tan(theta) as the model takes it (the JAX lane's sin/cos is
// Mosaic's want of a tan).
struct EulerAttitude {
  static constexpr int NX = 6;
  static constexpr int NU = 3;
  static constexpr int NP = 21;

  template <typename T>
  __device__ static T c_safe(T c) {
    if (dabs(c) < T(1e-9)) {
      const T sign = c > T(0) ? T(1) : (c < T(0) ? T(-1) : T(0));
      return sign * T(1e-9) + (c == T(0) ? T(1) : T(0)) * T(1e-9);
    }
    return c;
  }

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p, T (&dx)[NX]) {
    const T wx = x[3], wy = x[4], wz = x[5];
    const T cph = dcos(x[2]), sph = dsin(x[2]);
    const T tth = dtan(x[1]), cs = c_safe(dcos(x[1]));
    dx[0] = add_rn(mul_rn(sph / cs, wy), mul_rn(cph / cs, wz));
    dx[1] = sub_rn(mul_rn(cph, wy), mul_rn(sph, wz));
    dx[2] = add_rn(add_rn(wx, mul_rn(mul_rn(sph, tth), wy)), mul_rn(mul_rn(cph, tth), wz));
    T wd[3];
    rigid::omega_dot(p, wx, wy, wz, u, wd);
    dx[3] = wd[0];
    dx[4] = wd[1];
    dx[5] = wd[2];
  }

  template <typename T>
  __device__ static void fxfu(const T (&x)[NX], const T (&u)[NU], const T* p,
                              T (&Fx)[NX][NX], T (&Fu)[NX][NU]) {
    const T wx = x[3], wy = x[4], wz = x[5];
    const T cph = dcos(x[2]), sph = dsin(x[2]);
    const T cth = dcos(x[1]), tth = dtan(x[1]);
    const T cs = c_safe(cth);
    const bool guarded = dabs(cth) < T(1e-9);
    rigid::zero<NX>(Fx, Fu);
    const T a = sph * wy + cph * wz, d = cph * wy - sph * wz;
    Fx[0][1] = guarded ? T(0) : a * dsin(x[1]) / (cs * cs);
    Fx[0][2] = d / cs;
    Fx[0][4] = sph / cs;
    Fx[0][5] = cph / cs;
    Fx[1][2] = -sph * wy - cph * wz;
    Fx[1][4] = cph;
    Fx[1][5] = -sph;
    Fx[2][1] = a * (T(1) + tth * tth);
    Fx[2][2] = d * tth;
    Fx[2][3] = T(1);
    Fx[2][4] = sph * tth;
    Fx[2][5] = cph * tth;
    rigid::omega_jacobians<NX>(p, 3, wx, wy, wz, Fx, Fu);
  }
};

// Quaternion [w, x, y, z] and body rates: q divided by its norm (the
// clamped norm, as the model's torch.clamp), (1, 0, 0, 0) at a norm of 1e-9
// or less; q_dot = 0.5 Omega(omega) q.
struct QuaternionAttitude {
  static constexpr int NX = 7;
  static constexpr int NU = 3;
  static constexpr int NP = 21;

  // The normalized quaternion; returns the norm, 0 where the guard holds.
  template <typename T>
  __device__ static T unit(const T (&x)[NX], T (&q)[4]) {
    const T n = dsqrt(add_rn(add_rn(add_rn(mul_rn(x[0], x[0]), mul_rn(x[1], x[1])),
                                    mul_rn(x[2], x[2])), mul_rn(x[3], x[3])));
    const bool safe = n > T(1e-9);
    const T den = safe ? n : T(1e-9);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = safe ? x[i] / den : (i == 0 ? T(1) : T(0));
    return safe ? n : T(0);
  }

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p, T (&dx)[NX]) {
    const T wx = x[4], wy = x[5], wz = x[6];
    T q[4];
    unit(x, q);
    dx[0] = T(0.5) * sub_rn(sub_rn(mul_rn(-wx, q[1]), mul_rn(wy, q[2])), mul_rn(wz, q[3]));
    dx[1] = T(0.5) * sub_rn(add_rn(mul_rn(wx, q[0]), mul_rn(wz, q[2])), mul_rn(wy, q[3]));
    dx[2] = T(0.5) * add_rn(sub_rn(mul_rn(wy, q[0]), mul_rn(wz, q[1])), mul_rn(wx, q[3]));
    dx[3] = T(0.5) * sub_rn(add_rn(mul_rn(wz, q[0]), mul_rn(wy, q[1])), mul_rn(wx, q[2]));
    T wd[3];
    rigid::omega_dot(p, wx, wy, wz, u, wd);
    dx[4] = wd[0];
    dx[5] = wd[1];
    dx[6] = wd[2];
  }

  template <typename T>
  __device__ static void fxfu(const T (&x)[NX], const T (&u)[NU], const T* p,
                              T (&Fx)[NX][NX], T (&Fu)[NX][NU]) {
    const T wx = x[4], wy = x[5], wz = x[6];
    T q[4];
    const T n = unit(x, q);
    rigid::zero<NX>(Fx, Fu);
    // Omega(omega), q_dot = 0.5 Omega q.
    const T Om[4][4] = {{T(0), -wx, -wy, -wz}, {wx, T(0), wz, -wy},
                        {wy, -wz, T(0), wx}, {wz, wy, -wx, T(0)}};
    if (n > T(0)) {
      // d q_dot / d q_j = (0.5 Omega e_j - q_dot q_j) / n.
      T qd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qd[i] = T(0.5) * (Om[i][0] * q[0] + Om[i][1] * q[1] + Om[i][2] * q[2] + Om[i][3] * q[3]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) Fx[i][j] = (T(0.5) * Om[i][j] - qd[i] * q[j]) / n;
    }
    // d q_dot / d omega.
    Fx[0][4] = T(-0.5) * q[1];
    Fx[0][5] = T(-0.5) * q[2];
    Fx[0][6] = T(-0.5) * q[3];
    Fx[1][4] = T(0.5) * q[0];
    Fx[1][5] = T(-0.5) * q[3];
    Fx[1][6] = T(0.5) * q[2];
    Fx[2][4] = T(0.5) * q[3];
    Fx[2][5] = T(0.5) * q[0];
    Fx[2][6] = T(-0.5) * q[1];
    Fx[3][4] = T(-0.5) * q[2];
    Fx[3][5] = T(0.5) * q[1];
    Fx[3][6] = T(0.5) * q[0];
    rigid::omega_jacobians<NX>(p, 4, wx, wy, wz, Fx, Fu);
  }
};

// Modified Rodrigues parameters and body rates: sigma_dot = 0.25 B(s) omega,
// B = (1 - s's) I + 2 skew(s) + 2 s s'.
struct MrpAttitude {
  static constexpr int NX = 6;
  static constexpr int NU = 3;
  static constexpr int NP = 21;

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p, T (&dx)[NX]) {
    const T s0 = x[0], s1 = x[1], s2 = x[2], wx = x[3], wy = x[4], wz = x[5];
    const T c = T(1) - add_rn(add_rn(mul_rn(s0, s0), mul_rn(s1, s1)), mul_rn(s2, s2));
    const T two = T(2);
    const T B[3][3] = {
        {add_rn(c, two * mul_rn(s0, s0)), add_rn(-two * s2, two * mul_rn(s0, s1)),
         add_rn(two * s1, two * mul_rn(s0, s2))},
        {add_rn(two * s2, two * mul_rn(s1, s0)), add_rn(c, two * mul_rn(s1, s1)),
         add_rn(-two * s0, two * mul_rn(s1, s2))},
        {add_rn(-two * s1, two * mul_rn(s2, s0)), add_rn(two * s0, two * mul_rn(s2, s1)),
         add_rn(c, two * mul_rn(s2, s2))}};
#pragma unroll
    for (int i = 0; i < 3; ++i) dx[i] = T(0.25) * rigid::dot3(B[i][0], wx, B[i][1], wy, B[i][2], wz);
    T wd[3];
    rigid::omega_dot(p, wx, wy, wz, u, wd);
    dx[3] = wd[0];
    dx[4] = wd[1];
    dx[5] = wd[2];
  }

  template <typename T>
  __device__ static void fxfu(const T (&x)[NX], const T (&u)[NU], const T* p,
                              T (&Fx)[NX][NX], T (&Fu)[NX][NU]) {
    const T s[3] = {x[0], x[1], x[2]}, w[3] = {x[3], x[4], x[5]};
    const T ss = s[0] * s[0] + s[1] * s[1] + s[2] * s[2];
    const T sw = s[0] * w[0] + s[1] * w[1] + s[2] * w[2];
    const T sk[3][3] = {{T(0), -s[2], s[1]}, {s[2], T(0), -s[0]}, {-s[1], s[0], T(0)}};
    const T wk[3][3] = {{T(0), -w[2], w[1]}, {w[2], T(0), -w[0]}, {-w[1], w[0], T(0)}};
    rigid::zero<NX>(Fx, Fu);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        // d sigma_dot_i / d omega_j = 0.25 B_ij; d / d s_j = 0.25 (-2 s_j w_i
        // + 2 (e_j x w)_i + 2 [i == j] s'w + 2 s_i w_j), (e_j x w)_i =
        // -skew(w)_ij.
        const T b = (i == j ? T(1) - ss : T(0)) + T(2) * sk[i][j] + T(2) * s[i] * s[j];
        Fx[i][3 + j] = T(0.25) * b;
        Fx[i][j] = T(0.25) * (T(-2) * s[j] * w[i] - T(2) * wk[i][j]
                              + (i == j ? T(2) * sw : T(0)) + T(2) * s[i] * w[j]);
      }
    }
    rigid::omega_jacobians<NX>(p, 3, w[0], w[1], w[2], Fx, Fu);
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
