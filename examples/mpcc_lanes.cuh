// The MPCC racing example's CUDA lanes (examples/mpcc_lib_torch.py registers
// them): the 7-state latch bicycle's model struct, the Clenshaw-window cost
// lane of the interior-point forward trial (kernel 5) and the Gauss-Newton
// residual lane of the whole IPDDP solve (kernel 7).
//
// Replaces the JAX lanes of examples/mpcc_lib.py: _bicycle7_lane (:415-427),
// _mpcc_cost_factory's lane_f (:430-490) and _mpcc_gn_factory's res_f,
// tres_f and textra_f (:507-606). Each writes the JAX lane's expressions in
// its order of operations (the clip as max/min, the where-form |e_c|, the
// floor-based angle wrap), so that the float64 build (--fmad=false) rounds
// like the plain torch lanes and subgradients agree at ties.
//
// cp, each instance's parameters (lanes.cuh::LaneParams): the window's
// Chebyshev coefficients (M, 5) row-major, then its center, halfwidth and
// width; n_cp = 5 M + 3, so M is read from the row's length. The Clenshaw
// recurrence runs M - 1 rungs for the window's five fields, reading each
// coefficient once (through the read-only data cache) per evaluation.
#pragma once

#include "lanes.cuh"
#include "models.cuh"

namespace cddp {
namespace mpcc {

constexpr double kPi = 3.141592653589793;
constexpr double kTwoPi = 6.283185307179586;

// x = (x, y, psi, theta, v_prev, delta_prev, v_theta_prev), u = (v_w, delta,
// v_theta); p = (wheelbase, latch dt). The latches follow (u - latch) / dt.
struct Bicycle7 {
  static constexpr int NX = 7;
  static constexpr int NU = 3;
  static constexpr int NP = 2;

  template <typename T>
  __device__ static void f(const T (&x)[NX], const T (&u)[NU], const T* p, T (&dx)[NX]) {
    const T inv_dt = T(1) / p[1];
    dx[0] = u[0] * dcos(x[2]);
    dx[1] = u[0] * dsin(x[2]);
    dx[2] = u[0] * dtan(u[1]) / p[0];
    dx[3] = u[2];
    dx[4] = (u[0] - x[4]) * inv_dt;
    dx[5] = (u[1] - x[5]) * inv_dt;
    dx[6] = (u[2] - x[6]) * inv_dt;
  }

  // Forward-mode AD of f, written out: tan's tangent is (1 + tan^2).
  template <typename T>
  __device__ static void fxfu(const T (&x)[NX], const T (&u)[NU], const T* p,
                              T (&Fx)[NX][NX], T (&Fu)[NX][NU]) {
    const T inv_dt = T(1) / p[1];
    const T s = dsin(x[2]), c = dcos(x[2]), tn = dtan(u[1]);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) Fx[i][j] = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) Fu[i][j] = T(0);
    }
    Fx[0][2] = -(u[0] * s);
    Fx[1][2] = u[0] * c;
    Fx[4][4] = -inv_dt;
    Fx[5][5] = -inv_dt;
    Fx[6][6] = -inv_dt;
    Fu[0][0] = c;
    Fu[1][0] = s;
    Fu[2][0] = tn / p[0];
    Fu[2][1] = u[0] * (T(1) + tn * tn) / p[0];
    Fu[3][2] = T(1);
    Fu[4][0] = inv_dt;
    Fu[5][1] = inv_dt;
    Fu[6][2] = inv_dt;
  }
};

// The window's fields at theta: (rx, ry, heading, v_ref) by the Clenshaw
// recurrence, the clip to [-1, 1] as clip(t) (the two lanes write it
// differently), and the contour, lag and yaw errors.
template <typename S, typename T, class Clip>
__device__ __forceinline__ void track_errors(const S (&x)[7], const LaneParams<T>& cp, Clip clip,
                                             S& e_c, S& e_l, S& e_yaw, S& v_ref, S& dx,
                                             S& dy) {
  const int M = (cp.n - 3) / 5;
  const T center = cp[5 * M], halfwidth = cp[5 * M + 1];
  const S t = clip((x[3] - center) / halfwidth);
  S b1[5], b2[5];
#pragma unroll
  for (int f = 0; f < 5; ++f) b1[f] = b2[f] = lconst<S>(T(0));
  const S t2 = T(2) * t;
  for (int k = M - 1; k > 0; --k) {
#pragma unroll
    for (int f = 0; f < 5; ++f) {
      const S nb = t2 * b1[f] - b2[f] + cp[5 * k + f];
      b2[f] = b1[f];
      b1[f] = nb;
    }
  }
  S vals[5];
#pragma unroll
  for (int f = 0; f < 5; ++f) vals[f] = t * b1[f] - b2[f] + cp[f];
  const S sin_h = dsin(vals[2]), cos_h = dcos(vals[2]);
  dx = x[0] - vals[0];
  dy = x[1] - vals[1];
  e_c = -sin_h * dx + cos_h * dy;
  e_l = cos_h * dx + sin_h * dy;
  const S a = x[2] - vals[2];
  e_yaw = a - T(kTwoPi) * dfloor((a + T(kPi)) / T(kTwoPi));
  v_ref = vals[4];
}

template <typename S>
__device__ __forceinline__ S square(S v) {
  return v * v;
}

// The forward trial's running cost (_mpcc_cost_factory's lane_f): w = (the
// reference speed, the boundary band, dt w of the 12 weights), the weighted
// squares summed in the lane's order.
struct MpccCost {
  static constexpr int NW = 14;

  template <typename T>
  __device__ static T cost(const T (&x)[7], const T (&u)[3], const LaneParams<T>& cp,
                           const T (&w)[NW], int t) {
    T e_c, e_l, e_yaw, v_ref, dx, dy;
    track_errors(x, cp, [](T v) { return nan_min(nan_max(v, T(-1)), T(1)); }, e_c, e_l, e_yaw,
                 v_ref, dx, dy);
    const int M = (cp.n - 3) / 5;
    const T width = cp[5 * M + 2];
    const T v_target = nan_max(v_ref, w[0]);
    const T boundary = nan_max(T(0), dabs(e_c) - w[1] * width);
    return w[2] * e_c * e_c + w[3] * e_l * e_l + w[4] * square(u[2] - v_target) +
           w[5] * square(u[0] - v_target) + w[6] * (u[0] * u[0] + u[1] * u[1]) +
           w[7] * dx * dx + w[8] * dy * dy + w[9] * e_yaw * e_yaw +
           w[10] * square(u[0] - x[4]) + w[11] * square(u[1] - x[5]) +
           w[12] * square(u[2] - x[6]) + w[13] * boundary * boundary;
  }
};

// The whole solve's GN lane (_mpcc_gn_factory): w = (the reference speed,
// the boundary band, the 13 residual scales sqrt(dt w), sqrt(w_terminal),
// w_terminal_progress).
struct MpccGn {
  static constexpr int NW = 17, NRES = 13, NTRES = 2;

  template <typename S, typename T>
  __device__ static void lanes(const S (&x)[7], const LaneParams<T>& cp, S& e_c, S& e_l,
                               S& e_yaw, S& v_ref, S& dx, S& dy) {
    const S one = lconst<S>(T(1));
    track_errors(x, cp, [&](S v) { return lmin(lmax(v, -one), one); }, e_c, e_l, e_yaw, v_ref,
                 dx, dy);
  }

  template <typename S, typename T>
  __device__ static void res(const S (&x)[7], const S (&u)[3], const LaneParams<T>& cp,
                             const T (&w)[NW], int t, S (&r)[NRES]) {
    S e_c, e_l, e_yaw, v_ref, dx, dy;
    lanes(x, cp, e_c, e_l, e_yaw, v_ref, dx, dy);
    const int M = (cp.n - 3) / 5;
    const T width = cp[5 * M + 2];
    const S zero = lconst<S>(T(0));
    const S v_target = lmax(v_ref, zero + w[0]);
    const S abs_ec = val(e_c) >= T(0) ? e_c : -e_c;
    const S boundary = lmax(zero, abs_ec - w[1] * width);
    r[0] = w[2] * e_c;
    r[1] = w[3] * e_l;
    r[2] = w[4] * (u[2] - v_target);
    r[3] = w[5] * (u[0] - v_target);
    r[4] = w[6] * u[0];
    r[5] = w[7] * u[1];
    r[6] = w[8] * dx;
    r[7] = w[9] * dy;
    r[8] = w[10] * e_yaw;
    r[9] = w[11] * (u[0] - x[4]);
    r[10] = w[12] * (u[1] - x[5]);
    r[11] = w[13] * (u[2] - x[6]);
    r[12] = w[14] * boundary;
  }

  template <typename S, typename T>
  __device__ static void tres(const S (&x)[7], const LaneParams<T>& cp, const T (&w)[NW],
                              S (&r)[NTRES]) {
    S e_c, e_l, e_yaw, v_ref, dx, dy;
    lanes(x, cp, e_c, e_l, e_yaw, v_ref, dx, dy);
    r[0] = w[15] * e_c;
    r[1] = w[15] * e_l;
  }

  template <typename S, typename T>
  __device__ static S textra(const S (&x)[7], const LaneParams<T>& cp, const T (&w)[NW]) {
    return -w[16] * x[3];
  }
};

}  // namespace mpcc
}  // namespace cddp
