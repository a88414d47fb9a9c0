// User lanes: what the kernels give a registered cost lane or Gauss-Newton
// (GN) residual lane, and the forward-mode dual number a lane's residual
// Jacobians are taken with.
//
// Replaces the lane plumbing of cddp_tpu/ops/pallas/ip_rollout.py (cost
// lanes, cp (B, n_cp), :248, :273, :556) and mega_ipddp.py (GnCostSpec,
// :115-165, and the jax.jvp columns of its GN branch, :647-720). A lane is
// a struct in a header outside ops/csrc (examples/mpcc_lanes.cuh), in
// namespace cddp, built into a lane library by ops/kernels/build.py:
//
//   cost lane (kernel 5): NW constants, and
//     template <typename T> static T cost(x[NX], u[NU], LaneParams<T> cp,
//                                         const T (&w)[NW], int t);
//   GN lane (kernel 7): NW constants, NRES running and NTRES terminal
//   residuals, and, for any scalar S (T, or Dual<T> for a Jacobian column),
//     template <typename S, typename T> static void res(x[NX], u[NU],
//         LaneParams<T> cp, const T (&w)[NW], int t, S (&r)[NRES]);
//     ... static void tres(x[NX], cp, w, S (&r)[NTRES]);
//     ... static S textra(x[NX], cp, w);   (affine in x: its Hessian is 0)
//
// cp is each instance's parameter row: for kernel 7 batch-last (n_cp, B) in
// device memory, a warp's threads on neighbouring addresses, through the
// read-only data cache (a GN lane evaluates every parameter once per
// tangent column per step); for kernel 5 its row of the (B, n_cp) tensor
// where it lies, staged in shared memory once a launch where it fits.
#pragma once

#include <type_traits>

#include "models.cuh"

namespace cddp {

// One instance's parameters: parameter i at p[i * Bs + b] (row i of a
// batch-last (n, B) array; in the forward trial, its own row of a (B, n)
// tensor with Bs its value stride and b 0). `shared`: p points into shared
// memory (the forward trial's staged rows), read by a plain load; else
// through the read-only data cache.
template <typename T>
struct LaneParams {
  const T* p;
  size_t Bs;
  int b;
  int n;
  bool shared = false;
  __device__ __forceinline__ T operator[](int i) const {
    return shared ? p[size_t(i) * Bs + b] : __ldg(p + size_t(i) * Bs + b);
  }
};

// A cost or GN lane's kernel arguments: the parameters (n_cp, B) and the
// lane's constants, by value. Empty for the quadratic cost (Lane void), so
// that those kernels' parameters, and their code, are what they were.
template <typename T, class Lane>
struct CostArgs {
  const T* cp;
  int ncp;
  T w[Lane::NW];

  static CostArgs from_host(const T* cp, int ncp, const double* w) {
    CostArgs a{};
    a.cp = cp;
    a.ncp = ncp;
    for (int i = 0; i < Lane::NW; ++i) a.w[i] = T(w[i]);
    return a;
  }
};
template <typename T>
struct CostArgs<T, void> {
  static CostArgs from_host(const T*, int, const double*) { return {}; }
};

// A value and one tangent: forward-mode AD, one Jacobian column per pass,
// as the JAX kernel's jax.jvp takes them. Each rule is the derivative of
// the operation at the value; a comparison reads the values.
template <typename T>
struct Dual {
  T v, d;
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T q = a.v / b.v;
  return {q, (a.d - q * b.d) / b.v};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }

// The value of a scalar or a dual.
template <typename T>
__device__ __forceinline__ T val(T a) { return a; }
template <typename T>
__device__ __forceinline__ T val(Dual<T> a) { return a.v; }

// Elementary functions on both.
template <typename T>
__device__ __forceinline__ Dual<T> dsin(Dual<T> a) { return {dsin(a.v), dcos(a.v) * a.d}; }
template <typename T>
__device__ __forceinline__ Dual<T> dcos(Dual<T> a) { return {dcos(a.v), -dsin(a.v) * a.d}; }
__device__ __forceinline__ float dfloor(float v) { return floorf(v); }
__device__ __forceinline__ double dfloor(double v) { return floor(v); }
template <typename T>
__device__ __forceinline__ Dual<T> dfloor(Dual<T> a) { return {dfloor(a.v), T(0)}; }

// max / min with JAX's tie rule: at equal values each side takes half the
// tangent (jax.lax.max's jvp); a NaN value wins (nan_max, nan_min).
template <typename T>
__device__ __forceinline__ T lmax(T a, T b) { return nan_max(a, b); }
template <typename T>
__device__ __forceinline__ T lmin(T a, T b) { return nan_min(a, b); }
template <typename T>
__device__ __forceinline__ Dual<T> lmax(Dual<T> a, Dual<T> b) {
  const T v = nan_max(a.v, b.v);
  return {v, a.v == b.v ? T(0.5) * (a.d + b.d) : (v == a.v ? a.d : b.d)};
}
template <typename T>
__device__ __forceinline__ Dual<T> lmin(Dual<T> a, Dual<T> b) {
  const T v = nan_min(a.v, b.v);
  return {v, a.v == b.v ? T(0.5) * (a.d + b.d) : (v == a.v ? a.d : b.d)};
}

// A constant in a lane's scalar type.
template <typename S, typename T>
__device__ __forceinline__ S lconst(T v) {
  if constexpr (std::is_same_v<S, T>) {
    return v;
  } else {
    return S{v, T(0)};
  }
}

}  // namespace cddp
