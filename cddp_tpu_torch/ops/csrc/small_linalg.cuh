// Unrolled small-matrix algebra for one problem instance held in registers.
//
// Counterpart of cddp_tpu/ops/pallas/riccati.py::_matmul, _matvec,
// _transpose, _det, _inv and _leading_minors_pd (riccati.py:50-104). The
// Pallas kernel unrolls this algebra over static (nx, nu) at trace time;
// here every bound is a template argument, so nvcc unrolls it at compile
// time and the arrays stay in registers. Sums start from zero and add in
// index order, and determinants expand by Leibniz over permutations in
// lexicographic order, exactly as the Python loops do, so a float64 build
// without FMA contraction rounds like the reference.
#pragma once

#include <cuda_runtime.h>

#include <cmath>

// Each .cu file is compiled once per scalar type (see ops/kernels/build.py).
#ifdef CDDP_F64
typedef double scalar_t;
#define CDDP_EXPORT(name) name##_f64
#define CDDP_SUFFIX "_f64"
#else
typedef float scalar_t;
#define CDDP_EXPORT(name) name##_f32
#define CDDP_SUFFIX "_f32"
#endif

namespace cddp {

constexpr int kThreads = 256;

// Block size of the interior-point whole-solve kernels (ipddp_solve.cu,
// msipddp_solve.cu), and the resident blocks per SM their register budget
// is set for: in float32 four blocks of 128 threads, so at most 128
// registers a thread; in float64 no bound.
constexpr int kSolveThreads = 128;
template <typename T>
constexpr int solve_min_blocks() {
  return sizeof(T) == 4 ? 4 : 1;
}

// Every launcher registers the kernel it launches, its block size and its
// dynamic shared memory, so that cddp_kernel_attributes (riccati_backward.cu)
// can report what the compiler and the occupancy calculator say of it.
struct KernelInfo {
  const char* name;  // the launcher's exported name
  const void* fn;    // the __global__ function it launches
  int threads, smem;
  const KernelInfo* next;
};

inline const KernelInfo*& kernel_list() {
  static const KernelInfo* head = nullptr;
  return head;
}

struct RegisterKernel {
  KernelInfo info;
  RegisterKernel(const char* name, const void* fn, int threads, int smem)
      : info{name, fn, threads, smem, kernel_list()} {
    kernel_list() = &info;
  }
};

}  // namespace cddp

// NAME: the launcher's name without its type suffix; FN in parentheses.
#define CDDP_REGISTER(NAME, FN, THREADS, SMEM)                                 \
  static const cddp::RegisterKernel cddp_registered_##NAME(                    \
      #NAME CDDP_SUFFIX, (const void*)(FN), THREADS, SMEM);

namespace cddp {

// jnp.maximum / jnp.minimum: a NaN operand wins (fmax/fmin would drop it).
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

__device__ __forceinline__ float dabs(float v) { return fabsf(v); }
__device__ __forceinline__ double dabs(double v) { return fabs(v); }
__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }

// C = A @ B for (N,K) @ (K,M).
template <typename T, int N, int K, int M>
__device__ __forceinline__ void matmul(const T (&A)[N][K], const T (&B)[K][M],
                                       T (&C)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      T s = T(0);
#pragma unroll
      for (int l = 0; l < K; ++l) s = s + A[i][l] * B[l][j];
      C[i][j] = s;
    }
  }
}

// y = A @ x for (N,K) @ (K,).
template <typename T, int N, int K>
__device__ __forceinline__ void matvec(const T (&A)[N][K], const T (&x)[K],
                                       T (&y)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    T s = T(0);
#pragma unroll
    for (int l = 0; l < K; ++l) s = s + A[i][l] * x[l];
    y[i] = s;
  }
}

template <typename T, int N, int M>
__device__ __forceinline__ void transpose(const T (&A)[N][M], T (&At)[M][N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) At[j][i] = A[i][j];
}

// --- permutations of (0..n-1) in itertools.permutations order -------------

__host__ __device__ constexpr int factorial(int n) {
  return n <= 1 ? 1 : n * factorial(n - 1);
}

// Element i of the c-th permutation in lexicographic order.
__host__ __device__ constexpr int perm_elem(int n, int c, int i) {
  int used = 0, val = 0;
  for (int pos = 0; pos <= i; ++pos) {
    const int f = factorial(n - 1 - pos);
    int q = c / f;
    c = c % f;
    int v = 0;
    while (true) {
      if (!((used >> v) & 1)) {
        if (q == 0) break;
        --q;
      }
      ++v;
    }
    used |= 1 << v;
    val = v;
  }
  return val;
}

__host__ __device__ constexpr bool perm_odd(int n, int c) {
  int inv = 0;
  for (int a = 0; a < n; ++a)
    for (int b = a + 1; b < n; ++b)
      if (perm_elem(n, c, a) > perm_elem(n, c, b)) ++inv;
  return inv & 1;
}

template <typename T, int N, int C, int A>
__device__ __forceinline__ T perm_product(const T (&M)[N][N], T term) {
  if constexpr (A == N) {
    return term;
  } else {
    constexpr int j = perm_elem(N, C, A);
    return perm_product<T, N, C, A + 1>(M, term * M[A][j]);
  }
}

template <typename T, int N, int C>
__device__ __forceinline__ T leibniz(const T (&M)[N][N], T total) {
  if constexpr (C == factorial(N)) {
    return total;
  } else {
    constexpr int j0 = perm_elem(N, C, 0);
    const T term = perm_product<T, N, C, 1>(M, M[0][j0]);
    constexpr bool odd = perm_odd(N, C);
    return leibniz<T, N, C + 1>(M, odd ? total - term : total + term);
  }
}

// _det: the first (identity) permutation seeds the sum, the rest add or
// subtract in order. A 0x0 determinant is 1.
template <typename T, int N>
__device__ __forceinline__ T det(const T (&M)[N][N]) {
  if constexpr (N == 0) {
    return T(1);
  } else {
    return leibniz<T, N, 1>(M, perm_product<T, N, 0, 1>(M, M[0][0]));
  }
}

// _inv: adjugate inverse, out[j][i] = (-1)^(i+j) minor(i, j) / det; returns det.
template <typename T, int N>
__device__ __forceinline__ T inverse(const T (&A)[N][N], T (&out)[N][N]) {
  const T d = det<T, N>(A);
  const T inv_det = T(1) / d;
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T cof = T(1);
      if constexpr (N > 1) {
        T sub[N > 1 ? N - 1 : 1][N > 1 ? N - 1 : 1];
#pragma unroll
        for (int r = 0; r < N - 1; ++r)
#pragma unroll
          for (int c = 0; c < N - 1; ++c)
            sub[r][c] = A[r < i ? r : r + 1][c < j ? c : c + 1];
        cof = det<T, N - 1>(sub);
      }
      const T sign = ((i + j) & 1) ? T(-1) : T(1);
      out[j][i] = sign * cof * inv_det;
    }
  }
  return d;
}

// Leading principal minors of order 2..N of A (order 1 is A[0][0]).
template <typename T, int N, int K>
__device__ __forceinline__ bool leading_minors_from(const T (&A)[N][N]) {
  if constexpr (K > N) {
    return true;
  } else {
    T sub[K][K];
#pragma unroll
    for (int r = 0; r < K; ++r)
#pragma unroll
      for (int c = 0; c < K; ++c) sub[r][c] = A[r][c];
    const bool pos = det<T, K>(sub) > T(0);
    return pos & leading_minors_from<T, N, K + 1>(A);
  }
}

// _leading_minors_pd: Sylvester's criterion.
template <typename T, int N>
__device__ __forceinline__ bool leading_minors_pd(const T (&A)[N][N]) {
  return (A[0][0] > T(0)) & leading_minors_from<T, N, 2>(A);
}

// Cholesky solve of the P x P system A x = b (mega_ipddp.py::
// _chol_solve_lanes, :394-425): returns whether every pivot was positive
// (the plain driver's check that torch.linalg.cholesky_ex succeeded). From
// the first failed pivot on, diagonal entries are 1 and the entries below
// them 0, so a failed solve still runs, on a factor the caller discards.
template <typename T, int P>
__device__ __forceinline__ bool chol_solve(const T (&A)[P][P], const T (&b)[P], T (&x)[P]) {
  T L[P][P];
  bool ok = true;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      if (i == j) {
        ok = ok & (s > T(0));
        L[i][i] = ok ? dsqrt(nan_max(s, T(1e-300))) : T(1);
      } else {
        L[i][j] = ok ? s / L[j][j] : T(0);
      }
    }
  }
  T z[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    T s = b[i];
#pragma unroll
    for (int j = 0; j < i; ++j) s = s - L[i][j] * z[j];
    z[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    T s = z[i];
#pragma unroll
    for (int j = i + 1; j < P; ++j) s = s - L[j][i] * x[j];
    x[i] = s / L[i][i];
  }
  return ok;
}

// The largest and smallest singular value of a (near-)symmetric P x P
// matrix, as |eigenvalues| of sym(A) by eight cyclic Jacobi sweeps with
// trig-free rotations (mega_ipddp.py::_jacobi_sv_minmax, :428-466). Stands in
// for an SVD in the terminal equality's regularization floor: it agrees
// with one wherever the floor is zero (min >= 1e-8 max) and is approximate
// only near rank deficiency.
template <typename T, int P>
__device__ __forceinline__ void jacobi_sv_minmax(const T (&A)[P][P], T& mx, T& mn) {
  T B[P][P];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < P; ++j) B[i][j] = T(0.5) * (A[i][j] + A[j][i]);
#pragma unroll
  for (int sweep = 0; sweep < 8; ++sweep) {
#pragma unroll
    for (int i = 0; i < P - 1; ++i) {
#pragma unroll
      for (int j = i + 1; j < P; ++j) {
        const T apq = B[i][j];
        const bool small = dabs(apq) < T(1e-300);
        const T tau = (B[j][j] - B[i][i]) / (T(2) * (small ? T(1) : apq));
        const T sgn = tau >= T(0) ? T(1) : T(-1);
        const T t = small ? T(0) : sgn / (dabs(tau) + dsqrt(T(1) + tau * tau));
        const T c = T(1) / dsqrt(T(1) + t * t);
        const T s = t * c;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const T bik = B[i][k], bjk = B[j][k];
          B[i][k] = c * bik - s * bjk;
          B[j][k] = s * bik + c * bjk;
        }
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const T bki = B[k][i], bkj = B[k][j];
          B[k][i] = c * bki - s * bkj;
          B[k][j] = s * bki + c * bkj;
        }
      }
    }
  }
  mx = dabs(B[0][0]);
  mn = mx;
#pragma unroll
  for (int i = 1; i < P; ++i) {
    mx = nan_max(mx, dabs(B[i][i]));
    mn = nan_min(mn, dabs(B[i][i]));
  }
}

}  // namespace cddp
