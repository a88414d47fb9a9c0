// One control-limited Riccati step for one problem instance.
//
// Counterpart of cddp_tpu/ops/pallas/riccati.py::clddp_backward_step_lanes
// (riccati.py:106-233), shared by the streamed backward kernel
// (riccati_backward.cu) and the whole-solve kernel (clddp_solve.cu): the
// Q-expansion, +reg*I, the exact 3^NU enumerated BoxQP, the free-row
// feedback gains K = -H_free^-1 Qux, dV, and the value-function update
// (clddp_solver.cpp:96-203). The 3^NU configurations are a compile-time
// table walked by template recursion, in itertools.product order; the first
// valid configuration wins, as at riccati.py:175-176.
#pragma once

#include "small_linalg.cuh"

namespace cddp {

__host__ __device__ constexpr int pow3(int n) { return n == 0 ? 1 : 3 * pow3(n - 1); }

// Digit i of configuration c: 0 free, 1 at lower, 2 at upper (digit 0 is
// the most significant, as in itertools.product(range(3), repeat=nu)).
__host__ __device__ constexpr int cfg_digit(int c, int nu, int i) {
  return (c / pow3(nu - 1 - i)) % 3;
}

__host__ __device__ constexpr int cfg_nfree(int c, int nu) {
  int n = 0;
  for (int i = 0; i < nu; ++i) n += cfg_digit(c, nu, i) == 0;
  return n;
}

// Index of the a-th free coordinate of configuration c.
__host__ __device__ constexpr int cfg_free(int c, int nu, int a) {
  for (int i = 0; i < nu; ++i) {
    if (cfg_digit(c, nu, i) == 0) {
      if (a == 0) return i;
      --a;
    }
  }
  return 0;
}

// Running selection of the enumerated BoxQP.
template <typename T, int NU>
struct BoxQPSel {
  T k[NU];
  T Hinv[NU][NU];  // inverse of the taken free block, zero elsewhere
  bool taken;
};

template <typename T, int NU, int C>
__device__ __forceinline__ void boxqp_enum(const T (&H)[NU][NU], const T (&g)[NU],
                                           const T (&lb)[NU], const T (&ub)[NU],
                                           BoxQPSel<T, NU>& sel) {
  if constexpr (C < pow3(NU)) {
    constexpr int NF = cfg_nfree(C, NU);
    T x[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int d = cfg_digit(C, NU, i);
      x[i] = d == 0 ? T(0) : (d == 1 ? lb[i] : ub[i]);
    }
    bool valid;
    T Hinv[NF > 0 ? NF : 1][NF > 0 ? NF : 1];
    if constexpr (NF > 0) {
      // Free block: Hff xf = -(g_f + H_fc x_c).
      T Hff[NF][NF], rhs[NF], xf[NF];
#pragma unroll
      for (int a = 0; a < NF; ++a) {
        const int fa = cfg_free(C, NU, a);
#pragma unroll
        for (int b = 0; b < NF; ++b) Hff[a][b] = H[fa][cfg_free(C, NU, b)];
        T s = T(0);
#pragma unroll
        for (int b = 0; b < NU; ++b)
          if (cfg_digit(C, NU, b) != 0) s = s + H[fa][b] * x[b];
        rhs[a] = -(g[fa] + s);
      }
      inverse<T, NF>(Hff, Hinv);
      valid = leading_minors_pd<T, NF>(Hff);
      matvec<T, NF, NF>(Hinv, rhs, xf);
#pragma unroll
      for (int a = 0; a < NF; ++a) x[cfg_free(C, NU, a)] = xf[a];
    } else {
      valid = true;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T grad = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) grad = grad + H[i][j] * x[j];
      grad = g[i] + grad;
      const int d = cfg_digit(C, NU, i);
      if (d == 0) {
        valid = valid & (x[i] >= lb[i]) & (x[i] <= ub[i]);
      } else if (d == 1) {
        valid = valid & (grad >= T(0));
      } else {
        valid = valid & (grad <= T(0));
      }
    }
    const bool take = valid & !sel.taken;
    sel.taken = sel.taken | valid;
#pragma unroll
    for (int i = 0; i < NU; ++i) sel.k[i] = take ? x[i] : sel.k[i];
    if constexpr (NF > 0) {
#pragma unroll
      for (int a = 0; a < NF; ++a)
#pragma unroll
        for (int b = 0; b < NF; ++b) {
          T& dst = sel.Hinv[cfg_free(C, NU, a)][cfg_free(C, NU, b)];
          dst = take ? Hinv[a][b] : dst;
        }
    }
    boxqp_enum<T, NU, C + 1>(H, g, lb, ub, sel);
  }
}

// Outputs of one step; Vx and Vxx are updated in place.
template <typename T, int NX, int NU>
struct StepOut {
  T k[NU];
  T K[NU][NX];
  T dv0, dv1;
  bool fail;
  T qu_absmax;
};

template <typename T, int NX, int NU>
__device__ __forceinline__ void clddp_backward_step(
    const T (&A)[NX][NX], const T (&Bm)[NX][NU], const T (&lx)[NX],
    const T (&lu)[NU], const T (&lxx)[NX][NX], const T (&luu)[NU][NU],
    const T (&lux)[NU][NX], const T (&lb)[NU], const T (&ub)[NU],
    T (&Vx)[NX], T (&Vxx)[NX][NX], T reg, StepOut<T, NX, NU>& out) {
  T At[NX][NX], Bt[NU][NX];
  transpose<T, NX, NX>(A, At);
  transpose<T, NX, NU>(Bm, Bt);

  T Qx[NX], Qu[NU], tx[NX], tu[NU];
  matvec<T, NX, NX>(At, Vx, tx);
  matvec<T, NU, NX>(Bt, Vx, tu);
#pragma unroll
  for (int i = 0; i < NX; ++i) Qx[i] = lx[i] + tx[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) Qu[i] = lu[i] + tu[i];

  T VA[NX][NX], VB[NX][NU], Qxx[NX][NX], Qux[NU][NX], Quu[NU][NU];
  matmul<T, NX, NX, NX>(Vxx, A, VA);
  matmul<T, NX, NX, NX>(At, VA, Qxx);
  matmul<T, NU, NX, NX>(Bt, VA, Qux);
  matmul<T, NX, NX, NU>(Vxx, Bm, VB);
  matmul<T, NU, NX, NU>(Bt, VB, Quu);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) Qxx[i][j] = lxx[i][j] + Qxx[i][j];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) Qux[i][j] = lux[i][j] + Qux[i][j];
#pragma unroll
    for (int j = 0; j < NU; ++j) Quu[i][j] = luu[i][j] + Quu[i][j];
  }

  T Quu_reg[NU][NU];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) Quu_reg[i][j] = Quu[i][j] + (i == j ? reg : T(0));

  // Exact enumerated BoxQP.
  const bool pd_all = leading_minors_pd<T, NU>(Quu_reg);
  BoxQPSel<T, NU> sel;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    sel.k[i] = T(0);
#pragma unroll
    for (int j = 0; j < NU; ++j) sel.Hinv[i][j] = T(0);
  }
  sel.taken = false;
  boxqp_enum<T, NU, 0>(Quu_reg, Qu, lb, ub, sel);
  out.fail = !pd_all | !sel.taken;

  // K = -Hfree^-1 Qux on free rows.
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    out.k[i] = sel.k[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      T s = T(0);
#pragma unroll
      for (int l = 0; l < NU; ++l) s = s + sel.Hinv[i][l] * Qux[l][j];
      out.K[i][j] = -s;
    }
  }
  const T (&k)[NU] = out.k;

  // dV += [Qu.k, 0.5 k'Quu k]
  T dv0 = T(0), dv1 = T(0);
#pragma unroll
  for (int i = 0; i < NU; ++i) dv0 = dv0 + Qu[i] * k[i];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) dv1 = dv1 + k[i] * Quu[i][j] * k[j];
  out.dv0 = dv0;
  out.dv1 = T(0.5) * dv1;

  // Value-function update (clddp_solver.cpp:186-193).
  T Quu_k[NU], Kt[NX][NU];
  matvec<T, NU, NU>(Quu, k, Quu_k);
  transpose<T, NU, NX>(out.K, Kt);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    T s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll
    for (int l = 0; l < NU; ++l) s1 = s1 + Kt[i][l] * Quu_k[l];
#pragma unroll
    for (int l = 0; l < NU; ++l) s2 = s2 + Qux[l][i] * k[l];
#pragma unroll
    for (int l = 0; l < NU; ++l) s3 = s3 + Kt[i][l] * Qu[l];
    Vx[i] = Qx[i] + s1 + s2 + s3;
  }
  T QuuK[NU][NX], KtQuuK[NX][NX], Quxt[NX][NU], QuxtK[NX][NX];
  matmul<T, NU, NU, NX>(Quu, out.K, QuuK);
  matmul<T, NX, NU, NX>(Kt, QuuK, KtQuuK);
  transpose<T, NU, NX>(Qux, Quxt);
  matmul<T, NX, NU, NX>(Quxt, out.K, QuxtK);
  T Vn[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j)
      Vn[i][j] = Qxx[i][j] + KtQuuK[i][j] + QuxtK[i][j] + QuxtK[j][i];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) Vxx[i][j] = T(0.5) * (Vn[i][j] + Vn[j][i]);

  T qa = dabs(Qu[0]);
#pragma unroll
  for (int i = 1; i < NU; ++i) qa = nan_max(qa, dabs(Qu[i]));
  out.qu_absmax = qa;
}

}  // namespace cddp
