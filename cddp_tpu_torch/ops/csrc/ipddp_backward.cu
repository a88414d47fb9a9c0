// Streamed condensed IPDDP backward pass: one thread per problem instance.
//
// Replaces cddp_tpu/ops/pallas/ipddp_riccati.py::make_ipddp_backward_kernel
// (:215). The Pallas kernel walks a (batch tile, time) grid with the value
// function carried in VMEM scratch; here each thread walks its horizon
// backwards with Vx, Vxx and the running statistics in registers, calling
// ipddp_step.cuh's condense / condensed_step / path_gains per step.
//
// Bound: device memory. Per instance and step it reads the stage data (A, B,
// the cost derivatives, y, s, g and the constraint Jacobians: 62 values at
// nx=3, nu=2, m=4) and writes the control, dual and slack gains and the
// value function (56 values), against a few hundred flops. Every tensor is
// batch-last, so the loads and stores of a warp are coalesced; nothing is
// staged in shared memory because no value is read twice.
#include "ipddp_step.cuh"

namespace cddp {

template <typename T, int NX, int NU, int M>
__global__ void __launch_bounds__(kThreads) ipddp_backward_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ lx,
    const T* __restrict__ lu, const T* __restrict__ lxx, const T* __restrict__ luu,
    const T* __restrict__ lux, const T* __restrict__ Y, const T* __restrict__ S,
    const T* __restrict__ G, const T* __restrict__ Gx, const T* __restrict__ Gu,
    const T* __restrict__ VxT, const T* __restrict__ VxxT, const T* __restrict__ mu,
    const T* __restrict__ reg, T* __restrict__ ku, T* __restrict__ Ku,
    T* __restrict__ ky, T* __restrict__ Ky, T* __restrict__ ks, T* __restrict__ Ks,
    T* __restrict__ Vxs, T* __restrict__ Vxxs, T* __restrict__ stats, int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = B;
  // Element (t, i[, j]) of a batch-last (N, I[, J], B) tensor.
  auto at2 = [&](const T* p, int t, int i, int I) { return p[(size_t(t) * I + i) * Bs + b]; };
  auto at3 = [&](const T* p, int t, int i, int j, int I, int J) {
    return p[((size_t(t) * I + i) * J + j) * Bs + b];
  };

  T Vx[NX], Vxx[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = VxT[i * Bs + b];
#pragma unroll
    for (int j = 0; j < NX; ++j) Vxx[i][j] = VxxT[(i * NX + j) * Bs + b];
  }
  const T m = mu[b], r = reg[b];
  T dv0 = T(0), dv1 = T(0), inf_du = T(0), inf_pr = T(0), inf_comp = T(0),
    step = T(0);
  bool ok = true;

  for (int t = N - 1; t >= 0; --t) {
    T At[NX][NX], Bt[NX][NU], lxt[NX], lut[NU], lxxt[NX][NX], luut[NU][NU],
        luxt[NU][NX], y[M], s[M], g[M], Gxt[M][NX], Gut[M][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      lxt[i] = at2(lx, t, i, NX);
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        At[i][j] = at3(A, t, i, j, NX, NX);
        lxxt[i][j] = at3(lxx, t, i, j, NX, NX);
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) Bt[i][j] = at3(Bm, t, i, j, NX, NU);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lut[i] = at2(lu, t, i, NU);
#pragma unroll
      for (int j = 0; j < NU; ++j) luut[i][j] = at3(luu, t, i, j, NU, NU);
#pragma unroll
      for (int j = 0; j < NX; ++j) luxt[i][j] = at3(lux, t, i, j, NU, NX);
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      y[i] = at2(Y, t, i, M);
      s[i] = at2(S, t, i, M);
      g[i] = at2(G, t, i, M);
#pragma unroll
      for (int j = 0; j < NX; ++j) Gxt[i][j] = at3(Gx, t, i, j, M, NX);
#pragma unroll
      for (int j = 0; j < NU; ++j) Gut[i][j] = at3(Gu, t, i, j, M, NU);
    }

    Condensed<T, M> c;
    condense<T, M>(y, s, g, m, c);
    IpStep<T, NX, NU> o;
    condensed_step<T, NX, NU, M>(At, Bt, lxt, lut, lxxt, luut, luxt, y, Gxt, Gut, c,
                                 r, Vx, Vxx, o);
    T kyt[M], Kyt[M][NX], kst[M], Kst[M][NX];
    path_gains<T, NX, NU, M>(y, c, Gxt, Gut, o.k, o.K, kyt, Kyt, kst, Kst);

#pragma unroll
    for (int i = 0; i < NU; ++i) {
      ku[(size_t(t) * NU + i) * Bs + b] = o.k[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) Ku[((size_t(t) * NU + i) * NX + j) * Bs + b] = o.K[i][j];
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      ky[(size_t(t) * M + i) * Bs + b] = kyt[i];
      ks[(size_t(t) * M + i) * Bs + b] = kst[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        Ky[((size_t(t) * M + i) * NX + j) * Bs + b] = Kyt[i][j];
        Ks[((size_t(t) * M + i) * NX + j) * Bs + b] = Kst[i][j];
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      Vxs[(size_t(t) * NX + i) * Bs + b] = Vx[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) Vxxs[((size_t(t) * NX + i) * NX + j) * Bs + b] = Vxx[i][j];
    }

    dv0 = dv0 + o.dv0;
    dv1 = dv1 + o.dv1;
    inf_du = nan_max(inf_du, o.qu_absmax);
    inf_pr = nan_max(inf_pr, o.pr_absmax);
    inf_comp = nan_max(inf_comp, o.comp_absmax);
    T km = T(0);
#pragma unroll
    for (int i = 0; i < NU; ++i) km = nan_max(km, dabs(o.k[i]));
    step = nan_max(step, km);
    ok = ok & o.ok;
  }

  const T vals[7] = {dv0, dv1, inf_du, inf_pr, inf_comp, step, ok ? T(1) : T(0)};
#pragma unroll
  for (int i = 0; i < 7; ++i) stats[i * Bs + b] = vals[i];
}

template <typename T, int NX, int NU, int M>
int launch_ipddp_backward(const T* const* in, T* const* out, int N, int B,
                          cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  ipddp_backward_kernel<T, NX, NU, M><<<blocks, kThreads, 0, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], in[8], in[9], in[10],
      in[11], in[12], in[13], in[14], in[15], out[0], out[1], out[2], out[3], out[4],
      out[5], out[6], out[7], out[8], N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// (nx, nu, m): the unicycle with a control box (m=4), a state box (6) or
// both (10).
#define CDDP_IPDDP_BACKWARD(NX, NU, M)                                                 \
  extern "C" int CDDP_EXPORT(cddp_ipddp_backward_##NX##x##NU##x##M)(                   \
      const scalar_t* A, const scalar_t* Bm, const scalar_t* lx, const scalar_t* lu,   \
      const scalar_t* lxx, const scalar_t* luu, const scalar_t* lux,                   \
      const scalar_t* Y, const scalar_t* S, const scalar_t* G, const scalar_t* Gx,     \
      const scalar_t* Gu, const scalar_t* VxT, const scalar_t* VxxT,                   \
      const scalar_t* mu, const scalar_t* reg, scalar_t* ku, scalar_t* Ku,             \
      scalar_t* ky, scalar_t* Ky, scalar_t* ks, scalar_t* Ks, scalar_t* Vxs,           \
      scalar_t* Vxxs, scalar_t* stats, int N, int B, void* stream) {                   \
    const scalar_t* in[16] = {A, Bm, lx, lu, lxx, luu, lux, Y,                         \
                              S, G,  Gx, Gu, VxT, VxxT, mu, reg};                      \
    scalar_t* out[9] = {ku, Ku, ky, Ky, ks, Ks, Vxs, Vxxs, stats};                     \
    return cddp::launch_ipddp_backward<scalar_t, NX, NU, M>(                           \
        in, out, N, B, static_cast<cudaStream_t>(stream));                             \
  }                                                                                    \
  CDDP_REGISTER(cddp_ipddp_backward_##NX##x##NU##x##M,                                 \
                (cddp::ipddp_backward_kernel<scalar_t, NX, NU, M>), cddp::kThreads, 0)

CDDP_IPDDP_BACKWARD(3, 2, 4)
CDDP_IPDDP_BACKWARD(3, 2, 6)
CDDP_IPDDP_BACKWARD(3, 2, 10)
