// Streamed CLDDP backward pass: one thread per problem instance.
//
// Replaces cddp_tpu/ops/pallas/riccati.py::make_backward_kernel (:236). The
// Pallas kernel walks a (batch tile, time) grid with the value function
// carried in VMEM scratch between grid steps; here each thread walks its own
// horizon backwards with Vx, Vxx and the running sums in registers, so
// nothing carries between blocks.
//
// Bound: device memory. Per instance and step it reads the stage data
// (A, B, l-derivatives, bounds: 41 values at nx=3, nu=2; 15 at the
// pendulum's nx=2, nu=1, 44 at the cart-pole's nx=4, nu=1) and writes k and
// K (8, 3, 5 values); the arithmetic per value read is small. At nu=1 the
// enumerated BoxQP takes 3 active sets (clddp_step.cuh), at nu=2 nine. Every tensor is
// batch-last ([t][i][j][b]), so the 32 threads of a warp read 32 consecutive
// addresses and every load is fully coalesced.
#include <cstring>

#include "clddp_step.cuh"

namespace cddp {

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kThreads) riccati_backward_kernel(
    const T* __restrict__ A, const T* __restrict__ Bm, const T* __restrict__ lx,
    const T* __restrict__ lu, const T* __restrict__ lxx, const T* __restrict__ luu,
    const T* __restrict__ lux, const T* __restrict__ lb, const T* __restrict__ ub,
    const T* __restrict__ VxT, const T* __restrict__ VxxT, const T* __restrict__ reg,
    T* __restrict__ k, T* __restrict__ K, T* __restrict__ dV, T* __restrict__ stats,
    int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t Bs = B;

  T Vx[NX], Vxx[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    Vx[i] = VxT[i * Bs + b];
#pragma unroll
    for (int j = 0; j < NX; ++j) Vxx[i][j] = VxxT[(i * NX + j) * Bs + b];
  }
  const T r = reg[b];
  T dv0 = T(0), dv1 = T(0), qerr = T(0), nvx = T(0), ok = T(1);

  for (int t = N - 1; t >= 0; --t) {
    T At[NX][NX], Bt[NX][NU], lxt[NX], lut[NU], lxxt[NX][NX], luut[NU][NU],
        luxt[NU][NX], lbt[NU], ubt[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      lxt[i] = lx[(size_t(t) * NX + i) * Bs + b];
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        At[i][j] = A[((size_t(t) * NX + i) * NX + j) * Bs + b];
        lxxt[i][j] = lxx[((size_t(t) * NX + i) * NX + j) * Bs + b];
      }
#pragma unroll
      for (int j = 0; j < NU; ++j) Bt[i][j] = Bm[((size_t(t) * NX + i) * NU + j) * Bs + b];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lut[i] = lu[(size_t(t) * NU + i) * Bs + b];
      lbt[i] = lb[(size_t(t) * NU + i) * Bs + b];
      ubt[i] = ub[(size_t(t) * NU + i) * Bs + b];
#pragma unroll
      for (int j = 0; j < NU; ++j) luut[i][j] = luu[((size_t(t) * NU + i) * NU + j) * Bs + b];
#pragma unroll
      for (int j = 0; j < NX; ++j) luxt[i][j] = lux[((size_t(t) * NU + i) * NX + j) * Bs + b];
    }

    StepOut<T, NX, NU> s;
    clddp_backward_step<T, NX, NU>(At, Bt, lxt, lut, lxxt, luut, luxt, lbt, ubt,
                                   Vx, Vxx, r, s);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      k[(size_t(t) * NU + i) * Bs + b] = s.k[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) K[((size_t(t) * NU + i) * NX + j) * Bs + b] = s.K[i][j];
    }
    dv0 = dv0 + s.dv0;
    dv1 = dv1 + s.dv1;
    qerr = nan_max(qerr, s.qu_absmax);
    T a = T(0);
#pragma unroll
    for (int i = 0; i < NX; ++i) a = a + dabs(Vx[i]);
    nvx = nvx + a;
    ok = ok * (s.fail ? T(0) : T(1));
  }
  dV[b] = dv0;
  dV[Bs + b] = dv1;
  stats[b] = qerr;
  stats[Bs + b] = nvx;
  stats[2 * Bs + b] = ok;
}

template <typename T, int NX, int NU>
int launch_riccati_backward(const T* A, const T* Bm, const T* lx, const T* lu,
                            const T* lxx, const T* luu, const T* lux, const T* lb,
                            const T* ub, const T* VxT, const T* VxxT, const T* reg,
                            T* k, T* K, T* dV, T* stats, int N, int B,
                            cudaStream_t stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  riccati_backward_kernel<T, NX, NU><<<blocks, kThreads, 0, stream>>>(
      A, Bm, lx, lu, lxx, luu, lux, lb, ub, VxT, VxxT, reg, k, K, dV, stats, N, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

extern "C" {

#ifndef CDDP_F64
const char* cddp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What cudaFuncGetAttributes and the occupancy calculator report for the
// kernel of the launcher `name` (with its type suffix) at the block size and
// dynamic shared memory it launches with: out = {registers per thread, local
// (spill) bytes per thread, static shared bytes, dynamic shared bytes,
// resident blocks per SM, threads per block}. Returns a CUDA error code,
// cudaErrorInvalidDeviceFunction for an unknown name.
int cddp_kernel_attributes(const char* name, int* out) {
  for (const cddp::KernelInfo* k = cddp::kernel_list(); k != nullptr; k = k->next) {
    if (std::strcmp(k->name, name) != 0) continue;
    cudaFuncAttributes a;
    cudaError_t err = cudaFuncGetAttributes(&a, k->fn);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(k->fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k->smem);
    int blocks = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k->fn, k->threads, k->smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int vals[6] = {a.numRegs, int(a.localSizeBytes), int(a.sharedSizeBytes), k->smem,
                         blocks, k->threads};
    for (int i = 0; i < 6; ++i) out[i] = vals[i];
    return 0;
  }
  return static_cast<int>(cudaErrorInvalidDeviceFunction);
}
#endif

}  // extern "C"

#define CDDP_RICCATI_BACKWARD(NX, NU)                                                  \
  extern "C" int CDDP_EXPORT(cddp_riccati_backward_##NX##x##NU)(                       \
      const scalar_t* A, const scalar_t* Bm, const scalar_t* lx, const scalar_t* lu,   \
      const scalar_t* lxx, const scalar_t* luu, const scalar_t* lux,                   \
      const scalar_t* lb, const scalar_t* ub, const scalar_t* VxT,                     \
      const scalar_t* VxxT, const scalar_t* reg, scalar_t* k, scalar_t* K,             \
      scalar_t* dV, scalar_t* stats, int N, int B, void* stream) {                     \
    return cddp::launch_riccati_backward<scalar_t, NX, NU>(                            \
        A, Bm, lx, lu, lxx, luu, lux, lb, ub, VxT, VxxT, reg, k, K, dV, stats, N, B,   \
        static_cast<cudaStream_t>(stream));                                            \
  }                                                                                    \
  CDDP_REGISTER(cddp_riccati_backward_##NX##x##NU,                                     \
                (cddp::riccati_backward_kernel<scalar_t, NX, NU>), cddp::kThreads, 0)

// (nx, nu) of riccati.KERNEL_SHAPES: the unicycle (3, 2), the pendulum (2,
// 1), the cart-pole (4, 1), the car and the default LTISystem (4, 2), the
// quadrotor (13, 4) and QuadrotorRate (10, 4), the attitude trio (6, 3:
// Euler angles and MRPs; 7, 3: the quaternion). From nu = 3 the BoxQP walks
// its 27 or 81 active sets in a runtime loop, and at nx = 13 the step's
// operands (A, lxx, Vxx: 3 x 169 values) outgrow the registers: the kernel
// spills to local memory.
CDDP_RICCATI_BACKWARD(3, 2)
CDDP_RICCATI_BACKWARD(2, 1)
CDDP_RICCATI_BACKWARD(4, 1)
CDDP_RICCATI_BACKWARD(4, 2)
CDDP_RICCATI_BACKWARD(13, 4)
CDDP_RICCATI_BACKWARD(10, 4)
CDDP_RICCATI_BACKWARD(6, 3)
CDDP_RICCATI_BACKWARD(7, 3)
