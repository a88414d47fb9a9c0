// Condensed IPDDP backward pass: one thread per problem instance, each
// step's operands staged through shared memory.
//
// Replaces cddp_tpu/ops/pallas/ipddp_riccati.py::make_ipddp_backward_kernel
// (:215). The Pallas kernel walks a (batch tile, time) grid with the value
// function carried in VMEM scratch; here each thread walks its horizon
// backwards with Vx, Vxx and the running statistics in registers, calling
// ipddp_step.cuh's condense / condensed_step / path_gains per step.
//
// Bound: device memory. The compulsory traffic of the per-pass driver's call
// at B=262144, m=4, float32 is 1.909 GB (0.570 ms at 3.35 TB/s): per instance
// and step 38 values in (A, B, the cost gradients, lux, y, s, g) and 52 out
// (the control, dual and slack gains and the value function); the cost
// Hessians and the constraint Jacobians are one broadcast copy. The design,
// each step kept or not as an H100 measured it (PERF.md, section 6):
//
// 1. Operands are read where they lie (kept). The launcher takes every
//    input's batch, step and value strides, so the wrapper copies nothing.
//    An operand with batch stride 0 is staged by the block once a step, or
//    once a launch when its step stride is 0 too (the driver's cost
//    Hessians and constraint Jacobians), and every thread reads that one
//    copy. Every other operand is copied by each thread for its own
//    instance into a [value][thread] tile (sweep_stage.cuh::TileStage):
//    coalesced for the batch-last views the forward kernel hands on (y, s,
//    g), the instance's own run for a batch-first one. Copying batch-first
//    operands block-cooperatively, neighbouring threads on neighbouring
//    words, was slower. The outputs stay batch-last, as the forward kernel
//    reads them; written batch-first, they cost its wrapper a transpose.
// 2. Staged next step (kept). While step t computes, step t-1's copies
//    (cp.async, one group a step) are in flight into the tiles' second
//    stage; two block barriers a step. Two steps a stage were slower.
// 3. Occupancy (kept): blocks of kBackThreads, and __launch_bounds__ asking
//    for kBackMinBlocks blocks an SM, which lets ptxas take up to 168
//    registers in float32 (it takes 128 unasked, which was slower, as were
//    blocks of 256 threads).
//
// Every thread runs ipddp_step.cuh's per-step math on the same values in
// the same order, so the outputs are bit for bit those of the batch-last
// kernel this one replaced.
#include "ipddp_step.cuh"
#include "sweep_stage.cuh"

namespace cddp {

// Block size: 128 threads in float32, 64 in float64, so that the tiles of
// every operand layout at m <= 10 fit a block's shared memory (see the
// static_assert below).
#ifdef CDDP_F64
constexpr int kBackThreads = 64;
#else
constexpr int kBackThreads = 128;
#endif
// Resident blocks an SM is to hold: in float32 ptxas may then take up to
// 168 registers, where it takes 128 unasked.
constexpr int kBackMinBlocks = 3;

template <int NX, int NU, int M>
struct BackwardShape {
  // Values a step of the step operands A, Bm, lx, lu, lxx, luu, lux, Y, S,
  // G, Gx, Gu.
  static constexpr int D[12] = {NX * NX, NX * NU, NX, NU, NX * NX, NU * NU,
                                NU * NX, M,       M,  M,  M * NX,  M * NU};
};

template <typename T>
struct BackwardArgs {
  const T* in[16];      // A, Bm, lx, lu, lxx, luu, lux, Y, S, G, Gx, Gu, Vx, Vxx, mu, reg
  TileOperand op[12];   // the step operands' layout
  long long bs_tail[4]; // batch strides of Vx, Vxx, mu, reg
  long long vs_tail[2]; // value strides of Vx, Vxx
  T* out[9];            // k_u, K_u, k_y, K_y, k_s, K_s, Vx_seq, Vxx_seq, stats: batch-last
  int V, W, N, B;  // per-instance and per-step values a step (TileStage), steps, batch
};

template <typename T>
using BackIn = TileStage<T, kBackThreads>;

// The per-pass driver's layout: the cost Hessians and constraint Jacobians
// constant, everything else per instance.
template <typename T, int NX, int NU, int M>
constexpr int ipddp_backward_main_smem() {
  using Sh = BackwardShape<NX, NU, M>;
  return BackIn<T>::bytes(
      Sh::D[0] + Sh::D[1] + Sh::D[2] + Sh::D[3] + Sh::D[6] + Sh::D[7] + Sh::D[8] + Sh::D[9],
      0, Sh::D[4] + Sh::D[5] + Sh::D[10] + Sh::D[11]);
}

// Start copying step t of instance b into the stage; the caller commits.
template <typename T, int NX, int NU, int M>
__device__ void stage_step(const BackIn<T>& in, const BackwardArgs<T>& a, int t, int stage,
                           int b) {
  using Sh = BackwardShape<NX, NU, M>;
  in.template fetch<Sh::D[0]>(a.in[0], a.op[0], stage, t, b, a.B);
  in.template fetch<Sh::D[1]>(a.in[1], a.op[1], stage, t, b, a.B);
  in.template fetch<Sh::D[2]>(a.in[2], a.op[2], stage, t, b, a.B);
  in.template fetch<Sh::D[3]>(a.in[3], a.op[3], stage, t, b, a.B);
  in.template fetch<Sh::D[4]>(a.in[4], a.op[4], stage, t, b, a.B);
  in.template fetch<Sh::D[5]>(a.in[5], a.op[5], stage, t, b, a.B);
  in.template fetch<Sh::D[6]>(a.in[6], a.op[6], stage, t, b, a.B);
  in.template fetch<Sh::D[7]>(a.in[7], a.op[7], stage, t, b, a.B);
  in.template fetch<Sh::D[8]>(a.in[8], a.op[8], stage, t, b, a.B);
  in.template fetch<Sh::D[9]>(a.in[9], a.op[9], stage, t, b, a.B);
  in.template fetch<Sh::D[10]>(a.in[10], a.op[10], stage, t, b, a.B);
  in.template fetch<Sh::D[11]>(a.in[11], a.op[11], stage, t, b, a.B);
}

template <typename T, int NX, int NU, int M>
__global__ void __launch_bounds__(kBackThreads, kBackMinBlocks) ipddp_backward_kernel(
    const __grid_constant__ BackwardArgs<T> a) {
  using Sh = BackwardShape<NX, NU, M>;
  extern __shared__ __align__(16) unsigned char cddp_smem[];
  const BackIn<T> in{reinterpret_cast<T*>(cddp_smem), a.V, a.W};
  const int b = blockIdx.x * kBackThreads + threadIdx.x, N = a.N;
  const bool live = b < a.B;

  // The block stages its constants and every thread its last step, then
  // reads its terminal value and scalars (read once).
  in.template fetch_constant<Sh::D[4]>(a.in[4], a.op[4]);
  in.template fetch_constant<Sh::D[5]>(a.in[5], a.op[5]);
  in.template fetch_constant<Sh::D[10]>(a.in[10], a.op[10]);
  in.template fetch_constant<Sh::D[11]>(a.in[11], a.op[11]);
  stage_step<T, NX, NU, M>(in, a, N - 1, 0, b);
  cp_async_commit();

  T Vx[NX] = {}, Vxx[NX][NX] = {}, m = T(0), r = T(0);
  if (live) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      Vx[i] = a.in[12][b * a.bs_tail[0] + i * a.vs_tail[0]];
#pragma unroll
      for (int j = 0; j < NX; ++j)
        Vxx[i][j] = a.in[13][b * a.bs_tail[1] + (i * NX + j) * a.vs_tail[1]];
    }
    m = a.in[14][b * a.bs_tail[2]];
    r = a.in[15][b * a.bs_tail[3]];
  }
  T dv0 = T(0), dv1 = T(0), inf_du = T(0), inf_pr = T(0), inf_comp = T(0), step = T(0);
  bool ok = true;

  for (int t = N - 1; t >= 0; --t) {
    const int s = (N - 1 - t) & 1;
    // Stage step t - 1 while step t computes; the stage it fills was last
    // read before the barrier that closed step t + 1.
    if (t > 0) stage_step<T, NX, NU, M>(in, a, t - 1, s ^ 1, b);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    if (live) {
      T At[NX][NX], Bt[NX][NU], lxt[NX], lut[NU], lxxt[NX][NX], luut[NU][NU],
          luxt[NU][NX], y[M], sl[M], g[M], Gxt[M][NX], Gut[M][NU];
      in.load(a.op[0], s, At);
      in.load(a.op[1], s, Bt);
      in.load(a.op[2], s, lxt);
      in.load(a.op[3], s, lut);
      in.load(a.op[4], s, lxxt);
      in.load(a.op[5], s, luut);
      in.load(a.op[6], s, luxt);
      in.load(a.op[7], s, y);
      in.load(a.op[8], s, sl);
      in.load(a.op[9], s, g);
      in.load(a.op[10], s, Gxt);
      in.load(a.op[11], s, Gut);

      Condensed<T, M> cd;
      condense<T, M>(y, sl, g, m, cd);
      IpStep<T, NX, NU> o;
      condensed_step<T, NX, NU, M>(At, Bt, lxt, lut, lxxt, luut, luxt, y, Gxt, Gut, cd, r,
                                   Vx, Vxx, o);
      T kyt[M], Kyt[M][NX], kst[M], Kst[M][NX];
      path_gains<T, NX, NU, M>(y, cd, Gxt, Gut, o.k, o.K, kyt, Kyt, kst, Kst);

      // Batch-last (N, ..., B) outputs: a warp's stores are coalesced.
      const size_t Bs = a.B;
      auto at = [&](int q, int D, int i) -> T& {
        return a.out[q][(size_t(t) * D + i) * Bs + b];
      };
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        at(0, NU, i) = o.k[i];
#pragma unroll
        for (int k = 0; k < NX; ++k) at(1, NU * NX, i * NX + k) = o.K[i][k];
      }
#pragma unroll
      for (int i = 0; i < M; ++i) {
        at(2, M, i) = kyt[i];
        at(4, M, i) = kst[i];
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          at(3, M * NX, i * NX + k) = Kyt[i][k];
          at(5, M * NX, i * NX + k) = Kst[i][k];
        }
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        at(6, NX, i) = Vx[i];
#pragma unroll
        for (int k = 0; k < NX; ++k) at(7, NX * NX, i * NX + k) = Vxx[i][k];
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
    // The next step's copies fill the stage this one read only after every
    // thread has finished reading it.
    __syncthreads();
  }

  if (live) {
    const T vals[7] = {dv0, dv1, inf_du, inf_pr, inf_comp, step, ok ? T(1) : T(0)};
#pragma unroll
    for (int i = 0; i < 7; ++i) a.out[8][size_t(i) * a.B + b] = vals[i];
  }
}

// Every layout fits: all twelve step operands per instance.
template <typename T, int NX, int NU, int M>
constexpr int ipddp_backward_worst_smem() {
  using Sh = BackwardShape<NX, NU, M>;
  int V = 0;
  for (int o = 0; o < 12; ++o) V += Sh::D[o];
  return BackIn<T>::bytes(V, 0, 0);
}
// Each build checks its own type (float64 blocks are narrower).
static_assert(ipddp_backward_worst_smem<scalar_t, 3, 2, 10>() <= 232448 &&
                  ipddp_backward_worst_smem<scalar_t, 3, 2, 5>() <= 232448 &&
                  ipddp_backward_worst_smem<scalar_t, 2, 1, 2>() <= 232448,
              "the tiles of a fully per-instance layout must fit a block's shared memory");

// in: the 16 inputs; strides: each one's (batch, step, value) strides in
// elements, its values (the inner block, row-major) evenly spaced; the step
// stride of Vx, Vxx, mu and reg unused; out: the 9 contiguous batch-last
// outputs, (N, ..., B) and stats (7, B).
template <typename T, int NX, int NU, int M>
int launch_ipddp_backward(const T* const* in, const long long* strides, T* const* out, int N,
                          int B, cudaStream_t stream) {
  using Sh = BackwardShape<NX, NU, M>;
  BackwardArgs<T> a{};
  int C;
  tile_layout(Sh::D, strides, a.op, a.V, a.W, C);
  for (int i = 0; i < 16; ++i) a.in[i] = in[i];
  for (int i = 0; i < 4; ++i) a.bs_tail[i] = strides[3 * (12 + i)];
  for (int i = 0; i < 2; ++i) a.vs_tail[i] = strides[3 * (12 + i) + 2];
  for (int i = 0; i < 9; ++i) a.out[i] = out[i];
  a.N = N;
  a.B = B;
  const int blocks = (B + kBackThreads - 1) / kBackThreads;
  const int smem = BackIn<T>::bytes(a.V, a.W, C);
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)ipddp_backward_kernel<T, NX, NU, M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ipddp_backward_kernel<T, NX, NU, M><<<blocks, kBackThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// (nx, nu, m) of ipddp_riccati.KERNEL_SHAPES: the unicycle with a control
// box (m=4), a state box (6), both (10), or a control box and a keep-out
// ball (5); the pendulum with its control box (2, 1, 2). Registered with the
// per-pass driver's layout of a box stack.
#define CDDP_IPDDP_BACKWARD(NX, NU, M)                                                 \
  extern "C" int CDDP_EXPORT(cddp_ipddp_backward_##NX##x##NU##x##M)(                   \
      const scalar_t* const* in, const long long* strides, scalar_t* const* out, int N, \
      int B, void* stream) {                                                           \
    return cddp::launch_ipddp_backward<scalar_t, NX, NU, M>(                           \
        in, strides, out, N, B, static_cast<cudaStream_t>(stream));                    \
  }                                                                                    \
  CDDP_REGISTER(cddp_ipddp_backward_##NX##x##NU##x##M,                                 \
                (cddp::ipddp_backward_kernel<scalar_t, NX, NU, M>), cddp::kBackThreads, \
                (cddp::ipddp_backward_main_smem<scalar_t, NX, NU, M>()))

CDDP_IPDDP_BACKWARD(3, 2, 4)
CDDP_IPDDP_BACKWARD(3, 2, 5)
CDDP_IPDDP_BACKWARD(3, 2, 6)
CDDP_IPDDP_BACKWARD(3, 2, 10)
CDDP_IPDDP_BACKWARD(2, 1, 2)
CDDP_IPDDP_BACKWARD(4, 2, 4)
