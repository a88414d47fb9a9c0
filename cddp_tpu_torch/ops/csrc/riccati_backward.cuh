// Streamed CLDDP backward pass, one thread per problem instance: the kernel
// template, its operands' layout and its launcher macro (riccati_backward.cu
// instantiates it; riccati_team.cuh is the form for the shapes whose step
// one thread spills).
//
// Replaces cddp_tpu/ops/pallas/riccati.py::make_backward_kernel (:236). The
// Pallas kernel walks a (batch tile, time) grid with the value function
// carried in VMEM scratch between grid steps; here each thread walks its own
// horizon backwards with Vx, Vxx and the running sums in registers, so
// nothing carries between blocks.
//
// Bound: device memory at nu <= 2, operations from nu = 3 (the enumerated
// BoxQP's 27 active sets a step). Per instance and step it reads the stage
// data (A, B, the cost gradients, lux, the bounds: 30 values at nx=3, nu=2)
// and writes k and K (8); the cost Hessians are one broadcast copy. The
// design:
//
// 1. Operands are read where they lie. The launcher takes every input's
//    batch, step and value strides (ops/kernels/operands.py), so the wrapper
//    copies nothing; a broadcast (the quadratic cost's lxx and luu, stride 0
//    on batch and step) is read from its one copy.
// 2. At the small shapes (nx nu <= 8, riccati_staged) the block stages
//    kRiccatiChunk = 4 steps at a time in shared memory
//    (sweep_stage.cuh::CoopStage): the per-pass driver's operands are
//    batch-first, so an instance's four steps of an operand are one run of
//    device memory, which neighbouring threads copy together (cp.async).
//    Read one step at a time, in place or staged, each instance's run of a
//    step is as short as 8 bytes, and the kernel took 3.3x its time (an
//    A/B on an NVIDIA H100, PERF.md §6). One stage, filled by the block
//    and then read: two took the blocks the reads' latency needs.
// 3. At nu = 3 (the attitude trio, 6x2 and 8x3) each thread reads its
//    operands in place, a step at a time: the step's 27 BoxQP active sets
//    bound it, and a stage of its 86-138 values a thread took 20-45% longer.
// 4. The outputs stay batch-last, so a warp's stores are coalesced and the
//    line-search rollout reads k and K without a copy.
#pragma once

#include "clddp_step.cuh"
#include "sweep_stage.cuh"

namespace cddp {

template <int NX, int NU>
struct RiccatiShape {
  // Values a step of the step operands A, Bm, lx, lu, lxx, luu, lux, lb, ub.
  static constexpr int D[9] = {NX * NX, NX * NU, NX, NU, NX * NX, NU * NU, NU * NX, NU, NU};
  // The per-pass driver's layout: lxx and luu constant (the quadratic
  // cost's expanded Hessians), every other step operand per instance.
  static constexpr int kMainValues = D[0] + D[1] + D[2] + D[3] + D[6] + D[7] + D[8];
  static constexpr int kMainConsts = D[4] + D[5];
};

template <typename T>
struct RiccatiArgs {
  const T* in[12];       // A, Bm, lx, lu, lxx, luu, lux, lb, ub, Vx, Vxx, reg
  TileOperand op[9];     // the step operands' layout
  long long bs_tail[3];  // batch strides of Vx, Vxx, reg
  long long vs_tail[2];  // value strides of Vx, Vxx
  T* out[4];             // k (N, nu, B), K (N, nu, nx, B), dV (2, B), stats (3, B)
  int V, W, C, N, B;     // per-instance, per-step and constant values (TileStage), steps, batch
};

// in: the 12 inputs; strides: each one's (batch, step, value) strides in
// elements, its values (the inner block, row-major) evenly spaced; the step
// stride of Vx, Vxx and reg unused; out: the 4 contiguous batch-last outputs.
template <typename T, int NX, int NU>
RiccatiArgs<T> riccati_args(const T* const* in, const long long* strides, T* const* out, int N,
                            int B) {
  RiccatiArgs<T> a{};
  tile_layout(RiccatiShape<NX, NU>::D, strides, a.op, a.V, a.W, a.C);
  for (int i = 0; i < 12; ++i) a.in[i] = in[i];
  for (int i = 0; i < 3; ++i) a.bs_tail[i] = strides[3 * (9 + i)];
  for (int i = 0; i < 2; ++i) a.vs_tail[i] = strides[3 * (9 + i) + 2];
  for (int i = 0; i < 4; ++i) a.out[i] = out[i];
  a.N = N;
  a.B = B;
  return a;
}

// Block size of the one-thread form: 128 threads in float32, 64 in float64
// (the same stage bytes).
#ifdef CDDP_F64
constexpr int kRiccatiThreads = 64;
#else
constexpr int kRiccatiThreads = 128;
#endif

// Steps a stage holds.
constexpr int kRiccatiChunk = 4;

// Whether the one-thread form stages its operands (else each thread reads
// its own where they lie, step by step).
template <int NX, int NU>
constexpr bool riccati_staged() {
  return NX * NU <= 8;
}

template <typename T, int NX, int NU>
constexpr int riccati_main_smem() {
  using Sh = RiccatiShape<NX, NU>;
  return riccati_staged<NX, NU>()
             ? coop_stage_bytes<T>(kRiccatiThreads, Sh::kMainValues, 0, Sh::kMainConsts,
                                   kRiccatiChunk)
             : 0;
}

// Resident blocks an SM is to hold, which caps ptxas's registers (65,536 /
// (TH x blocks)): as many as the stage's shared memory lets an SM hold at
// the staged shapes (unasked, ptxas held every operand's strides in
// registers across the horizon and took more than the blocks left it), two
// (its 255) at the others.
template <typename T, int NX, int NU>
constexpr int riccati_min_blocks() {
  return riccati_staged<NX, NU>() ? 233472 / (riccati_main_smem<T, NX, NU>() + 1024) : 2;
}

template <typename T, int TH>
using RiccatiIn = CoopStage<T, TH, kRiccatiChunk>;

// Start copying steps t0 .. t0 + S - 1 (those in [0, N)) of the block's
// instances from b0 into the stage; the caller commits.
template <typename T, int NX, int NU, int TH>
__device__ void riccati_stage_steps(const RiccatiIn<T, TH>& in, const RiccatiArgs<T>& a,
                                    int t0, int b0) {
  using Sh = RiccatiShape<NX, NU>;
  in.template fetch<Sh::D[0]>(a.in[0], a.op[0], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[1]>(a.in[1], a.op[1], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[2]>(a.in[2], a.op[2], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[3]>(a.in[3], a.op[3], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[4]>(a.in[4], a.op[4], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[5]>(a.in[5], a.op[5], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[6]>(a.in[6], a.op[6], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[7]>(a.in[7], a.op[7], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[8]>(a.in[8], a.op[8], t0, a.N, b0, a.B);
}

// Operand o's D values of instance b at step t, where they lie.
template <typename T, int D>
__device__ __forceinline__ void riccati_read(const RiccatiArgs<T>& a, int o, int b, int t,
                                             T* v) {
  const TileOperand& op = a.op[o];
  const T* p = a.in[o] + b * op.bs + t * op.ts;
#pragma unroll
  for (int i = 0; i < D; ++i) v[i] = p[i * op.vs];
}

template <typename T, int NX, int NU, int TH>
__global__ void __launch_bounds__(TH, (riccati_min_blocks<T, NX, NU>())) riccati_backward_kernel(
    const __grid_constant__ RiccatiArgs<T> a) {
  using Sh = RiccatiShape<NX, NU>;
  constexpr int S = kRiccatiChunk;
  extern __shared__ __align__(16) unsigned char cddp_smem[];
  const RiccatiIn<T, TH> in{reinterpret_cast<T*>(cddp_smem), coop_pitch(S * a.V), a.W};
  const int b0 = blockIdx.x * TH, b = b0 + threadIdx.x, N = a.N;
  const bool live = b < a.B;

  // Each thread reads its terminal value and regularization (read once).
  T Vx[NX] = {}, Vxx[NX][NX] = {}, r = T(0);
  if (live) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      Vx[i] = a.in[9][b * a.bs_tail[0] + i * a.vs_tail[0]];
#pragma unroll
      for (int j = 0; j < NX; ++j)
        Vxx[i][j] = a.in[10][b * a.bs_tail[1] + (i * NX + j) * a.vs_tail[1]];
    }
    r = a.in[11][b * a.bs_tail[2]];
  }
  T dv0 = T(0), dv1 = T(0), qerr = T(0), nvx = T(0), ok = T(1);
  const size_t Bs = a.B;

  // Chunk c holds steps N - (c + 1) S .. N - c S - 1, walked backwards.
  const int chunks = riccati_staged<NX, NU>() ? (N + S - 1) / S : N;
  for (int c = 0; c < chunks; ++c) {
    int lo, hi;  // the chunk's steps lo .. hi - 1
    if constexpr (riccati_staged<NX, NU>()) {
      // The block fills the stage (its constants with the first chunk),
      // after the barrier that closed the chunk before, then reads it.
      hi = N - c * S;
      lo = hi - S;
      if (c == 0) {
        in.template fetch_constant<Sh::D[0]>(a.in[0], a.op[0]);
        in.template fetch_constant<Sh::D[1]>(a.in[1], a.op[1]);
        in.template fetch_constant<Sh::D[2]>(a.in[2], a.op[2]);
        in.template fetch_constant<Sh::D[3]>(a.in[3], a.op[3]);
        in.template fetch_constant<Sh::D[4]>(a.in[4], a.op[4]);
        in.template fetch_constant<Sh::D[5]>(a.in[5], a.op[5]);
        in.template fetch_constant<Sh::D[6]>(a.in[6], a.op[6]);
        in.template fetch_constant<Sh::D[7]>(a.in[7], a.op[7]);
        in.template fetch_constant<Sh::D[8]>(a.in[8], a.op[8]);
      }
      riccati_stage_steps<T, NX, NU, TH>(in, a, lo, b0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    } else {
      hi = N - c;
      lo = hi - 1;
    }

    for (int t = hi - 1; live && t >= 0 && t >= lo; --t) {
      T At[NX][NX], Bt[NX][NU], lxt[NX], lut[NU], lxxt[NX][NX], luut[NU][NU],
          luxt[NU][NX], lbt[NU], ubt[NU];
      if constexpr (riccati_staged<NX, NU>()) {
        const int s = t - lo;
        in.load(a.op[0], s, At);
        in.load(a.op[1], s, Bt);
        in.load(a.op[2], s, lxt);
        in.load(a.op[3], s, lut);
        in.load(a.op[4], s, lxxt);
        in.load(a.op[5], s, luut);
        in.load(a.op[6], s, luxt);
        in.load(a.op[7], s, lbt);
        in.load(a.op[8], s, ubt);
      } else {
        riccati_read<T, NX * NX>(a, 0, b, t, &At[0][0]);
        riccati_read<T, NX * NU>(a, 1, b, t, &Bt[0][0]);
        riccati_read<T, NX>(a, 2, b, t, lxt);
        riccati_read<T, NU>(a, 3, b, t, lut);
        riccati_read<T, NX * NX>(a, 4, b, t, &lxxt[0][0]);
        riccati_read<T, NU * NU>(a, 5, b, t, &luut[0][0]);
        riccati_read<T, NU * NX>(a, 6, b, t, &luxt[0][0]);
        riccati_read<T, NU>(a, 7, b, t, lbt);
        riccati_read<T, NU>(a, 8, b, t, ubt);
      }

      StepOut<T, NX, NU> o;
      clddp_backward_step<T, NX, NU>(At, Bt, lxt, lut, lxxt, luut, luxt, lbt, ubt, Vx, Vxx, r,
                                     o);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        a.out[0][(size_t(t) * NU + i) * Bs + b] = o.k[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) a.out[1][((size_t(t) * NU + i) * NX + j) * Bs + b] = o.K[i][j];
      }
      dv0 = dv0 + o.dv0;
      dv1 = dv1 + o.dv1;
      qerr = nan_max(qerr, o.qu_absmax);
      T sum = T(0);
#pragma unroll
      for (int i = 0; i < NX; ++i) sum = sum + dabs(Vx[i]);
      nvx = nvx + sum;
      ok = ok * (o.fail ? T(0) : T(1));
    }
    // The next chunk's copies refill the stage only after every thread has
    // read this one.
    if constexpr (riccati_staged<NX, NU>()) __syncthreads();
  }
  if (live) {
    a.out[2][b] = dv0;
    a.out[2][Bs + b] = dv1;
    a.out[3][b] = qerr;
    a.out[3][Bs + b] = nvx;
    a.out[3][2 * Bs + b] = ok;
  }
}

// The per-pass driver's layout fits a block's shared memory at every staged
// shape (at most 4x2: 42 values a step, four steps).
template <typename T, int NX, int NU, int TH = kRiccatiThreads>
int launch_riccati_backward(const T* const* in, const long long* strides, T* const* out, int N,
                            int B, cudaStream_t stream) {
  static_assert(riccati_main_smem<T, NX, NU>() <= 232448,
                "the per-pass driver's layout must fit a block's shared memory");
  const RiccatiArgs<T> a = riccati_args<T, NX, NU>(in, strides, out, N, B);
  const int blocks = (B + TH - 1) / TH;
  // Unstaged, the kernel takes no shared memory.
  const int smem =
      riccati_staged<NX, NU>() ? coop_stage_bytes<T>(TH, a.V, a.W, a.C, kRiccatiChunk) : 0;
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)riccati_backward_kernel<T, NX, NU, TH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  riccati_backward_kernel<T, NX, NU, TH><<<blocks, TH, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// The launcher of shape (NX, NU) in the one-thread form, registered with
// the per-pass driver's layout.
#define CDDP_RICCATI_BACKWARD(NX, NU)                                                  \
  extern "C" int CDDP_EXPORT(cddp_riccati_backward_##NX##x##NU)(                       \
      const scalar_t* const* in, const long long* strides, scalar_t* const* out, int N, \
      int B, void* stream) {                                                           \
    return cddp::launch_riccati_backward<scalar_t, NX, NU>(                            \
        in, strides, out, N, B, static_cast<cudaStream_t>(stream));                    \
  }                                                                                    \
  namespace cddp_riccati_backward_##NX##x##NU {                                        \
  constexpr int TH = cddp::kRiccatiThreads;                                            \
  CDDP_REGISTER(cddp_riccati_backward_##NX##x##NU,                                     \
                (cddp::riccati_backward_kernel<scalar_t, NX, NU, TH>), TH,              \
                (cddp::riccati_main_smem<scalar_t, NX, NU>()))                         \
  }
