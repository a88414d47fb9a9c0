// Interior-point forward trial: one thread per problem instance.
//
// Replaces cddp_tpu/ops/pallas/ip_rollout.py::_make_ip_forward_kernel (:248),
// one trial of the IPDDP line search (the scan body of solvers/ipddp.py
// _forward_pass, ipddp.py:1091-1131). Per time step:
//   dx = x - Xb;  lam = lam + a_pr k_lam + K_lam dx;
//   s = s + a_pr k_s + K_s dx;  y = y + a_du k_y + K_y dx;
//   u = Ub + a_pr k_u + K_u dx;  J += l(x, u);  g = box rows(x, u);
//   optional slack re-closure s := -g where it passes fraction-to-boundary;
//   feasible &= ftb(s) & ftb(y) & all finite;  x = f_d(x, u).
// The state, the cost and the feasibility flag stay in registers for the
// whole horizon.
//
// Bound: device memory. Per instance and step it reads 4 nx + 2 nu + 4 m +
// nx (nx + nu + 2 m) values of nominal trajectory and gains (68 at the
// unicycle's m=4, 508 at the quadrotor's 13x4 with m=8) and writes 2 nx + nu
// + 3m, against a few hundred flops and the model's step. The design:
//
// 1. Operands are read where they lie (ops/kernels/operands.py): every
//    input comes with its batch, step and value strides, so the wrapper
//    copies nothing. The per-pass driver hands on the nominal X, Lambda and
//    the costate gains as batch-first slices (X[:, :-1], K_lambda[:, :-1])
//    and kernel 6's gains as batch-last views, which a warp reads
//    coalesced; a broadcast input is read from its one copy. Each step
//    takes an operand's row pointer once and reads a gain row as it sums
//    it, not the whole matrix into registers.
// 2. At nx <= 3 (fwd_staged) the block stages X, Lambda and the costate
//    gains kFwdChunk = 4 steps at a time in shared memory (sweep_stage.cuh::
//    CoopStage, one stage), in both dtypes and whatever their strides: an
//    instance's four steps of a batch-first operand are one run of device
//    memory, where one step's is 8-36 bytes. Every other operand, and every
//    operand at larger nx, is read in place: a stage of the larger shapes'
//    operands (200-500 values a thread, one or two stages) left 1-2 blocks
//    an SM and took 1.5-8x the device time (PERF.md §6).
// 3. A cost lane's parameters (MPCC's 323 a car), read every step, are
//    staged in shared memory once a launch where they fit a block.
// 4. Blocks of kFwdThreads = 128. The outputs stay batch-last: kernel 6,
//    next, reads them without a copy.
//
// TRACK (the `_track` launchers) is the tracking variant: the JAX kernel's
// "quadratic_track" cost lane (ip_rollout.py:136-163), whose per-step stage
// parameter is the reference row. Step t's running cost tracks row t of the
// shared (N, nx) reference `refs` (models.cuh::running_ref).
//
// Cost (a user cost lane, lanes.cuh) replaces the quadratic cost with the
// lane's Cost::cost(x, u, cp, w, t): cp is each instance's parameter row of
// a (B, n_cp) tensor (or its broadcast), staged or where it lies, and w the
// lane's constants (CostArgs, by value). void: the quadratic cost.
//
// The kernel template and its launcher macros; ip_forward.cu instantiates
// it for the registered models, a lane library (ops/kernels/build.py) for a
// header's lanes.
#pragma once

#include "ipddp_step.cuh"
#include "lanes.cuh"
#include "models.cuh"
#include "sweep_stage.cuh"

namespace cddp {

constexpr int kFwdThreads = 128;
// Shared memory a block may take for its instances' cost-lane parameters.
constexpr int kFwdBlockBytes = 232448;
// Steps of the staged operands a stage holds.
constexpr int kFwdChunk = 4;

// Whether the kernel of state size NX stages the operands the per-pass
// driver hands over batch-first (X, Lambda and the costate gains: 3 nx +
// nx^2 values a step), in both dtypes and whatever their strides: at nx <=
// 3 staged they took the unicycle's trial from 1.12 to 0.79 ms and the
// pendulum's from 3.75 to 2.20; at nx = 4 (28 values) the stage left fewer
// blocks an SM and was slower than reading in place, which the other
// shapes keep (an NVIDIA H100, PERF.md §6).
template <int NX>
constexpr bool fwd_staged() {
  return NX <= 3;
}
// Whether step operand o is one of those: Xb, klam, Klam or lam.
__host__ __device__ constexpr bool fwd_stages_operand(int o) {
  return o == 0 || o == 6 || o == 7 || o == 8;
}
// Staged values a step, the stage's row pitch and its bytes a block.
template <int NX>
constexpr int fwd_stage_values() {
  return fwd_staged<NX>() ? 3 * NX + NX * NX : 0;
}
template <int NX>
constexpr int fwd_stage_pitch() {
  return fwd_staged<NX>() ? coop_pitch(kFwdChunk * fwd_stage_values<NX>()) : 0;
}
template <typename T, int NX>
constexpr int fwd_stage_bytes() {
  return fwd_staged<NX>() ? coop_stage_bytes<T>(kFwdThreads, fwd_stage_values<NX>(), 0, 0,
                                                kFwdChunk)
                          : 0;
}
// An operand read where it lies, outside the stage.
constexpr int kInPlace = 3;

template <int NX, int NU, int M>
struct FwdShape {
  // Values a step of Xb, Ub, Y, S, ku, Ku, klam, Klam, lam, ky, Ky, ks, Ks.
  static constexpr int D[13] = {NX, NU, M,  M, NU, NU * NX, NX,
                                NX * NX, NX, M, M * NX, M, M * NX};
};

template <typename T>
struct FwdArgs {
  const T* in[13];           // Xb, Ub, Y, S, ku, Ku, klam, Klam, lam, ky, Ky, ks, Ks
  TileOperand op[13];        // their strides, and each one's place (staged or kInPlace)
  int dim[13];               // their values a step
  const T* x0;
  const T* apr;
  const T* adu;
  const T* tau;
  const unsigned char* soc;  // bool
  const T* cp;               // a cost lane's parameters (B, n_cp), or null
  long long x0_bs, x0_vs, apr_bs, adu_bs, tau_bs, soc_bs, cp_bs, cp_vs;
  T* out[8];                 // X, U, S, Y, G, Lam (N, d, B), J, F (B)
  int N, B;
  int ncp, cp_pitch;         // n_cp; the staged parameters' row pitch (-1: read in place)
};

// A row of values: p[i * s].
template <typename T>
struct FwdView {
  const T* p;
  long long s;
  __device__ __forceinline__ T operator[](int i) const { return p[i * s]; }
};

// The step operands' layout from their (batch, step, value) strides. At nx
// <= 3 Xb, klam, Klam and lam are staged, kFwdChunk steps at a time, by
// shape alone: the stage's copies read any strides (a batch-first run of an
// instance's steps, a batch-last view's neighbouring instances, a
// broadcast's one copy). Every other operand, and every operand at larger
// nx, is read where it lies.
template <typename T, int NX, int NU, int M>
void fwd_layout(const long long* strides, FwdArgs<T>& a) {
  using Sh = FwdShape<NX, NU, M>;
  int off = 0;
  for (int o = 0; o < 13; ++o) {
    const bool staged = fwd_staged<NX>() && fwd_stages_operand(o);
    a.op[o] = TileOperand{strides[3 * o], strides[3 * o + 1], strides[3 * o + 2],
                          staged ? kPerInstance : kInPlace, staged ? off : 0};
    a.dim[o] = Sh::D[o];
    if (staged) off += Sh::D[o];
  }
}

template <typename T>
using FwdIn = CoopStage<T, kFwdThreads, kFwdChunk>;

// Start copying steps t0 .. t0 + kFwdChunk - 1 of the staged operands of
// the block's instances from b0 into the stage; the caller commits.
template <typename T, int NX, int NU, int M>
__device__ void fwd_stage_steps(const FwdIn<T>& in, const FwdArgs<T>& a, int t0, int b0) {
  using Sh = FwdShape<NX, NU, M>;
  in.template fetch<Sh::D[0]>(a.in[0], a.op[0], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[6]>(a.in[6], a.op[6], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[7]>(a.in[7], a.op[7], t0, a.N, b0, a.B);
  in.template fetch<Sh::D[8]>(a.in[8], a.op[8], t0, a.N, b0, a.B);
}

// Start copying the cost lane's parameters of the block's instances (a
// row of cp_pitch each; one row for a broadcast) to `to`, once a launch.
template <typename T>
__device__ void fwd_stage_params(T* to, const FwdArgs<T>& a, int b0) {
  const int n = a.cp_bs == 0 ? 1 : min(kFwdThreads, a.B - b0), ncp = a.ncp;
  if (a.cp_vs == 1) {
    for (int idx = threadIdx.x; idx < n * ncp; idx += kFwdThreads) {
      const int x = idx / ncp, v = idx - x * ncp;
      cp_async(to + x * a.cp_pitch + v, a.cp + (long long)(b0 + x) * a.cp_bs + v);
    }
  } else if (int(threadIdx.x) < n) {
    const int x = threadIdx.x;
    for (int v = 0; v < ncp; ++v)
      cp_async(to + x * a.cp_pitch + v, a.cp + (long long)(b0 + x) * a.cp_bs + v * a.cp_vs);
  }
}

template <typename T, class Mdl, int M, bool TRACK, class Cost>
__global__ void __launch_bounds__(kFwdThreads) ip_forward_kernel(
    const __grid_constant__ FwdArgs<T> a, const T* __restrict__ refs,
    const __grid_constant__ Consts<T, Mdl> c,
    const __grid_constant__ BoxRows<T, M, Mdl::NX, Mdl::NU> rows, int integrator, int slack_soc,
    const __grid_constant__ CostArgs<T, Cost> ca) {
  constexpr int NX = Mdl::NX, NU = Mdl::NU;
  extern __shared__ __align__(16) unsigned char cddp_smem[];
  const FwdIn<T> in{reinterpret_cast<T*>(cddp_smem), fwd_stage_pitch<NX>(), 0};
  // A cost lane's parameters, after the stage.
  T* const cps = in.consts();
  const int b0 = blockIdx.x * kFwdThreads, b = b0 + threadIdx.x, N = a.N;
  const bool live = b < a.B;
  const size_t Bs = a.B;

  if constexpr (!std::is_void_v<Cost>) {
    if (a.cp_pitch >= 0) {
      fwd_stage_params<T>(cps, a, b0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
  }

  T x[NX], a_pr = T(0), a_du = T(0), tau = T(0);
  bool soc_on = false;
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = T(0);
  if (live) {
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = a.x0[b * a.x0_bs + i * a.x0_vs];
    a_pr = a.apr[b * a.apr_bs];
    a_du = a.adu[b * a.adu_bs];
    tau = a.tau[b * a.tau_bs];
    soc_on = a.soc[b * a.soc_bs] != 0;
  }
  T J = T(0);
  bool ok = true;

  for (int t = 0; t < N; ++t) {
    if (fwd_staged<NX>() && t % kFwdChunk == 0) {
      // The block refills the stage with the next kFwdChunk steps once
      // every thread has read the last.
      __syncthreads();
      fwd_stage_steps<T, NX, NU, M>(in, a, t, b0);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    if (!live) continue;
    // Operand o's values of step t, staged or where they lie.
    auto view = [&](int o) -> FwdView<T> {
      const TileOperand& op = a.op[o];
      if (fwd_staged<NX>() && fwd_stages_operand(o))
        return {in.base + threadIdx.x * in.pitch + kFwdChunk * op.off +
                    (t % kFwdChunk) * a.dim[o],
                1};
      return {a.in[o] + b * op.bs + t * op.ts, op.vs};
    };
    const FwdView<T> Xb = view(0), Ub = view(1), Y = view(2), S = view(3), kuv = view(4),
                     Kuv = view(5), klam = view(6), Klam = view(7), lam = view(8),
                     kyv = view(9), Kyv = view(10), ksv = view(11), Ksv = view(12);
    T dx[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = x[i] - Xb[i];
    // v + a k + K dx, with the product summed on its own first; K's row i
    // is read as it is summed.
    auto step = [&](const FwdView<T>& v, const FwdView<T>& k, const FwdView<T>& K, int i,
                    T al) {
      T s = T(0);
#pragma unroll
      for (int j = 0; j < NX; ++j) s = s + K[i * NX + j] * dx[j];
      return v[i] + al * k[i] + s;
    };
    T lam_n[NX], u[NU], s_old[M], s_n[M], y_old[M], y_n[M], g[M], xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) lam_n[i] = step(lam, klam, Klam, i, a_pr);
#pragma unroll
    for (int i = 0; i < M; ++i) {
      s_old[i] = S[i];
      y_old[i] = Y[i];
      s_n[i] = step(S, ksv, Ksv, i, a_pr);
      y_n[i] = step(Y, kyv, Kyv, i, a_du);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = step(Ub, kuv, Kuv, i, a_pr);
    if constexpr (std::is_void_v<Cost>) {
      T rf[NX];
      running_ref<TRACK>(c, refs, t, rf);
      J = J + running_cost(c, rf, x, u);
    } else {
      // This instance's parameters: its staged row, or its row where it
      // lies (LaneParams reads p[i * Bs + b]).
      const LaneParams<T> cp =
          a.cp_pitch >= 0
              ? LaneParams<T>{cps + (a.cp_bs == 0 ? 0 : threadIdx.x * a.cp_pitch), 1, 0, ca.ncp,
                              true}
              : LaneParams<T>{a.cp + b * a.cp_bs, size_t(a.cp_vs), 0, ca.ncp};
      J = J + Cost::cost(x, u, cp, ca.w, t);
    }
    rows.eval(x, u, g);
    if (slack_soc) {
#pragma unroll
      for (int i = 0; i < M; ++i)
        s_n[i] = (soc_on && ftb_ok(-g[i], s_old[i], tau)) ? -g[i] : s_n[i];
    }
    integrate<T, Mdl>(integrator, x, u, c.p, c.dt, xn);
#pragma unroll
    for (int i = 0; i < M; ++i)
      ok = ok & ftb_ok(s_n[i], s_old[i], tau) & ftb_ok(y_n[i], y_old[i], tau) &
           isfinite(s_n[i]) & isfinite(y_n[i]);
#pragma unroll
    for (int i = 0; i < NX; ++i) ok = ok & isfinite(xn[i]) & isfinite(lam_n[i]);
#pragma unroll
    for (int i = 0; i < NU; ++i) ok = ok & isfinite(u[i]);

#pragma unroll
    for (int i = 0; i < NX; ++i) {
      a.out[0][(size_t(t) * NX + i) * Bs + b] = xn[i];
      a.out[5][(size_t(t) * NX + i) * Bs + b] = lam_n[i];
      x[i] = xn[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) a.out[1][(size_t(t) * NU + i) * Bs + b] = u[i];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      a.out[2][(size_t(t) * M + i) * Bs + b] = s_n[i];
      a.out[3][(size_t(t) * M + i) * Bs + b] = y_n[i];
      a.out[4][(size_t(t) * M + i) * Bs + b] = g[i];
    }
  }
  if (live) {
    a.out[6][b] = J;
    a.out[7][b] = ok ? T(1) : T(0);
  }
}

// Dynamic shared memory of a cost lane's n_cp parameters a row (`rows`
// rows: the block's instances, or 1 for a broadcast) beside the stage, or 0
// where they do not fit (they are then read where they lie). A launch takes
// the stage's bytes and these.
template <typename T, int NX>
constexpr int fwd_param_bytes(int rows, int ncp) {
  return ncp > 0 && fwd_stage_bytes<T, NX>() + rows * coop_pitch(ncp) * int(sizeof(T)) <=
                        kFwdBlockBytes
             ? rows * coop_pitch(ncp) * int(sizeof(T))
             : 0;
}

// in: the 13 step operands, x0, a_pr, a_du, tau, soc (bool bytes) and cp
// (null without a cost lane); strides: each one's (batch, step, value)
// strides in elements (soc's in bytes), the step stride of the last six
// unused; out: X, U, S, Y, G, Lam (N, d, B) and J, F (B), contiguous.
template <typename T, class Mdl, int M, bool TRACK, class Cost = void>
int launch_ip_forward(const void* const* in, const long long* strides, T* const* out,
                      const T* refs, const double* consts, const double* rows, int N, int B,
                      int integrator, int slack_soc, cudaStream_t stream, int ncp = 0,
                      const double* weights = nullptr) {
  FwdArgs<T> a{};
  for (int i = 0; i < 13; ++i) a.in[i] = static_cast<const T*>(in[i]);
  fwd_layout<T, Mdl::NX, Mdl::NU, M>(strides, a);
  a.x0 = static_cast<const T*>(in[13]);
  a.apr = static_cast<const T*>(in[14]);
  a.adu = static_cast<const T*>(in[15]);
  a.tau = static_cast<const T*>(in[16]);
  a.soc = static_cast<const unsigned char*>(in[17]);
  a.cp = static_cast<const T*>(in[18]);
  a.x0_bs = strides[3 * 13];
  a.x0_vs = strides[3 * 13 + 2];
  a.apr_bs = strides[3 * 14];
  a.adu_bs = strides[3 * 15];
  a.tau_bs = strides[3 * 16];
  a.soc_bs = strides[3 * 17];
  a.cp_bs = strides[3 * 18];
  a.cp_vs = strides[3 * 18 + 2];
  for (int i = 0; i < 8; ++i) a.out[i] = out[i];
  a.N = N;
  a.B = B;
  a.ncp = ncp;
  const int params = std::is_void_v<Cost>
                         ? 0
                         : fwd_param_bytes<T, Mdl::NX>(a.cp_bs == 0 ? 1 : kFwdThreads, ncp);
  a.cp_pitch = params > 0 ? coop_pitch(ncp) : -1;
  const int smem = fwd_stage_bytes<T, Mdl::NX>() + params;
  if constexpr (!std::is_void_v<Cost>)
    note_launch_smem((const void*)ip_forward_kernel<T, Mdl, M, TRACK, Cost>, smem);
  const Consts<T, Mdl> c = Consts<T, Mdl>::from_host(consts);
  const auto r = BoxRows<T, M, Mdl::NX, Mdl::NU>::from_host(rows);
  const auto ca = CostArgs<T, Cost>::from_host(a.cp, ncp, weights);
  const int blocks = (B + kFwdThreads - 1) / kFwdThreads;
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)ip_forward_kernel<T, Mdl, M, TRACK, Cost>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ip_forward_kernel<T, Mdl, M, TRACK, Cost><<<blocks, kFwdThreads, smem, stream>>>(
      a, refs, c, r, integrator, slack_soc, ca);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// m (ip_rollout.KERNEL_ROWS): a control box (4), a state box (6) or both
// (10) on the unicycle, the control box on the pendulum (2), on HCW (6) and
// on the quadrotor (8: its four rotor forces), and in the goal form only the
// car's control box (4, its exact map in place of the integrator step,
// ip_rollout.py:341-344), QuadrotorRate's thrust and rate box (8) and the
// attitude trio's torque box (6), the thrust boxes of the other spacecraft
// models (6), the lander's thrust and gimbal box (4) and the small models'
// control boxes (the bicycle's 4, the others' 2);
// the goal form and (TRACK true, suffix _track) the tracking form, whose
// `refs` is the shared (N, nx) reference (NULL and unread in the goal form).
// Registered with the stage's shared memory, which every launch takes.
#define CDDP_IP_FORWARD(MODEL, STRUCT, M, TRACK, SUFFIX)                               \
  extern "C" int CDDP_EXPORT(cddp_ip_forward_##MODEL##_m##M##SUFFIX)(                  \
      const void* const* in, const long long* strides, scalar_t* const* out,           \
      const scalar_t* refs, const double* consts, const double* rows, int N, int B,    \
      int integrator, int slack_soc, void* stream) {                                   \
    return cddp::launch_ip_forward<scalar_t, cddp::STRUCT, M, TRACK>(                  \
        in, strides, out, refs, consts, rows, N, B, integrator, slack_soc,             \
        static_cast<cudaStream_t>(stream));                                            \
  }                                                                                    \
  CDDP_REGISTER(cddp_ip_forward_##MODEL##_m##M##SUFFIX,                                \
                (cddp::ip_forward_kernel<scalar_t, cddp::STRUCT, M, TRACK, void>),     \
                cddp::kFwdThreads,                                                     \
                (cddp::fwd_stage_bytes<scalar_t, cddp::STRUCT::NX>()))

// A cost lane COST_STRUCT (lanes.cuh) on the model STRUCT's control box of m
// rows, goal form: launcher cddp_ip_forward_<MODEL>_<COST>_m<M>, which takes
// the instances' cost parameters cp (B, n_cp) as its last input, n_cp and
// the lane's weights. Registered with the stage's shared memory; each
// launch notes the size it takes with the parameters (known only then).
#define CDDP_IP_FORWARD_LANE(MODEL, STRUCT, COST, COST_STRUCT, M)                       \
  extern "C" int CDDP_EXPORT(cddp_ip_forward_##MODEL##_##COST##_m##M)(                 \
      const void* const* in, const long long* strides, scalar_t* const* out, int ncp,  \
      const double* weights, const double* consts, const double* rows, int N, int B,   \
      int integrator, int slack_soc, void* stream) {                                   \
    return cddp::launch_ip_forward<scalar_t, cddp::STRUCT, M, false, cddp::COST_STRUCT>( \
        in, strides, out, nullptr, consts, rows, N, B, integrator, slack_soc,          \
        static_cast<cudaStream_t>(stream), ncp, weights);                              \
  }                                                                                    \
  CDDP_REGISTER(cddp_ip_forward_##MODEL##_##COST##_m##M,                               \
                (cddp::ip_forward_kernel<scalar_t, cddp::STRUCT, M, false,             \
                                         cddp::COST_STRUCT>),                          \
                cddp::kFwdThreads, (cddp::fwd_stage_bytes<scalar_t, cddp::STRUCT::NX>()))
