// Streamed CLDDP backward pass, a team of lanes per problem instance: the
// form of riccati_backward.cuh for the shapes whose step one thread spills
// (riccati.TEAM_SHAPES: 13x4, 10x4 and 10x3), instantiated by
// riccati_backward_team.cu.
//
// Replaces cddp_tpu/ops/pallas/riccati.py::make_backward_kernel (:236) at
// those shapes. One thread carrying the step's Vxx, A, lxx, VA, Qxx and the
// value update (several nx * nx arrays) and the BoxQP's 27 or 81 active
// sets ran out of registers: at 13x4 ptxas put 12,944 bytes a thread in
// local memory, some 850 MB at B = 65,536, so every step's arithmetic went
// through device memory.
//
// Bound: operations (the BoxQP's active sets), then shared memory. The
// design:
//
// 1. A team of TEAM lanes of one warp takes an instance (16 at nx 10-13;
//    kTeamThreads / TEAM instances a block). Lane r owns row r of
//    Vxx (in its registers across the horizon), of Qxx and of the value
//    update, column r of Qux and K. Products that need every row (VA, VB,
//    Qux, K, Quu K) go through the instance's scratch in shared memory,
//    with __syncwarp between the phases of a step. Each entry is summed in
//    the one-thread form's order (clddp_step.cuh), so the float64 build
//    gives its bits.
// 2. The 3^NU BoxQP active sets are dealt to the lanes in product order
//    (lane r takes r, r + TEAM, ...); each solves its own with the serial
//    walk's arithmetic (clddp_step.cuh::boxqp_config) and keeps its first
//    valid one. The taken set is the smallest valid index across the team
//    (__reduce_min_sync), the serial walk's first-valid rule, and its lane
//    hands k and the free block's inverse to the team through shared
//    memory. The per-lane loop stays rolled.
// 3. The step operands are read where they lie (the wrapper copies
//    nothing) and staged one step ahead in shared memory: a per-instance
//    operand by its team's lanes (neighbouring lanes on neighbouring values,
//    so a batch-first operand is read coalesced), a per-step broadcast by
//    the block, a constant (the quadratic cost's Hessians) once a launch;
//    cp.async, one group a step, as sweep_stage.cuh::TileStage.
// 4. The outputs stay batch-last (k (N, nu, B), K (N, nu, nx, B)), as the
//    one-thread form writes them.
#pragma once

#include "riccati_backward.cuh"

namespace cddp {

// Block size of the team form, every shape and type.
constexpr int kTeamThreads = 128;

// Resident blocks an SM is to hold, which caps ptxas's registers at 65,536
// / (128 x blocks): unasked it took 254 at 13x4 and 221 at 10x4. Three (170
// registers) took 13x4 from 19.9 to 17.2 ms and 10x4 from 14.1 to 11.3,
// four (128) 10x3 to 12.0, where three took 13.5 (an NVIDIA H100, PERF.md
// §6).
template <int NX, int NU>
constexpr int team_min_blocks() {
  return NX == 10 && NU == 3 ? 4 : 3;
}

// An instance's scratch in shared memory, offsets in values.
template <int NX, int NU>
struct TeamScratch {
  static constexpr int Vx = 0, VA = Vx + NX, VB = VA + NX * NX, Qux = VB + NX * NU,
                       K = Qux + NU * NX, QuuK = K + NU * NX, Quu = QuuK + NU * NX,
                       Qu = Quu + NU * NU, k = Qu + NU, Hinv = k + NU,
                       kValues = Hinv + NU * NU;
};

// Values of a block's shared memory: C constants, two stages of W per-step
// broadcast values, and for each instance two stages of V per-instance
// values and its scratch.
template <int NX, int NU, int TEAM>
__host__ __device__ constexpr int team_smem_values(int V, int W, int C) {
  return C + 2 * W + (kTeamThreads / TEAM) * (2 * V + TeamScratch<NX, NU>::kValues);
}

template <typename T, int NX, int NU, int TEAM>
constexpr int riccati_team_main_smem() {
  using Sh = RiccatiShape<NX, NU>;
  return team_smem_values<NX, NU, TEAM>(Sh::kMainValues, 0, Sh::kMainConsts) * int(sizeof(T));
}

// Where a team's operands lie in shared memory: the block's constants and
// per-step rows, and the instance's own stages.
template <typename T, int TEAM>
struct TeamStage {
  T* consts;
  T* rows;
  T* mine;
  int V, W;

  // Start copying step t of operand o (D values a step) into the stage: a
  // per-instance operand by lane r of its team (values r, r + TEAM, ...;
  // none for an instance past the batch), a per-step broadcast by the
  // block.
  template <int D>
  __device__ void fetch(const T* src, const TileOperand& o, int stage, int t, int b, bool live,
                        int r) const {
    if (o.kind == kPerInstance) {
      if (!live) return;
      const T* from = src + (long long)b * o.bs + (long long)t * o.ts;
      T* to = mine + stage * V + o.off;
      for (int i = r; i < D; i += TEAM) cp_async(to + i, from + i * o.vs);
    } else if (o.kind == kPerStep) {
      T* to = rows + stage * W + o.off;
      for (int i = threadIdx.x; i < D; i += kTeamThreads)
        cp_async(to + i, src + (long long)t * o.ts + i * o.vs);
    }
  }

  // Start copying a constant operand (once a launch, by the block).
  template <int D>
  __device__ void fetch_constant(const T* src, const TileOperand& o) const {
    if (o.kind == kConstant)
      for (int i = threadIdx.x; i < D; i += kTeamThreads)
        cp_async(consts + o.off + i, src + i * o.vs);
  }

  // Operand o's values of the stage, row-major.
  __device__ const T* at(const TileOperand& o, int stage) const {
    return o.kind == kPerInstance ? mine + stage * V + o.off
           : o.kind == kPerStep   ? rows + stage * W + o.off
                                  : consts + o.off;
  }
};

// Start copying step t into the stage; the caller commits.
template <typename T, int NX, int NU, int TEAM>
__device__ void team_stage_step(const TeamStage<T, TEAM>& st, const RiccatiArgs<T>& a, int t,
                                int stage, int b, bool live, int r) {
  using Sh = RiccatiShape<NX, NU>;
  st.template fetch<Sh::D[0]>(a.in[0], a.op[0], stage, t, b, live, r);
  st.template fetch<Sh::D[1]>(a.in[1], a.op[1], stage, t, b, live, r);
  st.template fetch<Sh::D[2]>(a.in[2], a.op[2], stage, t, b, live, r);
  st.template fetch<Sh::D[3]>(a.in[3], a.op[3], stage, t, b, live, r);
  st.template fetch<Sh::D[4]>(a.in[4], a.op[4], stage, t, b, live, r);
  st.template fetch<Sh::D[5]>(a.in[5], a.op[5], stage, t, b, live, r);
  st.template fetch<Sh::D[6]>(a.in[6], a.op[6], stage, t, b, live, r);
  st.template fetch<Sh::D[7]>(a.in[7], a.op[7], stage, t, b, live, r);
  st.template fetch<Sh::D[8]>(a.in[8], a.op[8], stage, t, b, live, r);
}

template <typename T, int NX, int NU, int TEAM>
__global__ void __launch_bounds__(kTeamThreads, (team_min_blocks<NX, NU>())) riccati_team_kernel(
    const __grid_constant__ RiccatiArgs<T> a) {
  static_assert(NX <= TEAM && 32 % TEAM == 0, "a lane owns at most one row; teams tile a warp");
  using Sh = RiccatiShape<NX, NU>;
  using Sc = TeamScratch<NX, NU>;
  constexpr int INST = kTeamThreads / TEAM;
  constexpr unsigned kNone = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char cddp_smem[];
  T* const base = reinterpret_cast<T*>(cddp_smem);
  const int r = threadIdx.x % TEAM, inst = threadIdx.x / TEAM;
  const int b = blockIdx.x * INST + inst, N = a.N;
  const bool live = b < a.B;
  const TeamStage<T, TEAM> st{base, base + a.C,
                              base + a.C + 2 * a.W + inst * (2 * a.V + Sc::kValues), a.V, a.W};
  T* const sc = st.mine + 2 * a.V;
  const unsigned lane = threadIdx.x % 32;
  const unsigned team_mask =
      TEAM == 32 ? 0xffffffffu : ((1u << TEAM) - 1u) << (lane / TEAM * TEAM);

  // The block stages the constants and every team its last step; lane r
  // reads row r of the terminal Vxx into its registers and Vx[r].
  st.template fetch_constant<Sh::D[0]>(a.in[0], a.op[0]);
  st.template fetch_constant<Sh::D[1]>(a.in[1], a.op[1]);
  st.template fetch_constant<Sh::D[2]>(a.in[2], a.op[2]);
  st.template fetch_constant<Sh::D[3]>(a.in[3], a.op[3]);
  st.template fetch_constant<Sh::D[4]>(a.in[4], a.op[4]);
  st.template fetch_constant<Sh::D[5]>(a.in[5], a.op[5]);
  st.template fetch_constant<Sh::D[6]>(a.in[6], a.op[6]);
  st.template fetch_constant<Sh::D[7]>(a.in[7], a.op[7]);
  st.template fetch_constant<Sh::D[8]>(a.in[8], a.op[8]);
  team_stage_step<T, NX, NU, TEAM>(st, a, N - 1, 0, b, live, r);
  cp_async_commit();

  T vrow[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) vrow[j] = T(0);
  if (live && r < NX) {
#pragma unroll
    for (int j = 0; j < NX; ++j)
      vrow[j] = a.in[10][b * a.bs_tail[1] + (r * NX + j) * a.vs_tail[1]];
    sc[Sc::Vx + r] = a.in[9][b * a.bs_tail[0] + r * a.vs_tail[0]];
  }
  const T reg = live ? a.in[11][b * a.bs_tail[2]] : T(0);
  // Lane 0's running sums.
  T dv0 = T(0), dv1 = T(0), qerr = T(0), nvx = T(0), ok = T(1);
  const size_t Bs = a.B;

  for (int t = N - 1; t >= 0; --t) {
    const int s = (N - 1 - t) & 1;
    if (t > 0) team_stage_step<T, NX, NU, TEAM>(st, a, t - 1, s ^ 1, b, live, r);
    cp_async_commit();
    cp_async_wait_prior();
    __syncthreads();

    const T* A = st.at(a.op[0], s);
    const T* Bm = st.at(a.op[1], s);
    const T* lx = st.at(a.op[2], s);
    const T* lu = st.at(a.op[3], s);
    const T* lxx = st.at(a.op[4], s);
    const T* luu = st.at(a.op[5], s);
    const T* lux = st.at(a.op[6], s);
    const T* lb = st.at(a.op[7], s);
    const T* ub = st.at(a.op[8], s);

    // 1. Rows r of VA = Vxx A and VB = Vxx B; Qx[r]; Qu.
    T qx = T(0);
    if (r < NX) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T v = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) v = v + vrow[l] * A[l * NX + j];
        sc[Sc::VA + r * NX + j] = v;
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T v = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) v = v + vrow[l] * Bm[l * NU + c];
        sc[Sc::VB + r * NU + c] = v;
      }
      T v = T(0);
#pragma unroll
      for (int l = 0; l < NX; ++l) v = v + A[l * NX + r] * sc[Sc::Vx + l];
      qx = lx[r] + v;
    }
    if (r < NU) {
      T v = T(0);
#pragma unroll
      for (int l = 0; l < NX; ++l) v = v + Bm[l * NU + r] * sc[Sc::Vx + l];
      sc[Sc::Qu + r] = lu[r] + v;
    }
    __syncwarp();

    // 2. Row r of Qxx = lxx + A' VA, column r of Qux = lux + B' VA; Quu =
    // luu + B' VB dealt to the lanes by entry.
    T qxx[NX], quxc[NU];
#pragma unroll
    for (int j = 0; j < NX; ++j) qxx[j] = T(0);
#pragma unroll
    for (int c = 0; c < NU; ++c) quxc[c] = T(0);
    if (r < NX) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T v = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) v = v + A[l * NX + r] * sc[Sc::VA + l * NX + j];
        qxx[j] = lxx[r * NX + j] + v;
      }
#pragma unroll
      for (int c = 0; c < NU; ++c) {
        T v = T(0);
#pragma unroll
        for (int l = 0; l < NX; ++l) v = v + Bm[l * NU + c] * sc[Sc::VA + l * NX + r];
        quxc[c] = lux[c * NX + r] + v;
        sc[Sc::Qux + c * NX + r] = quxc[c];
      }
    }
    for (int e = r; e < NU * NU; e += TEAM) {
      const int c1 = e / NU, c2 = e % NU;
      T v = T(0);
#pragma unroll
      for (int l = 0; l < NX; ++l) v = v + Bm[l * NU + c1] * sc[Sc::VB + l * NU + c2];
      sc[Sc::Quu + e] = luu[e] + v;
    }
    __syncwarp();

    // 3. The enumerated BoxQP on Quu + reg I: lane r solves the active
    // sets r, r + TEAM, ... and keeps its first valid one; the team takes
    // the smallest valid index.
    T Quu[NU][NU], H[NU][NU], g[NU], lo[NU], hi[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        Quu[i][j] = sc[Sc::Quu + i * NU + j];
        H[i][j] = Quu[i][j] + (i == j ? reg : T(0));
      }
      g[i] = sc[Sc::Qu + i];
      lo[i] = lb[i];
      hi[i] = ub[i];
    }
    const bool pd_all = leading_minors_pd<T, NU>(H);
    unsigned first = kNone;
    T xk[NU], hk[NU][NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      xk[i] = T(0);
#pragma unroll
      for (int j = 0; j < NU; ++j) hk[i][j] = T(0);
    }
#pragma unroll 1
    for (int c = r; c < pow3(NU); c += TEAM) {
      T x[NU], Hi[NU][NU];
      const bool valid = boxqp_config<T, NU>(c, H, g, lo, hi, x, Hi);
      const bool take = valid & (first == kNone);
      first = take ? unsigned(c) : first;
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        xk[i] = take ? x[i] : xk[i];
#pragma unroll
        for (int j = 0; j < NU; ++j) hk[i][j] = take ? Hi[i][j] : hk[i][j];
      }
    }
    const unsigned win = __reduce_min_sync(team_mask, first);
    // The taken set's lane hands k and its inverse on; none taken: zeros.
    if ((win != kNone && first == win) || (win == kNone && r == 0)) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        sc[Sc::k + i] = xk[i];
#pragma unroll
        for (int j = 0; j < NU; ++j) sc[Sc::Hinv + i * NU + j] = hk[i][j];
      }
    }
    const bool fail = !pd_all | (win == kNone);
    __syncwarp();

    // 4. Column r of K = -Hinv Qux and of Quu K; the outputs.
    T kv[NU], Kc[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      kv[i] = sc[Sc::k + i];
      Kc[i] = T(0);
    }
    if (r < NX) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        T v = T(0);
#pragma unroll
        for (int l = 0; l < NU; ++l) v = v + sc[Sc::Hinv + i * NU + l] * quxc[l];
        Kc[i] = -v;
        sc[Sc::K + i * NX + r] = Kc[i];
      }
#pragma unroll
      for (int l = 0; l < NU; ++l) {
        T v = T(0);
#pragma unroll
        for (int m = 0; m < NU; ++m) v = v + Quu[l][m] * Kc[m];
        sc[Sc::QuuK + l * NX + r] = v;
      }
      if (live) {
#pragma unroll
        for (int i = 0; i < NU; ++i) a.out[1][((size_t(t) * NU + i) * NX + r) * Bs + b] = Kc[i];
      }
    }
    if (live && r < NU) a.out[0][(size_t(t) * NU + r) * Bs + b] = kv[r];
    __syncwarp();

    // 5. Vx[r] and row r of the new Vxx before its symmetrization
    // (clddp_solver.cpp:186-193), into VA's place.
    T Quu_k[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      T v = T(0);
#pragma unroll
      for (int l = 0; l < NU; ++l) v = v + Quu[i][l] * kv[l];
      Quu_k[i] = v;
    }
    if (r < NX) {
      T s1 = T(0), s2 = T(0), s3 = T(0);
#pragma unroll
      for (int l = 0; l < NU; ++l) s1 = s1 + Kc[l] * Quu_k[l];
#pragma unroll
      for (int l = 0; l < NU; ++l) s2 = s2 + quxc[l] * kv[l];
#pragma unroll
      for (int l = 0; l < NU; ++l) s3 = s3 + Kc[l] * g[l];
      sc[Sc::Vx + r] = qx + s1 + s2 + s3;
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        T kqk = T(0), qk = T(0), kq = T(0);
#pragma unroll
        for (int l = 0; l < NU; ++l) kqk = kqk + Kc[l] * sc[Sc::QuuK + l * NX + j];
#pragma unroll
        for (int l = 0; l < NU; ++l) qk = qk + quxc[l] * sc[Sc::K + l * NX + j];
#pragma unroll
        for (int l = 0; l < NU; ++l) kq = kq + sc[Sc::Qux + l * NX + j] * Kc[l];
        sc[Sc::VA + r * NX + j] = qxx[j] + kqk + qk + kq;
      }
    }
    __syncwarp();

    // 6. Row r of Vxx = (Vn + Vn') / 2; lane 0's sums.
    if (r < NX) {
#pragma unroll
      for (int j = 0; j < NX; ++j)
        vrow[j] = T(0.5) * (sc[Sc::VA + r * NX + j] + sc[Sc::VA + j * NX + r]);
    }
    if (r == 0) {
      T d0 = T(0), d1 = T(0);
#pragma unroll
      for (int i = 0; i < NU; ++i) d0 = d0 + g[i] * kv[i];
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j) d1 = d1 + kv[i] * Quu[i][j] * kv[j];
      dv0 = dv0 + d0;
      dv1 = dv1 + T(0.5) * d1;
      T qa = dabs(g[0]);
#pragma unroll
      for (int i = 1; i < NU; ++i) qa = nan_max(qa, dabs(g[i]));
      qerr = nan_max(qerr, qa);
      T sum = T(0);
#pragma unroll
      for (int i = 0; i < NX; ++i) sum = sum + dabs(sc[Sc::Vx + i]);
      nvx = nvx + sum;
      ok = ok * (fail ? T(0) : T(1));
    }
    // The next step's copies fill the stage this one read, and its phases
    // rewrite the scratch, only after every lane has finished with them.
    __syncthreads();
  }
  if (live && r == 0) {
    a.out[2][b] = dv0;
    a.out[2][Bs + b] = dv1;
    a.out[3][b] = qerr;
    a.out[3][Bs + b] = nvx;
    a.out[3][2 * Bs + b] = ok;
  }
}

template <typename T, int NX, int NU, int TEAM>
int launch_riccati_team(const T* const* in, const long long* strides, T* const* out, int N,
                        int B, cudaStream_t stream) {
  static_assert(riccati_team_main_smem<T, NX, NU, TEAM>() <= 232448,
                "the per-pass driver's layout must fit a block's shared memory");
  const RiccatiArgs<T> a = riccati_args<T, NX, NU>(in, strides, out, N, B);
  constexpr int INST = kTeamThreads / TEAM;
  const int blocks = (B + INST - 1) / INST;
  const int smem = team_smem_values<NX, NU, TEAM>(a.V, a.W, a.C) * int(sizeof(T));
  const cudaError_t err = cudaFuncSetAttribute(
      (const void*)riccati_team_kernel<T, NX, NU, TEAM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  riccati_team_kernel<T, NX, NU, TEAM><<<blocks, kTeamThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cddp

// The launcher of shape (NX, NU) in the team form (TEAM lanes an instance),
// registered with the per-pass driver's layout; the same C interface as the
// one-thread form's.
#define CDDP_RICCATI_BACKWARD_TEAM(NX, NU, TEAM)                                       \
  extern "C" int CDDP_EXPORT(cddp_riccati_backward_##NX##x##NU)(                       \
      const scalar_t* const* in, const long long* strides, scalar_t* const* out, int N, \
      int B, void* stream) {                                                           \
    return cddp::launch_riccati_team<scalar_t, NX, NU, TEAM>(                          \
        in, strides, out, N, B, static_cast<cudaStream_t>(stream));                    \
  }                                                                                    \
  CDDP_REGISTER(cddp_riccati_backward_##NX##x##NU,                                     \
                (cddp::riccati_team_kernel<scalar_t, NX, NU, TEAM>), cddp::kTeamThreads, \
                (cddp::riccati_team_main_smem<scalar_t, NX, NU, TEAM>()))
