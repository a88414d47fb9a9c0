// Next-step staging of a trajectory sweep's nominal values in shared memory.
//
// A thread of a whole-solve kernel (ipddp_solve.cu, clddp_solve.cu,
// logddp_solve.cu) walks its own instance's batch-last trajectories one step
// at a time, and each step's loads are dependent ones that go to device
// memory just before they are used. Per-thread cp.async (LDGSTS) copies the
// values of step t+1 into the thread's slot of a two-stage shared-memory
// buffer while it computes step t, and the thread waits on the older group
// before it reads. The copies take no registers while in flight, and they
// keep the per-instance control flow: threads of one block may be in
// different sweeps (a backward retry, a trial, a commit) at the same moment,
// which a block-wide TMA tile copy could not serve.
//
// Layout [stage][value][thread]: a warp reads 32 consecutive words, free of
// bank conflicts, and its copies come from 32 consecutive batch-last
// addresses, so the global reads stay coalesced.
#pragma once

#include "small_linalg.cuh"

namespace cddp {

// Dynamic shared memory of a block of `threads` threads that stages `values`
// values a thread.
template <typename T>
constexpr int stage_bytes(int values, int threads) {
  return 2 * values * threads * int(sizeof(T));
}

template <typename T, int V>
struct SweepStage {
  T* base;  // this thread's value 0 of stage 0
  int stride;  // threads per block

  // base points into the kernel's dynamic shared memory.
  __device__ static SweepStage make(unsigned char* smem) {
    return SweepStage{reinterpret_cast<T*>(smem) + threadIdx.x, int(blockDim.x)};
  }

  __device__ T* slot(int stage, int v) const { return base + (stage * V + v) * stride; }

  // Start copying *src into value v of the stage.
  __device__ void copy(int stage, int v, const T* src) const {
#if defined(__CUDA_ARCH__)
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot(stage, v)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src),
                 "n"(int(sizeof(T)))
                 : "memory");
#endif
  }

  // Values [v0, v0 + D) of the stage from the D values of step t of a
  // batch-last array p[t][i][b]; returns v0 + D.
  template <int D>
  __device__ int fetch(int stage, int v0, const T* p, int t, size_t Bs, int b) const {
#pragma unroll
    for (int i = 0; i < D; ++i) copy(stage, v0 + i, p + (size_t(t) * D + i) * Bs + b);
    return v0 + D;
  }

  // Close the group of copies issued since the last commit.
  __device__ static void commit() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
  }

  // Wait until every group but the newest has landed: the current stage
  // is readable while the next one is still in flight.
  __device__ static void wait_prior() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
  }

  __device__ T get(int stage, int v) const { return *slot(stage, v); }

  template <int D>
  __device__ void get(int stage, int v0, T (&out)[D]) const {
#pragma unroll
    for (int i = 0; i < D; ++i) out[i] = get(stage, v0 + i);
  }

  template <int D1, int D2>
  __device__ void get(int stage, int v0, T (&out)[D1][D2]) const {
#pragma unroll
    for (int i = 0; i < D1; ++i)
#pragma unroll
      for (int j = 0; j < D2; ++j) out[i][j] = get(stage, v0 + i * D2 + j);
  }
};

// The staging of a sweep over one instance's nominal trajectories X
// [t][nx][b], U [t][nu][b] and gains k, K, for the kernels whose sweeps read
// nothing else (clddp_solve.cu, logddp_solve.cu). A nominal sweep (a cost, a
// refresh, a backward attempt) stages X[t] and U[t]; a rollout stages the
// nominal X[t+1], U[t], k[t] and K[t]. A rollout that rewrites the nominal
// in place reads X[t+1] from the stage before it overwrites it, and the
// copies in flight for step t+1 (X[t+2], U[t+1], k[t+1], K[t+1]) never touch
// what step t writes.
template <typename T, int NX, int NU>
struct NominalStage {
  static constexpr int vX = 0, vU = NX, vk = vU + NU, vK = vk + NU, kValues = vK + NU * NX;
  using Stage = SweepStage<T, kValues>;
  Stage st;
  const T* X;
  const T* U;
  const T* k;
  const T* K;
  size_t Bs;
  int b;

  // Stage step t's values for a nominal sweep or a rollout, and close the group.
  __device__ void fetch(int t, int stage, bool rollout) const {
    st.template fetch<NX>(stage, vX, X, rollout ? t + 1 : t, Bs, b);
    st.template fetch<NU>(stage, vU, U, t, Bs, b);
    if (rollout) {
      st.template fetch<NU>(stage, vk, k, t, Bs, b);
      st.template fetch<NU * NX>(stage, vK, K, t, Bs, b);
    }
    Stage::commit();
  }

  // Before step t of a sweep whose next step is t_next (or none): stage
  // t_next, then wait for step t's values.
  __device__ void advance(int t_next, bool has_next, int stage, bool rollout) const {
    if (has_next)
      fetch(t_next, stage ^ 1, rollout);
    else
      Stage::commit();
    Stage::wait_prior();
  }
};

}  // namespace cddp
