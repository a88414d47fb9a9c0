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
//
// TileStage is the sibling for a kernel whose threads walk their steps in
// lockstep (ipddp_backward.cu) and whose operands come with any batch,
// step and value strides: each thread copies its own instance's values of
// the next step into the same [value][thread] tiles, whatever the layout
// (a batch-last view copies coalesced; for a batch-first one each thread
// reads its own run, the rest of a sector arriving through L1). An operand
// broadcast over the batch is staged by the block once a step, or once a
// launch when it is also constant over the steps, and every thread reads
// that one copy.
//
// CoopStage is the sibling for a kernel whose operands arrive batch-first
// (riccati_backward.cuh at its small shapes): a thread copying its own
// instance's run of a batch-first operand touches a different line of
// device memory from every other thread of its warp, and one step's run is
// a few words. The block copies several steps of each per-instance operand
// together instead: for an operand whose values are contiguous (value
// stride 1) neighbouring threads take neighbouring values of one instance's
// run of S steps, for any other (a batch-last view) neighbouring instances,
// so the reads are coalesced either way. The stage holds each instance's
// values as a row of odd pitch, [instance][value], so that a warp's 32
// threads reading their own rows, and the copies writing them, fall in
// different banks.
#pragma once

#include "small_linalg.cuh"

namespace cddp {

// Dynamic shared memory of a block of `threads` threads that stages `values`
// values a thread.
template <typename T>
constexpr int stage_bytes(int values, int threads) {
  return 2 * values * threads * int(sizeof(T));
}

// Start copying the word *src of device memory into *dst of shared memory
// (cp.async, LDGSTS); it lands by the cp.async group it is committed with.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(int(sizeof(T)))
               : "memory");
#endif
}

// Close the group of copies issued since the last commit.
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until every group has landed.
__device__ __forceinline__ void cp_async_wait_all() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#endif
}

// Wait until every group but the newest has landed: the current stage is
// readable while the next one is still in flight.
__device__ __forceinline__ void cp_async_wait_prior() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#endif
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
  __device__ void copy(int stage, int v, const T* src) const { cp_async(slot(stage, v), src); }

  // Values [v0, v0 + D) of the stage from the D values of step t of a
  // batch-last array p[t][i][b]; returns v0 + D.
  template <int D>
  __device__ int fetch(int stage, int v0, const T* p, int t, size_t Bs, int b) const {
#pragma unroll
    for (int i = 0; i < D; ++i) copy(stage, v0 + i, p + (size_t(t) * D + i) * Bs + b);
    return v0 + D;
  }

  __device__ static void commit() { cp_async_commit(); }
  __device__ static void wait_prior() { cp_async_wait_prior(); }

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

// Where an operand of a TileStage lives.
enum TileKind : int {
  kPerInstance = 0,  // batch stride != 0: a [value][thread] tile in each stage
  kPerStep = 1,      // batch stride 0, step stride != 0: one row a step in each stage
  kConstant = 2,     // both strides 0: one copy for the launch
};

struct TileOperand {
  long long bs, ts, vs;  // batch, step and value strides, in elements
  int kind, off;         // TileKind; its first value in a step's tile, row or the constants
};

// Lay out NOPS operands of D[o] values a step from their strides: fills
// each operand's kind and offset, the values a step of the per-instance
// tiles (V) and of the broadcast rows (W), and the constant values (C).
// strides holds each operand's (batch, step, value) strides.
template <int NOPS>
inline void tile_layout(const int (&D)[NOPS], const long long* strides,
                        TileOperand (&op)[NOPS], int& V, int& W, int& C) {
  V = W = C = 0;
  for (int o = 0; o < NOPS; ++o) {
    const long long bs = strides[3 * o], ts = strides[3 * o + 1], vs = strides[3 * o + 2];
    const int kind = bs != 0 ? kPerInstance : ts != 0 ? kPerStep : kConstant;
    int& next = kind == kPerInstance ? V : kind == kPerStep ? W : C;
    op[o] = TileOperand{bs, ts, vs, kind, next};
    next += D[o];
  }
}

// Bytes of a TileStage of `threads` threads: two stages of V per-instance
// values a thread and W broadcast values, then C constants.
template <typename T>
__host__ __device__ constexpr int tile_stage_bytes(int threads, int V, int W, int C) {
  return (2 * (V * threads + W) + C) * int(sizeof(T));
}

// Two stages of one step each, then the constants, at base: in stage s,
// value v of thread x of a per-instance operand at s * stage_elems + v * TH
// + x; value v of a per-step broadcast at s * stage_elems + V * TH + v; a
// constant at 2 * stage_elems + v.
template <typename T, int TH>
struct TileStage {
  T* base;
  int V, W;

  __host__ __device__ static constexpr int bytes(int V, int W, int C) {
    return tile_stage_bytes<T>(TH, V, W, C);
  }
  __device__ int stage_elems() const { return V * TH + W; }
  __device__ T* consts() const { return base + 2 * stage_elems(); }

  // Start copying step t of operand o (D values a step) into the stage: a
  // per-instance operand by each thread for its own instance b (if b < B),
  // a per-step broadcast by the block.
  template <int D>
  __device__ void fetch(const T* src, const TileOperand& o, int stage, int t, int b,
                        int B) const {
    T* st = base + stage * stage_elems();
    if (o.kind == kPerInstance) {
      if (b >= B) return;
      const T* from = src + (long long)b * o.bs + (long long)t * o.ts;
#pragma unroll
      for (int i = 0; i < D; ++i)
        cp_async(st + (o.off + i) * TH + threadIdx.x, from + i * o.vs);
    } else if (o.kind == kPerStep) {
      for (int i = threadIdx.x; i < D; i += TH)
        cp_async(st + V * TH + o.off + i, src + (long long)t * o.ts + i * o.vs);
    }
  }

  // Start copying a constant operand (once a launch).
  template <int D>
  __device__ void fetch_constant(const T* src, const TileOperand& o) const {
    if (o.kind == kConstant)
      for (int i = threadIdx.x; i < D; i += TH) cp_async(consts() + o.off + i, src + i * o.vs);
  }

  // This thread's D values of operand o in the stage.
  template <int D>
  __device__ void load(const TileOperand& o, int stage, T (&v)[D]) const {
    const T* st = base + stage * stage_elems();
    if (o.kind == kPerInstance) {
      const T* p = st + o.off * TH + threadIdx.x;
#pragma unroll
      for (int i = 0; i < D; ++i) v[i] = p[i * TH];
    } else {
      const T* p = o.kind == kPerStep ? st + V * TH + o.off : consts() + o.off;
#pragma unroll
      for (int i = 0; i < D; ++i) v[i] = p[i];
    }
  }
  template <int D1, int D2>
  __device__ void load(const TileOperand& o, int stage, T (&v)[D1][D2]) const {
    load<D1 * D2>(o, stage, reinterpret_cast<T(&)[D1 * D2]>(v));
  }
};

// An odd row pitch of at least V values.
__host__ __device__ constexpr int coop_pitch(int V) { return V | 1; }

// Bytes of a CoopStage of `threads` threads and S steps: a row of S V
// per-instance values a thread and S W broadcast values, then C constants.
template <typename T>
__host__ __device__ constexpr int coop_stage_bytes(int threads, int V, int W, int C, int S) {
  return (coop_pitch(S * V) * threads + S * W + C) * int(sizeof(T));
}

// One stage of S steps, then the constants, at base: value v of step s (of
// the stage's S) of instance x (of the block's TH) of a per-instance
// operand at x * pitch + S * off + s * D + v; of a per-step broadcast at TH
// * pitch + S * off + s * D + v; a constant at TH * pitch + S * W + off +
// v. An instance's S steps of an operand stored step after step (a
// batch-first tensor's, or a slice's whose step stride is D) are one run in
// device memory, copied as one. The block fills the stage, waits, and reads.
template <typename T, int TH, int S>
struct CoopStage {
  T* base;
  int pitch, W;

  __device__ T* consts() const { return base + TH * pitch + S * W; }

  // Start copying steps t0 .. t0 + S - 1 (those in [0, N)) of operand o (D
  // values a step) of the block's instances b0 .. b0 + TH - 1 (those below
  // B) into the stage, every thread of the block taking its share.
  template <int D>
  __device__ void fetch(const T* src, const TileOperand& o, int t0, int N, int b0, int B) const {
    const int s_lo = max(0, -t0), s_hi = min(S, N - t0);
    if (o.kind == kPerInstance) {
      const int n = min(TH, B - b0);
      if (o.vs == 1) {
        for (int idx = threadIdx.x; idx < n * S * D; idx += TH) {
          const int x = idx / (S * D), r = idx - x * (S * D), s = r / D, v = r - s * D;
          if (s >= s_lo && s < s_hi)
            cp_async(base + x * pitch + S * o.off + r,
                     src + (long long)(b0 + x) * o.bs + (long long)(t0 + s) * o.ts + v);
        }
      } else if (int(threadIdx.x) < n) {
        const int x = threadIdx.x;
        for (int s = s_lo; s < s_hi; ++s) {
#pragma unroll
          for (int v = 0; v < D; ++v)
            cp_async(base + x * pitch + S * o.off + s * D + v,
                     src + (long long)(b0 + x) * o.bs + (long long)(t0 + s) * o.ts + v * o.vs);
        }
      }
    } else if (o.kind == kPerStep) {
      for (int i = threadIdx.x; i < S * D; i += TH) {
        const int s = i / D, v = i - s * D;
        if (s >= s_lo && s < s_hi)
          cp_async(base + TH * pitch + S * o.off + i, src + (long long)(t0 + s) * o.ts + v * o.vs);
      }
    }
  }

  // Start copying a constant operand (once a launch).
  template <int D>
  __device__ void fetch_constant(const T* src, const TileOperand& o) const {
    if (o.kind == kConstant)
      for (int i = threadIdx.x; i < D; i += TH) cp_async(consts() + o.off + i, src + i * o.vs);
  }

  // This thread's D values of operand o at step s of the stage.
  template <int D>
  __device__ const T* at(const TileOperand& o, int s) const {
    return o.kind == kPerInstance ? base + threadIdx.x * pitch + S * o.off + s * D
           : o.kind == kPerStep   ? base + TH * pitch + S * o.off + s * D
                                  : consts() + o.off;
  }
  template <int D>
  __device__ void load(const TileOperand& o, int s, T (&v)[D]) const {
    const T* p = at<D>(o, s);
#pragma unroll
    for (int i = 0; i < D; ++i) v[i] = p[i];
  }
  template <int D1, int D2>
  __device__ void load(const TileOperand& o, int s, T (&v)[D1][D2]) const {
    load<D1 * D2>(o, s, reinterpret_cast<T(&)[D1 * D2]>(v));
  }
};

}  // namespace cddp
