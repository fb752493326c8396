// Mamba-1 selective scan for Hopper (sm_90a):
//   h_t = exp(dt_t * A) . h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t . C_t
// with the (D, N) state in f32 registers for the whole sequence, and, when
// asked, the state after the last step (h_last, which a model's prefill
// hands to its decode cache), written once after the time loop, and the
// state at the start of every chunk-step tile (h_chunks, which the backward
// recomputes each tile's states from).  Whether each is written is a
// template parameter, so the kernel that writes only y does no more work
// than it did before they existed.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py
// (_scan_kernel, launched by mamba_scan_fwd).  As there, the decay
// exp(dt A) and the drive dt x B are formed in registers and never reach
// HBM.
//
// What bounds it on the H100, in order:
// * the bytes: per (t, d) the kernel reads dt and x and writes y, and B and
//   C are shared by all channels, so a call moves about 3 L D elements;
// * the exponentials: one per (t, d, n), and the SM's special-function
//   units give 16 a clock.  At Falcon-Mamba-7B's width (L 4096, D 8192,
//   N 16) that is 5.4e8 exponentials, more time than the bytes take;
// * then the issue slots: the rest of an element's work is four f32
//   operations, and the warps of a scheduler must hide the latency of each
//   step's loads and dependent chain.
//
// Design, against each:
// * A thread owns one channel and S = N / P consecutive states, with
//   P = min(N, 4) lanes a channel, adjacent in the warp.  h[S] and
//   A log2(e) stay in registers for the whole sequence.  A step's y is
//   summed over the thread's S states in registers; over the P lanes, the
//   y of kUnroll steps are summed at once by a reduce-scatter (each lane
//   keeps half its values at every stage and ends with kUnroll / P of
//   them), so the shuffles and the stores of y cost well under one
//   instruction an element.
// * exp(dt A) is ex2.approx of dt (A log2 e): one multiply and one MUFU.EX2
//   an element.  Its error, a few ulp, is far inside the tolerances.
// * The time loop is unrolled over kUnroll steps, whose y stay in
//   registers until the last is summed: no shared-memory store sits
//   between the steps' loads, so the exponentials and drives of all of
//   them are in flight and only the FMA on h is serial.
// * A block owns kChannels = 32 channels, so a row of dt, x or y is 64
//   (bf16) or 128 (f32) bytes: whole sectors.  Each tile of `chunk`
//   timesteps of dt, x, B and C is copied to shared memory with 16-byte
//   cp.async into one of two stages, so tile k + 1 is in flight while tile
//   k is scanned; B and C are staged once for all 32 channels.  When a tile
//   has arrived the block converts it once to f32 ((dt, dt x) pairs, B, C);
//   y goes through a shared tile and leaves with 16-byte stores.  Rows that
//   rule out 16-byte copies (D * sizeof(T) not a multiple of 16, unaligned
//   pointers) take a plain load-and-store path into the same buffers.
//
// Every step is the same arithmetic, written with explicit rounding
// intrinsics (no contraction is left to the compiler), in the unrolled loop
// and in the remainder loop alike, so the output is bit-identical whatever
// `chunk`: it only sets the timesteps a stage holds.  Hopper runs blocks in
// no order, so no state carries from one block to another: each block walks
// the whole sequence for its channels.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChannels = 32;  // G: channels a block
constexpr int kUnroll = 16;    // timesteps a step of the unrolled loop
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round16(int bytes) {
  return (bytes + 15) & ~15;
}

// Byte offsets of the dynamic shared memory (smem_bytes in
// repro_torch/kernels/mamba_scan/mamba_scan.py computes `total` alike):
// two stages of raw tiles (dt, x [chunk][G]; B, C [chunk][N], in T), the
// converted tile ((dt, dt x) [chunk][G] as float2; B, C [chunk][N] as f32)
// and two y tiles [chunk][G] in T.  One y tile would be enough (the store
// of tile k - 1 reads it before the barrier after which the scan of tile k
// writes it), but the kernel built that way took 0.296 ms against 0.282 ms
// at L 4096, D 8192, N 16, bf16, chunk 64 on an NVIDIA H100 80GB HBM3
// (700 W), and 14% longer with one block, with the same 80 registers.
// Every region starts 16-byte aligned.
struct Smem {
  int rows, bc, bcf, stage, dtf, bf, y, total;
  __host__ __device__ Smem(int chunk, int N, int esize)
      : rows(round16(chunk * kChannels * esize)),
        bc(round16(chunk * N * esize)),
        bcf(round16(chunk * N * 4)),
        stage(2 * rows + 2 * bc),
        dtf(2 * stage),
        bf(dtf + chunk * kChannels * 8),
        y(bf + 2 * bcf),
        total(y + 2 * rows) {}
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 16 bytes global -> shared, of which the first `src_bytes` are read and
// the rest filled with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile(
      "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
          static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
      "l"(src), "r"(src_bytes)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group of this thread's copies is in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// S consecutive f32 of shared memory, 4 * S-byte aligned
template <int S>
__device__ __forceinline__ void load_states(const float* p, float (&v)[S]) {
  if constexpr (S == 1) {
    v[0] = p[0];
  } else if constexpr (S == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    v[0] = a.x; v[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < S; i += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + i);
      v[i] = a.x; v[i + 1] = a.y; v[i + 2] = a.z; v[i + 3] = a.w;
    }
  }
}

// One timestep of one thread's S states: h advances, and the thread's part
// of y_t (its S products h C, summed in order) is returned.  dd is the
// channel's (dt, dt x).
template <int S>
__device__ __forceinline__ float scan_step(float (&h)[S],
                                           const float (&a2)[S], float2 dd,
                                           const float* Bt, const float* Ct) {
  float b[S], c[S];
  load_states<S>(Bt, b);
  load_states<S>(Ct, c);
  float yv = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float decay = ex2(__fmul_rn(dd.x, a2[s]));
    h[s] = __fmaf_rn(decay, h[s], __fmul_rn(dd.y, b[s]));
    yv = s == 0 ? __fmul_rn(h[s], c[s]) : __fmaf_rn(h[s], c[s], yv);
  }
  return yv;
}

// y_t of the channel from its P lanes' parts: an xor butterfly, lanes P / 2
// apart first.  Every lane gets the same bits (each pair is added on both
// sides), the same as reduce_scatter's.
template <int P>
__device__ __forceinline__ float reduce_all(float yv) {
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) {
    yv = __fadd_rn(yv, __shfl_xor_sync(0xffffffffu, yv, off));
  }
  return yv;
}

// The same sums for U steps at once, split over the P lanes: at each stage
// a lane keeps half of its values and sends the other half to the lane
// `Off` apart, so lane p ends with y of steps p U/P ... (p+1) U/P - 1 in
// v[0 .. U/P).  Each y is the same pairs added in the same order as in
// reduce_all, with U (P - 1) / P shuffles for U values where reduce_all
// needs U log2(P).
template <int P, int U, int Off = P / 2>
__device__ __forceinline__ void reduce_scatter(float (&v)[U], int p) {
  if constexpr (Off > 0) {
    constexpr int n = U * Off / P;  // values a lane keeps at this stage
    const bool upper = p & Off;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const float send = upper ? v[i] : v[i + n];
      const float keep = upper ? v[i + n] : v[i];
      v[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, Off));
    }
    reduce_scatter<P, U, Off / 2>(v, p);
  }
}

// The lanes a channel's N states are split over.  geometry() in
// repro_torch/kernels/mamba_scan/mamba_scan.py holds the same rule;
// mamba_scan_fwd refuses a launch made for another.
__host__ __device__ constexpr int lanes_for(int N) { return N < 4 ? N : 4; }

template <typename T, int N, bool kState, bool kChunks>
__global__ void __launch_bounds__(kChannels * lanes_for(N))
scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
            const float* __restrict__ A, const T* __restrict__ B,
            const T* __restrict__ C, T* __restrict__ y,
            float* __restrict__ h_last, float* __restrict__ h_chunks, int L,
            int D, int chunk, bool vec_rows, bool vec_bc) {
  constexpr int P = lanes_for(N);
  constexpr int S = N / P;
  constexpr int kThreads = kChannels * P;
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a piece
  constexpr int kPieces = kChannels / E;               // pieces a row
  const int tid = threadIdx.x;
  const int c = tid / P;  // the thread's channel in the block
  const int p = tid % P;
  const int d0 = blockIdx.x * kChannels;
  const long bL = static_cast<long>(blockIdx.y) * L;
  const Smem lay(chunk, N, sizeof(T));

  extern __shared__ __align__(16) unsigned char smem[];
  float2* dtf = reinterpret_cast<float2*>(smem + lay.dtf);
  float* Bf = reinterpret_cast<float*>(smem + lay.bf);
  float* Cf = reinterpret_cast<float*>(smem + lay.bf + lay.bcf);

  // the raw tiles of stage s: dt, x, then B, C
  auto raw_rows = [&](int s, int which) {
    return reinterpret_cast<T*>(smem + s * lay.stage + which * lay.rows);
  };
  auto raw_bc = [&](int s, int which) {
    return reinterpret_cast<T*>(smem + s * lay.stage + 2 * lay.rows +
                                which * lay.bc);
  };
  auto y_tile = [&](int k) {
    return reinterpret_cast<T*>(smem + lay.y + (k & 1) * lay.rows);
  };

  // issue the copies of tile k into stage k % 2, as one cp.async group
  auto load_tile = [&](int k) {
    T* dt_r = raw_rows(k & 1, 0);
    T* x_r = raw_rows(k & 1, 1);
    T* B_r = raw_bc(k & 1, 0);
    T* C_r = raw_bc(k & 1, 1);
    const long row0 = bL + static_cast<long>(k) * chunk;
    if (vec_rows) {
      for (int i = tid; i < chunk * kPieces; i += kThreads) {
        const int t = i / kPieces;
        const int dd = d0 + (i % kPieces) * E;
        const int valid = min(max(D - dd, 0), E);
        const long off = (row0 + t) * D + (valid > 0 ? dd : d0);
        const int at = t * kChannels + (i % kPieces) * E;
        const int bytes = valid * static_cast<int>(sizeof(T));
        cp_async16(dt_r + at, dt + off, bytes);
        cp_async16(x_r + at, x + off, bytes);
      }
    } else {
      for (int i = tid; i < chunk * kChannels; i += kThreads) {
        const int dd = d0 + i % kChannels;
        T dv = from_float<T>(0.f), xv = dv;
        if (dd < D) {
          const long off = (row0 + i / kChannels) * D + dd;
          dv = dt[off];
          xv = x[off];
        }
        dt_r[i] = dv;
        x_r[i] = xv;
      }
    }
    const long bc0 = row0 * N;  // a tile's rows of B and C are contiguous
    if (vec_bc) {
      for (int i = tid; i < chunk * N / E; i += kThreads) {
        cp_async16(B_r + i * E, B + bc0 + i * E, 16);
        cp_async16(C_r + i * E, C + bc0 + i * E, 16);
      }
    } else {
      for (int i = tid; i < chunk * N; i += kThreads) {
        B_r[i] = B[bc0 + i];
        C_r[i] = C[bc0 + i];
      }
    }
    cp_async_commit();
  };

  // tile k, arrived in stage k % 2, to f32 once for the whole block, four
  // values a load
  auto convert_tile = [&](int k) {
    const T* dt_r = raw_rows(k & 1, 0);
    const T* x_r = raw_rows(k & 1, 1);
    const T* B_r = raw_bc(k & 1, 0);
    const T* C_r = raw_bc(k & 1, 1);
    for (int i = 4 * tid; i < chunk * kChannels; i += 4 * kThreads) {
      float dv[4], xv[4], pairs[8];
      load4(dt_r + i, dv);
      load4(x_r + i, xv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pairs[2 * j] = dv[j];
        pairs[2 * j + 1] = __fmul_rn(dv[j], xv[j]);
      }
      store4(reinterpret_cast<float*>(dtf + i), pairs);
      store4(reinterpret_cast<float*>(dtf + i + 2), pairs + 4);
    }
    const int quads = chunk * N / 4;
    for (int i = 4 * tid; i < 4 * quads; i += 4 * kThreads) {
      float v[4];
      load4(B_r + i, v);
      store4(Bf + i, v);
      load4(C_r + i, v);
      store4(Cf + i, v);
    }
    for (int i = 4 * quads + tid; i < chunk * N; i += kThreads) {
      Bf[i] = to_float(B_r[i]);
      Cf[i] = to_float(C_r[i]);
    }
  };

  // y of tile k, from its shared tile to HBM
  auto store_tile = [&](int k) {
    const T* ys = y_tile(k);
    const long row0 = bL + static_cast<long>(k) * chunk;
    if (vec_rows) {
      for (int i = tid; i < chunk * kPieces; i += kThreads) {
        const int t = i / kPieces;
        const int dd = d0 + (i % kPieces) * E;
        const T* src = ys + t * kChannels + (i % kPieces) * E;
        T* dst = y + (row0 + t) * D + dd;
        if (dd + E <= D) {
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
        } else {
          for (int e = 0; dd + e < D; ++e) dst[e] = src[e];
        }
      }
    } else {
      for (int i = tid; i < chunk * kChannels; i += kThreads) {
        const int dd = d0 + i % kChannels;
        if (dd < D) y[(row0 + i / kChannels) * D + dd] = ys[i];
      }
    }
  };

  float a2[S], h[S];
  const int d = d0 + c;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a2[s] = d < D ? __fmul_rn(A[static_cast<long>(d) * N + p * S + s], kLog2e)
                  : 0.f;
    h[s] = 0.f;
  }

  const int tiles = L / chunk;
  load_tile(0);
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) {
      load_tile(k + 1);
    } else {
      cp_async_commit();  // an empty group, so the wait below means tile k
    }
    cp_async_wait_all_but_one();
    __syncthreads();  // tile k has arrived for all; y of tile k - 1 is whole
    if (k > 0) store_tile(k - 1);
    convert_tile(k);
    __syncthreads();

    if constexpr (kChunks) {  // the state this tile starts from
      if (d < D) {
        float* hc = h_chunks +
                    ((static_cast<long>(blockIdx.y) * tiles + k) * D + d) * N +
                    p * S;
#pragma unroll
        for (int s = 0; s < S; ++s) hc[s] = h[s];
      }
    }
    const float2* dtp = dtf + c;
    const float* Bp = Bf + p * S;
    const float* Cp = Cf + p * S;
    T* ys = y_tile(k) + c;
    int t = 0;
    for (; t + kUnroll <= chunk; t += kUnroll) {
      // every step's y is held in registers until the last one is summed,
      // so no store to shared memory sits between the steps' loads
      float yv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int tu = t + u;
        yv[u] = scan_step<S>(h, a2, dtp[tu * kChannels], Bp + tu * N,
                             Cp + tu * N);
      }
      reduce_scatter<P, kUnroll>(yv, p);
      constexpr int kMine = kUnroll / P;  // y values this lane stores
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        ys[(t + p * kMine + i) * kChannels] = from_float<T>(yv[i]);
      }
    }
    for (; t < chunk; ++t) {
      const float yv = reduce_all<P>(scan_step<S>(
          h, a2, dtp[t * kChannels], Bp + t * N, Cp + t * N));
      if (p == 0) ys[t * kChannels] = from_float<T>(yv);
    }
  }
  __syncthreads();
  store_tile(tiles - 1);
  if constexpr (kState) {
    if (d >= D) return;
    float* hp = h_last + (static_cast<long>(blockIdx.y) * D + d) * N + p * S;
#pragma unroll
    for (int s = 0; s < S; ++s) hp[s] = h[s];
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int N>
cudaError_t launch(const void* dt, const void* x, const void* A,
                   const void* B, const void* C, void* y, void* h_last,
                   void* h_chunks, int Bt, int L, int D, int chunk, int smem,
                   cudaStream_t stream) {
  auto kernel = h_last != nullptr
                    ? (h_chunks != nullptr ? scan_kernel<T, N, true, true>
                                           : scan_kernel<T, N, true, false>)
                    : (h_chunks != nullptr ? scan_kernel<T, N, false, true>
                                           : scan_kernel<T, N, false, false>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec_rows = (D * sizeof(T)) % 16 == 0 && aligned16(dt) &&
                        aligned16(x) && aligned16(y);
  const bool vec_bc =
      (chunk * N * sizeof(T)) % 16 == 0 && aligned16(B) && aligned16(C);
  dim3 grid((D + kChannels - 1) / kChannels, Bt);
  kernel<<<grid, kChannels * lanes_for(N), smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y),
      static_cast<float*>(h_last), static_cast<float*>(h_chunks), L, D,
      chunk, vec_rows, vec_bc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* dt, const void* x, const void* A,
                     const void* B, const void* C, void* y, void* h,
                     void* hc, int Bt, int L, int D, int N, int chunk,
                     int smem, cudaStream_t s) {
#define SCAN_CASE(n) \
  case n:            \
    return launch<T, n>(dt, x, A, B, C, y, h, hc, Bt, L, D, chunk, smem, s);
  switch (N) {
    SCAN_CASE(1)
    SCAN_CASE(2)
    SCAN_CASE(4)
    SCAN_CASE(8)
    SCAN_CASE(16)
    SCAN_CASE(32)
    default: return cudaErrorInvalidValue;
  }
#undef SCAN_CASE
}

}  // namespace

// dt, x, y: (Bt, L, D); A: (D, N) f32; B, C: (Bt, L, N); all contiguous.
// h_last: (Bt, D, N) f32, the state after step L - 1, or null for none.
// h_chunks: (Bt, L / chunk, D, N) f32, the state before the first step of
// each tile of `chunk` steps, or null for none.
// N is a power of two up to 32.  `lanes` and `channels` are the geometry of
// geometry() in repro_torch/kernels/mamba_scan/mamba_scan.py (lanes a
// channel, channels a block), checked against this kernel's; smem must be
// at least its smem_bytes.
extern "C" int mamba_scan_fwd(const void* dt, const void* x, const void* A,
                              const void* B, const void* C, void* y,
                              void* h_last, void* h_chunks, int Bt, int L,
                              int D, int N, int chunk, int dtype, int lanes,
                              int channels, int smem, void* stream) {
  const int esize = dtype == kF32 ? 4 : 2;
  if (Bt <= 0 || L <= 0 || D <= 0 || N <= 0 || N > 32 || (N & (N - 1)) ||
      chunk <= 0 || L % chunk != 0 || lanes != lanes_for(N) ||
      channels != kChannels ||
      smem < Smem(chunk, N, esize).total) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch<float>(dt, x, A, B, C, y, h_last, h_chunks, Bt, L, D, N,
                           chunk, smem, s);
  if (dtype == kBF16)
    return dispatch<__nv_bfloat16>(dt, x, A, B, C, y, h_last, h_chunks, Bt,
                                   L, D, N, chunk, smem, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// Backward (no TPU counterpart: the reference differentiates its jnp scan
// with XLA; here the forward is this kernel, so its gradient is one too).
// Walking time backward with dh = dL/dh_t (dh_last, or 0, after the last
// step), each step t of a channel d and state n does
//   dh += dy_t C_t                     (y_t = C_t . h_t)
//   dC_t += dy_t h_t,  dB_t += dh dt_t x_t,  g += dh B_t
//   ga = dh h_{t-1} a_t                (a_t = exp(dt_t A))
//   ddt_t += g x_t + ga A,  dx_t += g dt_t,  dA += ga dt_t
//   dh = a_t dh                        (to h_{t-1})
// dt, x sum over n; B, C over d; A over the batch.
//
// What bounds it on the H100: not the bytes (dt, x, dy read, ddt, dx
// written, five (Bt, L, D) tensors and the tile-start states: 0.21 ms at
// full width), nor the exponentials' floor, but the latency of each
// block's walk through its L steps with few warps an SM: at
// Falcon-Mamba-7B's width (Bt 1, D 8192) the grid holds 256 blocks of 4
// warps, 2 an SM (8 warps), and the issue slots, the shared-memory pipe
// and the exponentials each run at a third of their rate or less.  A clock
// probe of the phases found the ring's waits and load issue 38% of a
// block's time with one sub-tile a stage; the design takes overhead off
// each step and each stage:
// * The geometry is the forward's: a block owns kChannels = 32 channels, a
//   channel's N states lie on P = min(N, 4) lanes, S = N / P a lane; dh,
//   dA and the running state stay in registers for the whole sequence.
// * Every per-step input reaches the step loops from shared memory: a ring
//   of up to kBwdRingMax stages (as many as kBwdRingBytes hold), each
//   either up to kPassSubs sub-tiles of the pass from a tile's start (dt,
//   x, B) or up to kWalkSubs sub-tiles walked back (dt, x, dy, B, C),
//   filled by 16-byte cp.async ring - 1 stages ahead, in the order the
//   block reads them: 7 stages a tile of 64 steps where one sub-tile a
//   stage made 15.  Rows that rule out 16-byte copies take a plain
//   load-and-store path into the same stages.  A stage's steps past the
//   tile's end are zeros, so the step loops are straight-line code with no
//   guard (a guarded unrolled loop is a block a step to ptxas).
// * The states: each tile of `chunk` steps (the forward's, whose start
//   state h_chunks holds) is cut into sub-tiles of kSub = 32 / S steps,
//   and kBwdSeg sub-tiles make a segment.  For a segment, one pass from the
//   tile's start state runs up to the segment's last sub-tile, keeping the
//   state at the start of each of the segment's other sub-tiles in shared
//   memory; then the sub-tiles are taken last to first: each is recomputed
//   once from its start state into registers (its kSub + 1 states and kSub
//   decays, 2 x 32 + S floats a thread) and walked backward.  At the
//   default chunk 64 and N 16 (one segment of 8 sub-tiles of 8 steps) an
//   element costs 1 + 7/8 = 1.875 exponentials (the previous kernel's 2.5);
//   their floor at Falcon-Mamba-7B's width (L 4096, D 8192, N 16) is 5.4e8
//   x 1.875 / (16 x 132 SMs) clocks, 0.26 ms at 1.98 GHz.  The states are
//   the forward's bit for bit: the same rounding intrinsics in the same
//   order.
// * dB and dC are summed over channels once a sub-tile, not once a step:
//   each step's per-thread contributions go to shared memory (quads
//   swizzled so the stores meet no bank conflict), and after the walk the
//   block sums each (step, state) over its 32 channels in channel order.
//   A cluster of kBwdCluster blocks then adds its blocks' rows through
//   distributed shared memory in block order, a sub-tile late, so the
//   cluster barrier's latency hides behind a walk, and writes one f32
//   partial row of dB and of dC; a second kernel sums the clusters' rows
//   in order, and dA's batch rows.  At L 4096, D 8192 the partial rows are
//   2 x 33.5 MB (clusters of 2 blocks), where one a block made 2 x 67 MB;
//   a cluster of 8 would cut them to 2 x 8.4 MB, but only 30 such
//   clusters fit the card at 2 blocks an SM, so the last 2 of the 32 ran
//   as a second wave.
// * ddt and dx: each step's per-lane (g, ga A) go to shared memory and are
//   summed over the channel's P lanes in lane order after the walk.
// No float atomics: every call gives the same bits.
// ---------------------------------------------------------------------------

namespace {

constexpr int kBwdCluster = 2;       // blocks a cluster (along D)
constexpr int kBwdRingBytes = 40960; // the cp.async ring's bytes, at most
constexpr int kBwdRingMax = 10;      // and its stages: 3 to 10 of them
constexpr int kBwdSeg = 8;           // sub-tiles a segment
constexpr int kPassSubs = 3;         // sub-tiles a stage of the pass
constexpr int kWalkSubs = 2;         // sub-tiles a stage walked back

__host__ __device__ constexpr int min_max(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// steps a sub-tile: a thread keeps the sub-tile's states and decays in
// registers, 32 of each whatever N
__host__ __device__ constexpr int bwd_sub(int N) {
  return 32 / (N / lanes_for(N));
}

// Byte offsets of the backward's dynamic shared memory
// (mamba_scan_bwd_smem in repro_torch/kernels/mamba_scan/mamba_scan.py
// computes `total` alike): the ring of `ring` stages (six row regions
// [sub][kChannels] and four of [sub][N], in T: dt, x, dy and B, C of up
// to kWalkSubs sub-tiles walked back, or dt, x and B of up to kPassSubs
// sub-tiles of a pass; as many stages as fit kBwdRingBytes, 3 to
// kBwdRingMax of them); the per-thread dB, dC
// contributions of a sub-tile [sub][threads][2 S] f32; the per-thread
// (g, ga A) [sub][threads] float2; the block's channel sums of dB, dC
// [2][sub][2 N] f32 (two sub-tiles: the cluster reads one while the next
// is written); the segment's sub-tile start states [kBwdSeg - 1][threads]
// [S] f32.  Every region starts 16-byte aligned.
struct BwdSmem {
  int sub, rows, bc, slot, ring, red, gsm, xb, ckpt, total;
  __host__ __device__ constexpr BwdSmem(int N, int esize)
      : sub(bwd_sub(N)),
        rows(round16(sub * kChannels * esize)),
        bc(round16(sub * N * esize)),
        slot(6 * rows + 4 * bc),
        ring(min_max(kBwdRingBytes / slot, 3, kBwdRingMax)),
        red(ring * slot),
        gsm(red + sub * kChannels * 2 * N * 4),
        xb(gsm + sub * kChannels * lanes_for(N) * 8),
        ckpt(xb + 2 * sub * 2 * N * 4),
        total(ckpt + (kBwdSeg - 1) * kChannels * N * 4) {}
};

// blocks along D: every channel covered, whole clusters
__host__ __device__ constexpr int bwd_blocks(int D) {
  return ((D + kChannels - 1) / kChannels + kBwdCluster - 1) / kBwdCluster *
         kBwdCluster;
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// S states of T in shared memory as f32
template <int S>
__device__ __forceinline__ void load_states_t(const float* p,
                                              float (&v)[S]) {
  load_states<S>(p, v);
}
template <int S>
__device__ __forceinline__ void load_states_t(const __nv_bfloat16* p,
                                              float (&v)[S]) {
  if constexpr (S % 4 == 0) {
#pragma unroll
    for (int i = 0; i < S; i += 4) load4(p + i, v + i);
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = to_float(p[s]);
  }
}

// Where the block stands in its walk: tile k (k < 0 once done), segment
// seg; a stage covers the cnt sub-tiles first .. first + cnt - 1 of the
// tile: up to kPassSubs of the pass from the tile's start (`back` false),
// or up to kWalkSubs walked back, last first (`back`); `fresh` on the
// first stage of a segment.  The producer of the ring and its consumer
// each step one through the same order.
struct Cursor {
  int k, seg, first, cnt;
  bool back, fresh;
};

__device__ __forceinline__ void cursor_back(Cursor& u, int last, int s0) {
  u.back = true;
  u.cnt = min(kWalkSubs, last - s0 + 1);
  u.first = last - u.cnt + 1;
}

__device__ __forceinline__ void cursor_segment(Cursor& u, int subs) {
  const int s0 = u.seg * kBwdSeg;
  const int s1 = min(s0 + kBwdSeg, subs);
  u.fresh = true;
  if (s1 < 2) {  // no sub-tile before the last: walk at once
    cursor_back(u, s1 - 1, s0);
  } else {
    u.back = false;
    u.first = 0;
    u.cnt = min(kPassSubs, s1 - 1);
  }
}

__device__ __forceinline__ void cursor_next(Cursor& u, int subs, int segs) {
  u.fresh = false;
  const int s0 = u.seg * kBwdSeg;
  const int s1 = min(s0 + kBwdSeg, subs);
  if (!u.back) {
    u.first += u.cnt;
    if (u.first <= s1 - 2) {
      u.cnt = min(kPassSubs, s1 - 1 - u.first);
    } else {
      cursor_back(u, s1 - 1, s0);
    }
  } else if (u.first > s0) {
    cursor_back(u, u.first - 1, s0);
  } else if (u.seg > 0) {
    --u.seg;
    cursor_segment(u, subs);
  } else {
    --u.k;
    u.seg = segs - 1;
    if (u.k >= 0) cursor_segment(u, subs);
  }
}

// the quad swizzle of a thread's row of 2 S dB/dC contributions (S >= 4):
// its Q = S / 2 quads are rotated so that the 8 threads of a 16-byte store
// phase hit 8 different quads of banks
template <int S>
__host__ __device__ constexpr int red_swizzle(int t) {
  return S >= 4 ? (t / (16 / S)) % (S / 2) : 0;
}

template <typename T, int N>
__global__ void __cluster_dims__(kBwdCluster, 1, 1)
    __launch_bounds__(kChannels * lanes_for(N), 2)
scan_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, const T* __restrict__ dy,
                const float* __restrict__ dh_last,
                const float* __restrict__ h_chunks, T* __restrict__ ddt,
                T* __restrict__ dx, float* __restrict__ dA_part,
                float* __restrict__ dB_part, float* __restrict__ dC_part,
                int L, int D, int chunk, bool vec_rows, bool vec_bc) {
  constexpr int P = lanes_for(N);
  constexpr int S = N / P;
  constexpr int kThreads = kChannels * P;
  constexpr int kSub = bwd_sub(N);
  constexpr int kRing = BwdSmem(N, sizeof(T)).ring;
  constexpr int E = 16 / static_cast<int>(sizeof(T));  // elements a piece
  constexpr int kPieces = kChannels / E;               // pieces a row
  const int tid = threadIdx.x;
  const int c = tid / P;  // the thread's channel in the block
  const int p = tid % P;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const bool live = d < D;
  const long b = blockIdx.y;
  const long bL = b * L;
  const int tiles = L / chunk;
  const int subs = (chunk + kSub - 1) / kSub;  // sub-tiles a tile
  const int segs = (subs + kBwdSeg - 1) / kBwdSeg;
  const int rank = blockIdx.x % kBwdCluster;
  const long cl = blockIdx.x / kBwdCluster;
  const long clusters = gridDim.x / kBwdCluster;
  const BwdSmem lay(N, sizeof(T));

  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float2* gsm = reinterpret_cast<float2*>(smem + lay.gsm);
  float* xb = reinterpret_cast<float*>(smem + lay.xb);
  float* ckpt = reinterpret_cast<float*>(smem + lay.ckpt) + tid * S;

  // the stage `slot`'s row regions (walked back: dt 0-1, x 2-3, dy 4-5; a
  // pass: dt 0-2, x 3-5) and B, C regions (walked back: B 0-1, C 2-3; a
  // pass: B 0-2), the stage's steps in time order
  auto rows_of = [&](int slot, int which) {
    return reinterpret_cast<T*>(smem + slot * lay.slot + which * lay.rows);
  };
  auto bc_of = [&](int slot, int which) {
    return reinterpret_cast<T*>(smem + slot * lay.slot + 6 * lay.rows +
                                which * lay.bc);
  };

  // issue the copies of the sub-tile at `u` into stage `slot` (dy and C
  // only for a sub-tile walked back); the caller commits the group.  The
  // stage's steps past the sub-tile's end (a tile no multiple of kSub)
  // are zeros: with dt = x = dy = B = C = 0 a step leaves h, dh and dA as
  // they are, so the step loops run kSub steps with no guard
  auto load_slot = [&](const Cursor& u, int slot) {
    const int steps = u.cnt * kSub;
    const int ns = min(steps, chunk - u.first * kSub);  // steps in the tile
    const long row0 = bL + static_cast<long>(u.k) * chunk + u.first * kSub;
    T* dt_r = rows_of(slot, 0);
    T* x_r = rows_of(slot, u.back ? kWalkSubs : kPassSubs);
    T* dy_r = rows_of(slot, 2 * kWalkSubs);
    if (vec_rows) {
      for (int i = tid; i < steps * kPieces; i += kThreads) {
        const int t = i / kPieces;
        const int dd = d0 + (i % kPieces) * E;
        const int valid = t < ns ? min(max(D - dd, 0), E) : 0;
        const long off =
            (row0 + min(t, ns - 1)) * D + (valid > 0 ? dd : 0);
        const int at = t * kChannels + (i % kPieces) * E;
        const int bytes = valid * static_cast<int>(sizeof(T));
        cp_async16(dt_r + at, dt + off, bytes);
        cp_async16(x_r + at, x + off, bytes);
        if (u.back) cp_async16(dy_r + at, dy + off, bytes);
      }
    } else {
      for (int i = tid; i < steps * kChannels; i += kThreads) {
        const int dd = d0 + i % kChannels;
        T dv = from_float<T>(0.f), xv = dv, gv = dv;
        if (dd < D && i / kChannels < ns) {
          const long off = (row0 + i / kChannels) * D + dd;
          dv = dt[off];
          xv = x[off];
          if (u.back) gv = dy[off];
        }
        dt_r[i] = dv;
        x_r[i] = xv;
        if (u.back) dy_r[i] = gv;
      }
    }
    const long bc0 = row0 * N;  // a sub-tile's rows of B and C are contiguous
    const int nbc = ns * N;
    T* B_r = bc_of(slot, 0);
    T* C_r = bc_of(slot, kWalkSubs);
    if (vec_bc) {
      for (int i = tid; i * E < steps * N; i += kThreads) {
        const int left = min(max(nbc - i * E, 0), E);
        const int bytes = left * static_cast<int>(sizeof(T));
        const long at = bc0 + (left > 0 ? i * E : 0);
        cp_async16(B_r + i * E, B + at, bytes);
        if (u.back) cp_async16(C_r + i * E, C + at, bytes);
      }
    } else {
      for (int i = tid; i < steps * N; i += kThreads) {
        const T zero = from_float<T>(0.f);
        B_r[i] = i < nbc ? B[bc0 + i] : zero;
        if (u.back) C_r[i] = i < nbc ? C[bc0 + i] : zero;
      }
    }
  };

  float a2[S], Af[S], dh[S], dA[S], h[S], h0[S], h0n[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long at = static_cast<long>(live ? d : 0) * N + p * S + s;
    Af[s] = live ? A[at] : 0.f;
    a2[s] = __fmul_rn(Af[s], kLog2e);
    dh[s] = live && dh_last != nullptr ? dh_last[(b * D + d) * N + p * S + s]
                                       : 0.f;
    dA[s] = 0.f;
    h[s] = 0.f;
    h0[s] = 0.f;
  }
  // the state at the start of tile k, a tile ahead of its use
  auto load_h0 = [&](int k, float (&v)[S]) {
    const float* hc = h_chunks + ((b * tiles + k) * D + (live ? d : 0)) * N +
                      p * S;
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = live ? hc[s] : 0.f;
  };
  load_h0(tiles - 1, h0n);

  // the block's sums of a sub-tile's dB, dC rows, summed over the cluster
  // in block order: this block writes its share of the partial row
  auto cluster_sum = [&](int par, long t0, int ns) {
    constexpr int F = kSub * 2 * N / kBwdCluster;  // floats a block writes
    static_assert(F <= kThreads, "a thread a float of the block's share");
    if (tid < F) {
      const int e = rank * F + tid;
      const int i = e / (2 * N);
      const int w = (e / N) % 2;  // 0 dB, 1 dC
      const int n = e % N;
      const float* src =
          xb + (par * kSub + i) * 2 * N + (n / S) * 2 * S + w * S + n % S;
      const cg::cluster_group cluster = cg::this_cluster();
      float v = 0.f;
#pragma unroll
      for (int q = 0; q < kBwdCluster; ++q) {
        v += *cluster.map_shared_rank(src, q);
      }
      if (i < ns) {
        float* out = w ? dC_part : dB_part;
        out[((b * clusters + cl) * L + t0 + i) * N + n] = v;
      }
    }
  };

  // after a sub-tile's walk: its dB, dC contributions summed over the
  // block's channels in channel order into xb[par], in units of V floats
  // (H parts of the channels summed apart, then added pairwise); ddt and dx
  // of each (step, channel) from its lanes' (g, ga A) in lane order
  auto finish = [&](int par, long t0, int ns, const T* dt_s, const T* x_s) {
    constexpr int V = 2 * N < 4 ? 2 * N : 4;
    constexpr int U = 2 * N / V;  // units a step
    constexpr int H = kThreads / (kSub * U);  // parts of the channels
    constexpr int kUnits = 32 / H;            // units a warp
    static_assert(H >= 1 && kUnits * H == 32, "whole warps of units");
    const int lane = tid % 32;
    const int unit = (tid / 32) * kUnits + lane % kUnits;
    const int half = lane / kUnits;
    const int i = unit / U;
    const int q = unit % U;
    float sum[V];
#pragma unroll
    for (int v = 0; v < V; ++v) sum[v] = 0.f;
    if (i < ns) {
      for (int cc = half * (kChannels / H); cc < (half + 1) * (kChannels / H);
           ++cc) {
        const float* src;
        if constexpr (S >= 4) {
          constexpr int Q = S / 2;
          const int t = cc * P + q / Q;
          src = red + (i * kThreads + t) * 2 * S +
                4 * ((q % Q) ^ red_swizzle<S>(t));
        } else {
          src = red + (i * kThreads + cc * P) * 2 * S + V * q;
        }
        if constexpr (V == 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(src);
          sum[0] += v4.x;
          sum[1] += v4.y;
          sum[2] += v4.z;
          sum[3] += v4.w;
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) sum[v] += src[v];
        }
      }
    }
#pragma unroll
    for (int off = 16; off >= kUnits; off >>= 1) {  // the parts, pairwise
#pragma unroll
      for (int v = 0; v < V; ++v) {
        sum[v] += __shfl_xor_sync(0xffffffffu, sum[v], off);
      }
    }
    if (half == 0 && i < ns) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        xb[(par * kSub + i) * 2 * N + q * V + v] = sum[v];
      }
    }
    for (int e = tid; e < ns * kChannels; e += kThreads) {
      const int ii = e / kChannels;
      const int cc = e % kChannels;
      if (d0 + cc >= D) continue;
      const float2* gp = gsm + ii * kThreads + cc * P;
      float g = 0.f, ga = 0.f;
#pragma unroll
      for (int l = 0; l < P; ++l) {
        const float2 v = gp[l];
        g += v.x;
        ga += v.y;
      }
      const float xv = to_float(x_s[ii * kChannels + cc]);
      const float dtv = to_float(dt_s[ii * kChannels + cc]);
      const long at = (bL + t0 + ii) * D + d0 + cc;
      ddt[at] = from_float<T>(g * xv + ga);
      dx[at] = from_float<T>(g * dtv);
    }
  };

  Cursor prod;
  prod.k = tiles - 1;
  prod.seg = segs - 1;
  cursor_segment(prod, subs);
  Cursor cons = prod;
  for (int r = 0; r < kRing - 1; ++r) {
    if (prod.k >= 0) {
      load_slot(prod, r);
      cursor_next(prod, subs, segs);
    }
    cp_async_commit();
  }

  int walks = 0, prev_par = 0, prev_ns = 0;
  long prev_t0 = 0;
  for (int n = 0; cons.k >= 0; ++n) {
    cp_async_wait<kRing - 2>();
    __syncthreads();  // stage n has arrived for all; stage n - 1 is free
    if (prod.k >= 0) {
      load_slot(prod, (n + kRing - 1) % kRing);
      cursor_next(prod, subs, segs);
    }
    cp_async_commit();  // possibly empty, so the wait above counts stages
    const int slot = n % kRing;
    const T* dt_s = rows_of(slot, 0);
    const T* x_s = rows_of(slot, cons.back ? kWalkSubs : kPassSubs);
    const T* dy_s = rows_of(slot, 2 * kWalkSubs);
    const T* B_s = bc_of(slot, 0);
    const T* C_s = bc_of(slot, kWalkSubs);
    const int s0 = cons.seg * kBwdSeg;
    const int s1 = min(s0 + kBwdSeg, subs);
    if (cons.fresh) {
      if (cons.seg == segs - 1) {  // a new tile
#pragma unroll
        for (int s = 0; s < S; ++s) h0[s] = h0n[s];
        if (cons.k > 0) load_h0(cons.k - 1, h0n);
      }
#pragma unroll
      for (int s = 0; s < S; ++s) h[s] = h0[s];
    }
    if (!cons.back) {
      // the pass from the tile's start over the stage's sub-tiles, keeping
      // the segment's sub-tile start states
      for (int q = 0; q < cons.cnt; ++q) {
        const int jj = cons.first + q;
        if (jj >= s0) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            ckpt[(jj - s0) * kThreads * S + s] = h[s];
          }
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int r = q * kSub + i;
          const float dtv = to_float(dt_s[r * kChannels + c]);
          const float dtx = __fmul_rn(dtv, to_float(x_s[r * kChannels + c]));
          float bt[S];
          load_states_t<S>(B_s + r * N + p * S, bt);
#pragma unroll
          for (int s = 0; s < S; ++s) {
            h[s] = __fmaf_rn(ex2(__fmul_rn(dtv, a2[s])), h[s],
                             __fmul_rn(dtx, bt[s]));
          }
        }
      }
    } else {
      // the stage's sub-tiles, last first
      for (int q = cons.cnt - 1; q >= 0; --q) {
        const int jj = cons.first + q;
        const long t0 = static_cast<long>(cons.k) * chunk + jj * kSub;
        const int ns = min(kSub, chunk - jj * kSub);
        const int ro = q * kSub;  // the sub-tile's first row in the stage
        if (q < cons.cnt - 1) {
          __syncthreads();  // the previous sub-tile's finish is done
        }
        // the sub-tile's states and decays, recomputed once into registers
        float hs[kSub + 1][S], av[kSub][S];
        if (jj == s1 - 1) {
#pragma unroll
          for (int s = 0; s < S; ++s) hs[0][s] = h[s];
        } else {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            hs[0][s] = ckpt[(jj - s0) * kThreads * S + s];
          }
        }
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const float dtv = to_float(dt_s[(ro + i) * kChannels + c]);
          const float dtx =
              __fmul_rn(dtv, to_float(x_s[(ro + i) * kChannels + c]));
          float bt[S];
          load_states_t<S>(B_s + (ro + i) * N + p * S, bt);
#pragma unroll
          for (int s = 0; s < S; ++s) {
            av[i][s] = ex2(__fmul_rn(dtv, a2[s]));
            hs[i + 1][s] = __fmaf_rn(av[i][s], hs[i][s],
                                     __fmul_rn(dtx, bt[s]));
          }
        }
        // the sub-tile, backward
#pragma unroll
        for (int i = kSub - 1; i >= 0; --i) {
          const float dyv = to_float(dy_s[(ro + i) * kChannels + c]);
          const float dtv = to_float(dt_s[(ro + i) * kChannels + c]);
          const float dtx =
              __fmul_rn(dtv, to_float(x_s[(ro + i) * kChannels + c]));
          float bt[S], ct[S], gbc[2 * S];
          load_states_t<S>(B_s + (ro + i) * N + p * S, bt);
          load_states_t<S>(C_s + (ro + i) * N + p * S, ct);
          float g = 0.f, ga_a = 0.f;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            gbc[S + s] = dyv * hs[i + 1][s];  // dC
            dh[s] += dyv * ct[s];
            gbc[s] = dh[s] * dtx;  // dB
            g += dh[s] * bt[s];
            const float ga = dh[s] * hs[i][s] * av[i][s];
            ga_a += ga * Af[s];
            dA[s] += ga * dtv;
            dh[s] *= av[i][s];
          }
          float* row = red + (i * kThreads + tid) * 2 * S;
          if constexpr (S >= 4) {
#pragma unroll
            for (int hq = 0; hq < S / 2; ++hq) {
              *reinterpret_cast<float4*>(
                  row + 4 * (hq ^ red_swizzle<S>(tid))) =
                  make_float4(gbc[4 * hq], gbc[4 * hq + 1], gbc[4 * hq + 2],
                              gbc[4 * hq + 3]);
            }
          } else if constexpr (S == 2) {
            *reinterpret_cast<float4*>(row) =
                make_float4(gbc[0], gbc[1], gbc[2], gbc[3]);
          } else {
            *reinterpret_cast<float2*>(row) = make_float2(gbc[0], gbc[1]);
          }
          gsm[i * kThreads + tid] = make_float2(g, ga_a);
        }
        __syncthreads();  // the sub-tile's contributions are all in
        if (walks > 0) {
          // every block's sums of the previous sub-tile are in, and every
          // block is done reading the buffer written next
          cluster_wait();
          cluster_sum(prev_par, prev_t0, prev_ns);
        }
        finish(walks & 1, t0, ns, dt_s + ro * kChannels,
               x_s + ro * kChannels);
        cluster_arrive();
        prev_par = walks & 1;
        prev_t0 = t0;
        prev_ns = ns;
        ++walks;
      }
    }
    cursor_next(cons, subs, segs);
  }
  cluster_wait();
  cluster_sum(prev_par, prev_t0, prev_ns);
  // no block leaves while another may still read its shared memory
  cluster_arrive();
  cluster_wait();
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) dA_part[(b * D + d) * N + p * S + s] = dA[s];
  }
}

// dB, dC (Bt, L, N): the clusters' partial rows summed in cluster order;
// dA (D, N): the batch rows' partials summed in order
template <typename T>
__global__ void scan_bwd_sum_kernel(const float* __restrict__ dA_part,
                                    const float* __restrict__ dB_part,
                                    const float* __restrict__ dC_part,
                                    float* __restrict__ dA,
                                    T* __restrict__ dB, T* __restrict__ dC,
                                    int Bt, int L, int D, int N,
                                    int clusters) {
  const long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long bc = static_cast<long>(Bt) * L * N;
  if (e < bc) {
    const long b = e / (static_cast<long>(L) * N);
    const long tn = e % (static_cast<long>(L) * N);
    float sb = 0.f, sc = 0.f;
#pragma unroll 8
    for (int k = 0; k < clusters; ++k) {
      const long at = (b * clusters + k) * L * N + tn;
      sb += dB_part[at];
      sc += dC_part[at];
    }
    dB[e] = from_float<T>(sb);
    dC[e] = from_float<T>(sc);
  } else if (e < bc + static_cast<long>(D) * N) {
    const long dn = e - bc;
    float sa = 0.f;
    for (int b = 0; b < Bt; ++b) {
      sa += dA_part[b * static_cast<long>(D) * N + dn];
    }
    dA[dn] = sa;
  }
}

template <typename T, int N>
cudaError_t launch_bwd(const void* dt, const void* x, const void* A,
                       const void* B, const void* C, const void* dy,
                       const void* dh_last, const void* h_chunks, void* ddt,
                       void* dx, void* dA, void* dB, void* dC, void* dA_part,
                       void* dB_part, void* dC_part, int Bt, int L, int D,
                       int chunk, int smem, cudaStream_t stream) {
  auto kernel = scan_bwd_kernel<T, N>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec_rows = (D * sizeof(T)) % 16 == 0 && aligned16(dt) &&
                        aligned16(x) && aligned16(dy);
  const bool vec_bc =
      (chunk * N * sizeof(T)) % 16 == 0 && aligned16(B) && aligned16(C);
  const int blocks = bwd_blocks(D);
  kernel<<<dim3(blocks, Bt), kChannels * lanes_for(N), smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(dy),
      static_cast<const float*>(dh_last), static_cast<const float*>(h_chunks),
      static_cast<T*>(ddt), static_cast<T*>(dx),
      static_cast<float*>(dA_part), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), L, D, chunk, vec_rows, vec_bc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long total = static_cast<long>(Bt) * L * N + static_cast<long>(D) * N;
  scan_bwd_sum_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(dA_part), static_cast<const float*>(dB_part),
      static_cast<const float*>(dC_part), static_cast<float*>(dA),
      static_cast<T*>(dB), static_cast<T*>(dC), Bt, L, D, N,
      blocks / kBwdCluster);
  return cudaGetLastError();
}

// blocks of the backward kernel that fit an SM beside each other, and
// clusters of kBwdCluster that fit the card at once
template <typename T, int N>
cudaError_t occupancy_bwd(int* out) {
  auto kernel = scan_bwd_kernel<T, N>;
  const int smem = BwdSmem(N, sizeof(T)).total;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kernel, kChannels * lanes_for(N), smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBwdCluster * 64, 1, 1);
  cfg.blockDim = dim3(kChannels * lanes_for(N), 1, 1);
  cfg.dynamicSmemBytes = smem;
  return cudaOccupancyMaxActiveClusters(&out[1], kernel, &cfg);
}

#define SCAN_BWD_SWITCH(CASE) \
  switch (N) {                \
    CASE(1)                   \
    CASE(2)                   \
    CASE(4)                   \
    CASE(8)                   \
    CASE(16)                  \
    CASE(32)                  \
    default:                  \
      return cudaErrorInvalidValue; \
  }

template <typename T>
cudaError_t dispatch_bwd(const void* dt, const void* x, const void* A,
                         const void* B, const void* C, const void* dy,
                         const void* dh_last, const void* h_chunks,
                         void* ddt, void* dx, void* dA, void* dB, void* dC,
                         void* dA_part, void* dB_part, void* dC_part, int Bt,
                         int L, int D, int N, int chunk, int smem,
                         cudaStream_t s) {
#define SCAN_BWD_CASE(n)                                                    \
  case n:                                                                   \
    return launch_bwd<T, n>(dt, x, A, B, C, dy, dh_last, h_chunks, ddt, dx, \
                            dA, dB, dC, dA_part, dB_part, dC_part, Bt, L, D, \
                            chunk, smem, s);
  SCAN_BWD_SWITCH(SCAN_BWD_CASE)
#undef SCAN_BWD_CASE
}

template <typename T>
cudaError_t dispatch_occupancy(int N, int* out) {
#define SCAN_OCC_CASE(n) \
  case n:                \
    return occupancy_bwd<T, n>(out);
  SCAN_BWD_SWITCH(SCAN_OCC_CASE)
#undef SCAN_OCC_CASE
}

#undef SCAN_BWD_SWITCH

bool bwd_shape_ok(int L, int D, int N, int chunk) {
  return L > 0 && D > 0 && N > 0 && N <= 32 && !(N & (N - 1)) && chunk > 0 &&
         L % chunk == 0;
}

}  // namespace

// The gradient of mamba_scan_fwd.  dt, x, dy, ddt, dx: (Bt, L, D); B, C,
// dB, dC: (Bt, L, N), all of one type (f32 or bf16); A: (D, N) f32, dA:
// (D, N) f32.  dh_last: (Bt, D, N) f32, the gradient of the final state, or
// null for none; h_chunks: the forward's (Bt, L / chunk, D, N) f32 states
// at the start of each tile, at the same chunk.  Scratch: dA_part (Bt, D,
// N), dB_part and dC_part (Bt, blocks / kBwdCluster, L, N), all f32.
// lanes and channels as for mamba_scan_fwd; `blocks` (along D, whole
// clusters) and `smem` are those of mamba_scan_bwd_geometry in
// repro_torch/kernels/mamba_scan/mamba_scan.py, checked against this
// kernel's.
extern "C" int mamba_scan_bwd(const void* dt, const void* x, const void* A,
                              const void* B, const void* C, const void* dy,
                              const void* dh_last, const void* h_chunks,
                              void* ddt, void* dx, void* dA, void* dB,
                              void* dC, void* dA_part, void* dB_part,
                              void* dC_part, int Bt, int L, int D, int N,
                              int chunk, int dtype, int lanes, int channels,
                              int blocks, int smem, void* stream) {
  const int esize = dtype == kF32 ? 4 : 2;
  if (Bt <= 0 || !bwd_shape_ok(L, D, N, chunk) || lanes != lanes_for(N) ||
      channels != kChannels || h_chunks == nullptr ||
      blocks != bwd_blocks(D) || smem != BwdSmem(N, esize).total) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_bwd<float>(dt, x, A, B, C, dy, dh_last, h_chunks, ddt, dx,
                               dA, dB, dC, dA_part, dB_part, dC_part, Bt, L,
                               D, N, chunk, smem, s);
  if (dtype == kBF16)
    return dispatch_bwd<__nv_bfloat16>(dt, x, A, B, C, dy, dh_last, h_chunks,
                                       ddt, dx, dA, dB, dC, dA_part, dB_part,
                                       dC_part, Bt, L, D, N, chunk, smem, s);
  return cudaErrorInvalidValue;
}

// out[0]: blocks of the backward kernel for state size N that fit one SM at
// once; out[1]: clusters of kBwdCluster such blocks that fit the card at
// once
extern "C" int mamba_scan_bwd_occupancy(int N, int dtype, int* out) {
  if (dtype == kF32) return dispatch_occupancy<float>(N, out);
  if (dtype == kBF16) return dispatch_occupancy<__nv_bfloat16>(N, out);
  return cudaErrorInvalidValue;
}
