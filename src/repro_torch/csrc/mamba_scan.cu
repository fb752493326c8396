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

#include "common.cuh"

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
// The geometry is the forward's: a block owns 32 channels, a channel's N
// states lie on min(N, 4) lanes, the state h and dh stay in registers.
// The states of a tile of `chunk` steps are recomputed from the state the
// forward saved at its start (h_chunks), with the forward's own arithmetic
// (so bit for bit the forward's states), a sub-tile of kSub steps at a
// time: each sub-tile's states and decays go to shared memory, then the
// sub-tile is walked backward.  dt x B's partner sums over channels are
// taken within a warp by shuffles, across the block's warps in warp order
// through shared memory, and written as one f32 partial row per block;
// dA as one partial per batch row.  A second kernel sums the partials in
// order.  No atomics: every call gives the same bits.
//
// Bound on the H100: the exponentials (each element's decay is formed
// twice or more by the recomputation) and the serial chain on dh, as the
// forward; the bytes are the forward's plus dy, ddt, dx, dB, dC.
// ---------------------------------------------------------------------------

namespace {

constexpr int kSub = 16;  // steps a sub-tile

// dynamic shared memory of the backward kernel for a state size N: the
// states before and after each step of a sub-tile, its decays, and the
// warps' sums of dB and dC a step (mamba_scan_bwd_smem in
// repro_torch/kernels/mamba_scan/mamba_scan.py computes the same)
__host__ __device__ constexpr int bwd_smem_bytes(int N) {
  return ((2 * kSub + 1) * kChannels * N + 2 * kSub * lanes_for(N) * N) * 4;
}

template <typename T, int N>
__global__ void __launch_bounds__(kChannels * lanes_for(N))
scan_bwd_kernel(const T* __restrict__ dt, const T* __restrict__ x,
                const float* __restrict__ A, const T* __restrict__ B,
                const T* __restrict__ C, const T* __restrict__ dy,
                const float* __restrict__ dh_last,
                const float* __restrict__ h_chunks, T* __restrict__ ddt,
                T* __restrict__ dx, float* __restrict__ dA_part,
                float* __restrict__ dB_part, float* __restrict__ dC_part,
                int L, int D, int chunk) {
  constexpr int P = lanes_for(N);
  constexpr int S = N / P;
  constexpr int kThreads = kChannels * P;
  constexpr int kWarps = kThreads / 32;  // == P
  constexpr int kRow = kThreads * S;     // floats of one step's states
  const int tid = threadIdx.x;
  const int c = tid / P;
  const int p = tid % P;
  const int warp = tid / 32, lane = tid % 32;
  const int d = blockIdx.x * kChannels + c;
  const bool live = d < D;
  const long b = blockIdx.y;
  const long bL = b * L;
  const int tiles = L / chunk;

  extern __shared__ __align__(16) float bwd_smem[];
  float* hs = bwd_smem;                      // [kSub + 1][kRow]
  float* as = hs + (kSub + 1) * kRow;        // [kSub][kRow]
  float* redB = as + kSub * kRow;            // [kSub][kWarps][N]
  float* redC = redB + kSub * kWarps * N;    // [kSub][kWarps][N]

  float a2[S], Af[S], h[S], dh[S], dA[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const long at = static_cast<long>(d) * N + p * S + s;
    Af[s] = live ? A[at] : 0.f;
    a2[s] = __fmul_rn(Af[s], kLog2e);
    dh[s] = live && dh_last != nullptr ? dh_last[(b * D + d) * N + p * S + s]
                                       : 0.f;
    dA[s] = 0.f;
  }
  auto ld = [&](const T* src, int t) {
    return live ? to_float(src[(bL + t) * D + d]) : 0.f;
  };
  auto ld_states = [&](const T* src, int t, float (&v)[S]) {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = to_float(src[(bL + t) * N + p * S + s]);
  };

  for (int k = tiles - 1; k >= 0; --k) {
    const int t0 = k * chunk;
    const float* hc = h_chunks + ((b * tiles + k) * D + (live ? d : 0)) * N +
                      p * S;
    for (int s0 = t0 + (chunk - 1) / kSub * kSub; s0 >= t0; s0 -= kSub) {
      const int s1 = min(s0 + kSub, t0 + chunk);
      // the tile's states from its start up to the sub-tile's end
#pragma unroll
      for (int s = 0; s < S; ++s) h[s] = live ? hc[s] : 0.f;
      if (s0 == t0) {
#pragma unroll
        for (int s = 0; s < S; ++s) hs[tid * S + s] = h[s];
      }
      for (int t = t0; t < s1; ++t) {
        const float dtv = ld(dt, t);
        const float dtx = __fmul_rn(dtv, ld(x, t));
        float bt[S];
        ld_states(B, t, bt);
        const int i = t - s0;  // the step's place in the sub-tile
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float a = ex2(__fmul_rn(dtv, a2[s]));
          h[s] = __fmaf_rn(a, h[s], __fmul_rn(dtx, bt[s]));
          if (i >= 0) as[i * kRow + tid * S + s] = a;
          if (i >= -1) hs[(i + 1) * kRow + tid * S + s] = h[s];
        }
      }
      // the sub-tile, backward
      for (int t = s1 - 1; t >= s0; --t) {
        const int i = t - s0;
        const float dyv = ld(dy, t);
        const float dtv = ld(dt, t);
        const float xv = ld(x, t);
        const float dtx = __fmul_rn(dtv, xv);
        float bt[S], ct[S], gB[S], gC[S];
        ld_states(B, t, bt);
        ld_states(C, t, ct);
        float g = 0.f, ga_a = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float ht = hs[(i + 1) * kRow + tid * S + s];
          const float hp = hs[i * kRow + tid * S + s];
          const float a = as[i * kRow + tid * S + s];
          gC[s] = dyv * ht;
          dh[s] += dyv * ct[s];
          gB[s] = dh[s] * dtx;
          g += dh[s] * bt[s];
          const float ga = dh[s] * hp * a;
          ga_a += ga * Af[s];
          dA[s] += ga * dtv;
          dh[s] *= a;
        }
        // ddt and dx of the channel: its P lanes' parts
#pragma unroll
        for (int off = P / 2; off > 0; off >>= 1) {
          g += __shfl_xor_sync(0xffffffffu, g, off);
          ga_a += __shfl_xor_sync(0xffffffffu, ga_a, off);
        }
        if (p == 0 && live) {
          ddt[(bL + t) * D + d] = from_float<T>(g * xv + ga_a);
          dx[(bL + t) * D + d] = from_float<T>(g * dtv);
        }
        // dB and dC over the warp's channels (lanes P apart share a state)
#pragma unroll
        for (int s = 0; s < S; ++s) {
#pragma unroll
          for (int off = P; off < 32; off <<= 1) {
            gB[s] += __shfl_xor_sync(0xffffffffu, gB[s], off);
            gC[s] += __shfl_xor_sync(0xffffffffu, gC[s], off);
          }
        }
        if (lane < P) {
#pragma unroll
          for (int s = 0; s < S; ++s) {
            redB[(i * kWarps + warp) * N + p * S + s] = gB[s];
            redC[(i * kWarps + warp) * N + p * S + s] = gC[s];
          }
        }
      }
      __syncthreads();
      // the sub-tile's rows of the block's dB and dC partials
      const long row0 = (b * gridDim.x + blockIdx.x) * L + s0;
      for (int e = tid; e < (s1 - s0) * N; e += kThreads) {
        const int i = e / N, n = e % N;
        float sb = 0.f, sc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          sb += redB[(i * kWarps + w) * N + n];
          sc += redC[(i * kWarps + w) * N + n];
        }
        dB_part[(row0 + i) * N + n] = sb;
        dC_part[(row0 + i) * N + n] = sc;
      }
      __syncthreads();  // the next sub-tile overwrites the buffers
    }
  }
  if (live) {
#pragma unroll
    for (int s = 0; s < S; ++s) dA_part[(b * D + d) * N + p * S + s] = dA[s];
  }
}

// dB, dC (Bt, L, N): the blocks' partial rows summed in block order; dA
// (D, N): the batch rows' partials summed in order
template <typename T>
__global__ void scan_bwd_sum_kernel(const float* __restrict__ dA_part,
                                    const float* __restrict__ dB_part,
                                    const float* __restrict__ dC_part,
                                    float* __restrict__ dA,
                                    T* __restrict__ dB, T* __restrict__ dC,
                                    int Bt, int L, int D, int N, int blocks) {
  const long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long bc = static_cast<long>(Bt) * L * N;
  if (e < bc) {
    const long b = e / (static_cast<long>(L) * N);
    const long tn = e % (static_cast<long>(L) * N);
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < blocks; ++k) {
      const long at = (b * blocks + k) * L * N + tn;
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
                       int chunk, cudaStream_t stream) {
  auto kernel = scan_bwd_kernel<T, N>;
  constexpr int smem = bwd_smem_bytes(N);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (D + kChannels - 1) / kChannels;
  kernel<<<dim3(blocks, Bt), kChannels * lanes_for(N), smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const T*>(dy),
      static_cast<const float*>(dh_last), static_cast<const float*>(h_chunks),
      static_cast<T*>(ddt), static_cast<T*>(dx),
      static_cast<float*>(dA_part), static_cast<float*>(dB_part),
      static_cast<float*>(dC_part), L, D, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long total = static_cast<long>(Bt) * L * N + static_cast<long>(D) * N;
  scan_bwd_sum_kernel<T><<<(total + 255) / 256, 256, 0, stream>>>(
      static_cast<const float*>(dA_part), static_cast<const float*>(dB_part),
      static_cast<const float*>(dC_part), static_cast<float*>(dA),
      static_cast<T*>(dB), static_cast<T*>(dC), Bt, L, D, N, blocks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* dt, const void* x, const void* A,
                         const void* B, const void* C, const void* dy,
                         const void* dh_last, const void* h_chunks,
                         void* ddt, void* dx, void* dA, void* dB, void* dC,
                         void* dA_part, void* dB_part, void* dC_part, int Bt,
                         int L, int D, int N, int chunk, cudaStream_t s) {
#define SCAN_BWD_CASE(n)                                                    \
  case n:                                                                   \
    return launch_bwd<T, n>(dt, x, A, B, C, dy, dh_last, h_chunks, ddt, dx, \
                            dA, dB, dC, dA_part, dB_part, dC_part, Bt, L, D, \
                            chunk, s);
  switch (N) {
    SCAN_BWD_CASE(1)
    SCAN_BWD_CASE(2)
    SCAN_BWD_CASE(4)
    SCAN_BWD_CASE(8)
    SCAN_BWD_CASE(16)
    SCAN_BWD_CASE(32)
    default: return cudaErrorInvalidValue;
  }
#undef SCAN_BWD_CASE
}

}  // namespace

// The gradient of mamba_scan_fwd.  dt, x, dy, ddt, dx: (Bt, L, D); B, C,
// dB, dC: (Bt, L, N), all of one type (f32 or bf16); A: (D, N) f32, dA:
// (D, N) f32.  dh_last: (Bt, D, N) f32, the gradient of the final state, or
// null for none; h_chunks: the forward's (Bt, L / chunk, D, N) f32 states
// at the start of each tile, at the same chunk.  Scratch: dA_part (Bt, D,
// N), dB_part and dC_part (Bt, ceil(D / 32), L, N), all f32.  lanes and
// channels as for mamba_scan_fwd.
extern "C" int mamba_scan_bwd(const void* dt, const void* x, const void* A,
                              const void* B, const void* C, const void* dy,
                              const void* dh_last, const void* h_chunks,
                              void* ddt, void* dx, void* dA, void* dB,
                              void* dC, void* dA_part, void* dB_part,
                              void* dC_part, int Bt, int L, int D, int N,
                              int chunk, int dtype, int lanes, int channels,
                              void* stream) {
  if (Bt <= 0 || L <= 0 || D <= 0 || N <= 0 || N > 32 || (N & (N - 1)) ||
      chunk <= 0 || L % chunk != 0 || lanes != lanes_for(N) ||
      channels != kChannels || h_chunks == nullptr) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_bwd<float>(dt, x, A, B, C, dy, dh_last, h_chunks, ddt, dx,
                               dA, dB, dC, dA_part, dB_part, dC_part, Bt, L,
                               D, N, chunk, s);
  if (dtype == kBF16)
    return dispatch_bwd<__nv_bfloat16>(dt, x, A, B, C, dy, dh_last, h_chunks,
                                       ddt, dx, dA, dB, dC, dA_part, dB_part,
                                       dC_part, Bt, L, D, N, chunk, s);
  return cudaErrorInvalidValue;
}
