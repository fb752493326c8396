// Mamba-1 selective scan for Hopper (sm_90a):
//   h_t = exp(dt_t * A) . h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t . C_t
// with the (D, N) state in f32 registers for the whole sequence.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba_scan/mamba_scan.py
// (_scan_kernel, launched by mamba_scan_fwd).  As there, the decay
// exp(dt A) and the drive dt x B are formed in registers and never reach
// HBM.
//
// Bound on the H100: bytes.  Per (t, d) the kernel reads dt and x and writes
// y; B and C are shared by all channels.  Against that it does ~6N flops
// and N exponentials, under the f32 ridge at N = 16.  Design: one thread
// per (channel, state) pair, so a block of 128 threads owns 128 / N
// channels and the state lives in one register of each thread; the
// sequential loop over t runs inside the block (Hopper runs blocks in no
// order, so no state may carry from one block to another).  Each step of
// ``chunk`` timesteps first stages dt and x for the block's channels and B
// and C into shared memory with coalesced loads, then scans the chunk,
// reducing y over the N state threads of a channel with a fixed butterfly,
// and writes the chunk's y back coalesced.  ``chunk`` sets how much is
// staged per barrier: a short chunk pays more barriers, a long one more
// shared memory per block and so fewer resident blocks.  Every output is the
// same arithmetic whatever the chunk.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ dt, const T* __restrict__ x,
            const float* __restrict__ A, const T* __restrict__ B,
            const T* __restrict__ C, T* __restrict__ y, int L, int D, int N,
            int chunk) {
  const int cpb = kThreads / N;  // channels per block
  const int c = threadIdx.x / N;
  const int n = threadIdx.x % N;
  const int d0 = blockIdx.x * cpb;
  const int d = d0 + c;
  const long bL = static_cast<long>(blockIdx.y) * L;

  extern __shared__ float smem[];
  float* dt_s = smem;                // [chunk][cpb]
  float* x_s = dt_s + chunk * cpb;   // [chunk][cpb]
  float* y_s = x_s + chunk * cpb;    // [chunk][cpb]
  float* B_s = y_s + chunk * cpb;    // [chunk][N]
  float* C_s = B_s + chunk * N;      // [chunk][N]

  const float a = d < D ? A[static_cast<long>(d) * N + n] : 0.f;
  float h = 0.f;

  for (int t0 = 0; t0 < L; t0 += chunk) {
    for (int i = threadIdx.x; i < chunk * cpb; i += kThreads) {
      const int t = i / cpb;
      const int dd = d0 + i % cpb;
      float dv = 0.f, xv = 0.f;
      if (dd < D) {
        const long off = (bL + t0 + t) * D + dd;
        dv = to_float(dt[off]);
        xv = to_float(x[off]);
      }
      dt_s[i] = dv;
      x_s[i] = xv;
    }
    for (int i = threadIdx.x; i < chunk * N; i += kThreads) {
      const long off = (bL + t0) * N + i;  // the chunk's rows are contiguous
      B_s[i] = to_float(B[off]);
      C_s[i] = to_float(C[off]);
    }
    __syncthreads();

    for (int t = 0; t < chunk; ++t) {
      const float dtv = dt_s[t * cpb + c];
      const float decay = expf(dtv * a);
      const float drive = (dtv * x_s[t * cpb + c]) * B_s[t * N + n];
      h = decay * h + drive;
      float yv = h * C_s[t * N + n];
      for (int off = N / 2; off > 0; off >>= 1) {
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      }
      if (n == 0) y_s[t * cpb + c] = yv;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < chunk * cpb; i += kThreads) {
      const int dd = d0 + i % cpb;
      if (dd < D) y[(bL + t0 + i / cpb) * D + dd] = from_float<T>(y_s[i]);
    }
    // the next chunk's staging writes dt_s, x_s, B_s and C_s only; y_s is
    // written again only after the next barrier
  }
}

template <typename T>
cudaError_t launch(const void* dt, const void* x, const void* A,
                   const void* B, const void* C, void* y, int Bt, int L,
                   int D, int N, int chunk, int smem, cudaStream_t stream) {
  auto kernel = scan_kernel<T>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int cpb = kThreads / N;
  dim3 grid((D + cpb - 1) / cpb, Bt);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(dt), static_cast<const T*>(x),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<T*>(y), L, D, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// dt, x, y: (Bt, L, D); A: (D, N) f32; B, C: (Bt, L, N); all contiguous.
// N is a power of two up to 32.  smem must be at least
// chunk * (3 * (128 / N) + 2 * N) * 4 bytes (smem_bytes in
// repro_torch/kernels/mamba_scan/mamba_scan.py).
extern "C" int mamba_scan_fwd(const void* dt, const void* x, const void* A,
                              const void* B, const void* C, void* y, int Bt,
                              int L, int D, int N, int chunk, int dtype,
                              int smem, void* stream) {
  if (Bt <= 0 || L <= 0 || D <= 0 || N <= 0 || N > 32 || (N & (N - 1)) ||
      chunk <= 0 || L % chunk != 0 ||
      smem < chunk * (3 * (kThreads / N) + 2 * N) * 4) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return launch<float>(dt, x, A, B, C, y, Bt, L, D, N, chunk, smem, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(dt, x, A, B, C, y, Bt, L, D, N, chunk, smem,
                                 s);
  return cudaErrorInvalidValue;
}
