// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale,
// computed in f32 and stored in x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py
// (_rmsnorm_kernel, launched by rmsnorm_fwd).
//
// Bound on the H100: bytes.  Each element is read from HBM once and written
// once, against ~4 flops, far below the card's ~20 flops/byte f32 ridge.
// Design: one warp owns a row at a time, so the row never leaves the SM
// between the sum of squares and the output pass (the second read hits
// L1); loads and stores are 16 bytes (f32) or 8 bytes (bf16) per lane when
// the row width allows; the scale vector is staged once per block in shared
// memory as f32.  ``block_rows`` (rows per block) sets the grid: few large
// blocks leave SMs idle, many small ones pay more per-block overhead and
// re-stage the scale more often.  A row's arithmetic (its lane split and the
// butterfly reduction) does not depend on block_rows, so neither does the
// error — the contract of ERROR_KNOBS in repro_torch/kernels/workloads.py.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, typename S, bool kVec>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ y, int d, int block_rows, float eps) {
  extern __shared__ float scale_s[];  // d floats
  for (int i = threadIdx.x; i < d; i += kThreads) {
    scale_s[i] = to_float(scale[i]);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long row0 = static_cast<long>(blockIdx.x) * block_rows;
  for (int r = warp; r < block_rows; r += kWarps) {
    const T* xr = x + (row0 + r) * d;
    T* yr = y + (row0 + r) * d;
    float ss = 0.f;
    if constexpr (kVec) {
      for (int i = 4 * lane; i < d; i += 128) {
        float v[4];
        load4(xr + i, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) ss += v[c] * v[c];
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float v = to_float(xr[i]);
        ss += v * v;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    if constexpr (kVec) {
      for (int i = 4 * lane; i < d; i += 128) {
        float v[4];
        load4(xr + i, v);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = v[c] * inv * scale_s[i + c];
        store4(yr + i, v);
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        yr[i] = from_float<T>(to_float(xr[i]) * inv * scale_s[i]);
      }
    }
  }
}

template <typename T, typename S, bool kVec>
cudaError_t launch(const void* x, const void* scale, void* y, int rows, int d,
                   int block_rows, float eps, int smem, cudaStream_t stream) {
  auto kernel = rmsnorm_kernel<T, S, kVec>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows / block_rows, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(y), d, block_rows, eps);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_vec(const void* x, const void* scale, void* y, int rows,
                       int d, int block_rows, float eps, int smem,
                       cudaStream_t stream) {
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(y) % (4 * sizeof(T)) == 0;
  return vec ? launch<T, S, true>(x, scale, y, rows, d, block_rows, eps, smem,
                                  stream)
             : launch<T, S, false>(x, scale, y, rows, d, block_rows, eps,
                                   smem, stream);
}

}  // namespace

// x, y: (rows, d) contiguous; scale: (d,).  smem must be at least d * 4
// bytes (smem_bytes in repro_torch/kernels/rmsnorm/rmsnorm.py).
extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y,
                           int rows, int d, int block_rows, float eps,
                           int x_dtype, int scale_dtype, int smem,
                           void* stream) {
  if (rows <= 0 || d <= 0 || block_rows <= 0 || rows % block_rows != 0 ||
      smem < d * static_cast<int>(sizeof(float))) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32 && scale_dtype == kF32)
    return launch_vec<float, float>(x, scale, y, rows, d, block_rows, eps,
                                    smem, s);
  if (x_dtype == kBF16 && scale_dtype == kF32)
    return launch_vec<__nv_bfloat16, float>(x, scale, y, rows, d, block_rows,
                                            eps, smem, s);
  if (x_dtype == kF32 && scale_dtype == kBF16)
    return launch_vec<float, __nv_bfloat16>(x, scale, y, rows, d, block_rows,
                                            eps, smem, s);
  if (x_dtype == kBF16 && scale_dtype == kBF16)
    return launch_vec<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d,
                                                    block_rows, eps, smem, s);
  return cudaErrorInvalidValue;
}
