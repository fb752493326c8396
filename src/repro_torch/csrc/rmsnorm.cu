// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale,
// computed in f32 and stored in x's type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/rmsnorm.py
// (_rmsnorm_kernel, :17, launched by rmsnorm_fwd).
//
// Bound on the H100: bytes.  Each element is read from HBM once and written
// once, against ~4 flops, far below the card's ~20 flops/byte f32 ridge, so
// the design is about reading each byte once and keeping enough bytes in
// flight to cover HBM's latency:
//
// * One warp owns a row at a time and holds the whole row in registers:
//   every lane issues all its 16-byte loads (8 bf16 or 4 f32 values each;
//   d = 1024 bf16 is 4 loads, 32 values a lane) before the reduction,
//   then takes the butterfly sum and writes the output from the registers.
//   Widths up to 4096 are compile-time instantiations (512, 1024, 2048,
//   4096 values a row at most); other widths, and rows whose width is not
//   a multiple of the 16-byte vector, take a generic path that reads the
//   row twice.
// * A block runs min(block_rows, 32) warps (fewer for the widest rows, so
//   the row still fits the registers), so the default schedule at full
//   width holds 32 warps, 64 KB of loads in flight, on each SM.
//   ``block_rows`` (rows per block) still sets the grid: few large blocks
//   leave SMs idle, many small ones stage the scale vector (f32, in shared
//   memory) more often.
//
// A row's arithmetic (its lane split, the order of the per-lane sum, the
// butterfly) depends on d alone, not on block_rows or on how many warps a
// block has, so outputs are bit-identical across block_rows -- the
// contract of ERROR_KNOBS in repro_torch/kernels/workloads.py.
//
// The backward (rmsnorm_bwd, below) has no TPU counterpart: the reference
// leaves the gradient of its jnp models to XLA, but here the forward of
// every norm is this kernel, so its gradient is one too.  With
// r = rsqrt(mean(x^2) + eps) and g = dy * scale it computes
//   dx = r * (g - x * r^2 * mean(g * x)),   dscale = sum over rows dy * x * r.
// Bound on the H100: bytes (x and dy read, dx written: 3 elements a value
// against ~10 flops).  The design keeps every byte read once and enough of
// them in flight:
//
// * The row path (widths up to 4096, a multiple of the 16-byte vector):
//   a group of lanes takes a row and holds its x and dy in registers
//   between the two passes (sum(x^2) and sum(g x), then dx), with 16-byte
//   loads and stores, as the forward.  Narrow rows get fewer lanes (d 128
//   in bf16: 8 lanes of two vectors, four rows a warp), wide rows several
//   warps (d 4096 in bf16: 128 lanes of four vectors, the row's sums
//   across the warps through shared memory and a named barrier).
// * A lane visits the same columns in every row, so its scale and its
//   part of dscale stay in registers; at the end each block sums its row
//   groups' parts in group order into one f32 partial row.
// * Other widths and unaligned rows take the generic path: one warp a row,
//   the row read twice (the second from L1/L2), each warp's dscale in an
//   f32 row of shared memory.
// * dscale: a second kernel sums the blocks' partial rows in block order
//   (32 interleaved segments of them, added in segment order).  No
//   atomics: the result is the same bits on every call.

#include "common.cuh"

#include <algorithm>

namespace {

constexpr int kMaxWarps = 32;

// 16 bytes of x as floats
__device__ __forceinline__ void unpack16(const uint4& raw, float* v, float) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4& raw, float* v,
                                         __nv_bfloat16) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack16(const float* v, float) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16(const float* v, __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&b);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename S>
__device__ __forceinline__ void stage_scale(const S* scale, float* scale_s,
                                            int d) {
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    scale_s[i] = to_float(scale[i]);
  }
  __syncthreads();
}

// the row in registers: lane l's chunk c covers elements
// (32 c + l) * kVec ... + kVec - 1; d must be a multiple of kVec
template <typename T, typename S, int kChunks, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_row_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                   T* __restrict__ y, int d, int block_rows, float eps) {
  constexpr int kVec = 16 / sizeof(T);
  extern __shared__ float scale_s[];  // d floats
  stage_scale(scale, scale_s, d);
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long row0 = static_cast<long>(blockIdx.x) * block_rows;
  for (int r = warp; r < block_rows; r += warps) {
    const T* xr = x + (row0 + r) * d;
    T* yr = y + (row0 + r) * d;
    uint4 raw[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = (32 * c + lane) * kVec;
      if (i < d) raw[c] = __ldg(reinterpret_cast<const uint4*>(xr + i));
    }
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if ((32 * c + lane) * kVec < d) {
        float v[kVec];
        unpack16(raw[c], v, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e) ss += v[e] * v[e];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = (32 * c + lane) * kVec;
      if (i < d) {
        float v[kVec];
        unpack16(raw[c], v, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e) v[e] = v[e] * inv * scale_s[i + e];
        *reinterpret_cast<uint4*>(yr + i) = pack16(v, T());
      }
    }
  }
}

// any width: the sum of squares, then a second read of the row for the
// output (4-wide loads when d is a multiple of 4, else one element a lane)
template <typename T, typename S, bool kVec4>
__global__ void __launch_bounds__(kMaxWarps * 32)
rmsnorm_generic_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                       T* __restrict__ y, int d, int block_rows, float eps) {
  extern __shared__ float scale_s[];  // d floats
  stage_scale(scale, scale_s, d);
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long row0 = static_cast<long>(blockIdx.x) * block_rows;
  for (int r = warp; r < block_rows; r += warps) {
    const T* xr = x + (row0 + r) * d;
    T* yr = y + (row0 + r) * d;
    float ss = 0.f;
    if constexpr (kVec4) {
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
    if constexpr (kVec4) {
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

// the row kernel for the smallest width cap that holds d
template <typename T, typename S>
cudaError_t launch_row(const T* x, const S* scale, T* y, int rows, int d,
                       int block_rows, float eps, int smem,
                       cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  auto go = [&](auto kernel, int max_threads) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const int warps = std::min(block_rows, max_threads / 32);
    kernel<<<rows / block_rows, warps * 32, smem, stream>>>(x, scale, y, d,
                                                            block_rows, eps);
    return cudaGetLastError();
  };
  // raw registers a lane: 4 per chunk; the launch bound leaves room for them
  if (d <= 512)
    return go(rmsnorm_row_kernel<T, S, 512 / 32 / kVec, 1024>, 1024);
  if (d <= 1024)
    return go(rmsnorm_row_kernel<T, S, 1024 / 32 / kVec, 1024>, 1024);
  if (d <= 2048) {
    constexpr int kC = 2048 / 32 / kVec;
    return go(rmsnorm_row_kernel<T, S, kC, kC <= 8 ? 1024 : 512>,
              kC <= 8 ? 1024 : 512);
  }
  constexpr int kC = 4096 / 32 / kVec;
  return go(rmsnorm_row_kernel<T, S, kC, kC <= 16 ? 512 : 256>,
            kC <= 16 ? 512 : 256);
}

constexpr int kMaxRowWidth = 4096;

template <typename T, typename S>
cudaError_t launch_any(const void* xv, const void* scalev, void* yv, int rows,
                       int d, int block_rows, float eps, int smem,
                       cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const S* scale = static_cast<const S*>(scalev);
  T* y = static_cast<T*>(yv);
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned16 = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (aligned16 && d % kVec == 0 && d <= kMaxRowWidth)
    return launch_row<T, S>(x, scale, y, rows, d, block_rows, eps, smem,
                            stream);
  const int warps = std::min(block_rows, kMaxWarps);
  const bool vec4 = d % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
                    reinterpret_cast<uintptr_t>(y) % (4 * sizeof(T)) == 0;
  auto kernel = vec4 ? rmsnorm_generic_kernel<T, S, true>
                     : rmsnorm_generic_kernel<T, S, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<rows / block_rows, warps * 32, smem, stream>>>(x, scale, y, d,
                                                          block_rows, eps);
  return cudaGetLastError();
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
    return launch_any<float, float>(x, scale, y, rows, d, block_rows, eps,
                                    smem, s);
  if (x_dtype == kBF16 && scale_dtype == kF32)
    return launch_any<__nv_bfloat16, float>(x, scale, y, rows, d, block_rows,
                                            eps, smem, s);
  if (x_dtype == kF32 && scale_dtype == kBF16)
    return launch_any<float, __nv_bfloat16>(x, scale, y, rows, d, block_rows,
                                            eps, smem, s);
  if (x_dtype == kBF16 && scale_dtype == kBF16)
    return launch_any<__nv_bfloat16, __nv_bfloat16>(x, scale, y, rows, d,
                                                    block_rows, eps, smem, s);
  return cudaErrorInvalidValue;
}

namespace {

constexpr int kBwdMaxWarps = 8;    // warps a block of the generic path
constexpr int kBwdThreads = 256;   // threads a block of the row path
constexpr int kBwdRowMax = 4096;   // widest row the row path holds
constexpr int kBwdMinVecs = 8;     // 16-byte vectors a row is padded up to
constexpr int kBwdLaneVecs = 4;    // vectors a lane, rows of 128 vectors up
constexpr int kBwdSumSegs = 32;    // segments of the partial rows summed

// a row of nv 16-byte vectors is held as nvmax (a power of two, at least
// kBwdMinVecs): kBwdLaneVecs vectors a lane from 128 vectors up, half as
// many below, so a row takes nvmax / that lanes (4 to 256)
__host__ __device__ constexpr int bwd_row_vecs(int nv) {
  int m = kBwdMinVecs;
  while (m < nv) m *= 2;
  return m;
}
__host__ __device__ constexpr int bwd_lane_vecs(int nvmax) {
  return nvmax >= 128 ? kBwdLaneVecs : kBwdLaneVecs / 2;
}
__host__ __device__ constexpr int bwd_row_lanes(int nvmax) {
  return nvmax / bwd_lane_vecs(nvmax);
}
// dynamic shared memory of the row path: each row group's f32 row of
// dscale, and for rows over several warps the warps' (sum x^2, sum g x)
// of two rows
__host__ __device__ constexpr int bwd_row_smem(int d, int lanes) {
  return kBwdThreads / lanes * d * 4 +
         (lanes > 32 ? 2 * (kBwdThreads / lanes) * (lanes / 32) * 8 : 0);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The row path: a group of G lanes takes a row, each lane Kc 16-byte
// vectors of x and of dy (vectors j, G + j, ... of the row, so the group's
// loads are contiguous), held in registers between the two passes.  The
// lane's columns are the same in every row it visits, so its scale and its
// part of dscale stay in registers; groups under a warp share it (32 / G
// rows at once), groups over a warp sum their row across its warps through
// shared memory and a named barrier.  At the end the block sums its
// groups' dscale in group order into one f32 partial row.
template <typename T, typename S, int G, int Kc>
__global__ void __launch_bounds__(kBwdThreads)
rmsnorm_bwd_row_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                       const T* __restrict__ dy, T* __restrict__ dx,
                       float* __restrict__ partial, int rows, int d,
                       float eps) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int NG = kBwdThreads / G;         // row groups a block
  constexpr int W = G > 32 ? G / 32 : 1;      // warps a group
  constexpr int kRows = G < 32 ? 32 / G : 1;  // rows a warp takes at once
  extern __shared__ __align__(16) float bwd_row_s[];
  float* blk = bwd_row_s;  // [NG][d]
  float2* red = reinterpret_cast<float2*>(bwd_row_s + NG * d);  // [2][NG][W]
  const int tid = threadIdx.x;
  const int g = tid / G;
  const int j = tid % G;
  const int nv = d / kVec;
  float sc[Kc][kVec], acc[Kc][kVec];
#pragma unroll
  for (int k = 0; k < Kc; ++k) {
    const int v = k * G + j;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      sc[k][e] = v < nv ? to_float(scale[v * kVec + e]) : 0.f;
      acc[k][e] = 0.f;
    }
  }
  const float inv_d = 1.f / static_cast<float>(d);
  const long first = static_cast<long>(blockIdx.x) * NG +
                     (G >= 32 ? g : (tid / 32) * kRows);
  const long stride = static_cast<long>(gridDim.x) * NG;
  int par = 0;
  for (long base = first; base < rows; base += stride, par ^= 1) {
    const long r = G >= 32 ? base : base + (tid % 32) / G;
    const bool ok = r < rows;
    uint4 xraw[Kc], graw[Kc];
#pragma unroll
    for (int k = 0; k < Kc; ++k) {
      const int v = k * G + j;
      if (ok && v < nv) {
        xraw[k] = __ldg(reinterpret_cast<const uint4*>(x + r * d) + v);
        graw[k] = __ldg(reinterpret_cast<const uint4*>(dy + r * d) + v);
      }
    }
    float ss = 0.f, gx = 0.f;
#pragma unroll
    for (int k = 0; k < Kc; ++k) {
      if (ok && k * G + j < nv) {
        float xv[kVec], gv[kVec];
        unpack16(xraw[k], xv, T());
        unpack16(graw[k], gv, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          ss += xv[e] * xv[e];
          gx += gv[e] * sc[k][e] * xv[e];
        }
      }
    }
#pragma unroll
    for (int off = (G < 32 ? G : 32) / 2; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    if constexpr (W > 1) {
      float2* rg = red + (par * NG + g) * W;
      if (tid % 32 == 0) rg[j / 32] = make_float2(ss, gx);
      bar_sync(1 + g, G);
      ss = 0.f;
      gx = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float2 v = rg[w];
        ss += v.x;
        gx += v.y;
      }
    }
    const float rr = rsqrtf(ss * inv_d + eps);
    const float cf = rr * rr * (gx * inv_d);
#pragma unroll
    for (int k = 0; k < Kc; ++k) {
      const int v = k * G + j;
      if (ok && v < nv) {
        float xv[kVec], gv[kVec], out[kVec];
        unpack16(xraw[k], xv, T());
        unpack16(graw[k], gv, T());
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          out[e] = rr * (gv[e] * sc[k][e] - xv[e] * cf);
          acc[k][e] += gv[e] * xv[e] * rr;
        }
        reinterpret_cast<uint4*>(dx + r * d)[v] = pack16(out, T());
      }
    }
  }
  // the block's partial row: its groups' rows of dscale in group order
#pragma unroll
  for (int k = 0; k < Kc; ++k) {
    const int v = k * G + j;
    if (v < nv) {
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        store4(blk + g * d + v * kVec + e, &acc[k][e]);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < d; i += kBwdThreads) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < NG; ++q) s += blk[q * d + i];
    partial[static_cast<long>(blockIdx.x) * d + i] = s;
  }
}

// The generic path, any width: one warp a row, a first pass over the row
// for sum(x^2) and sum(g x), a second (from L1/L2) for dx, with each
// warp's dscale in an f32 row of shared memory; the block's partial row is
// its warps' rows in warp order.
template <typename T, typename S, bool kVec4>
__global__ void __launch_bounds__(kBwdMaxWarps * 32)
rmsnorm_bwd_generic_kernel(const T* __restrict__ x,
                           const S* __restrict__ scale,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ partial, int rows, int d,
                           float eps) {
  extern __shared__ float bwd_s[];
  float* scale_s = bwd_s;      // d floats
  float* acc_s = bwd_s + d;    // [warps][d] floats: this warp's dscale
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    scale_s[i] = to_float(scale[i]);
  }
  float* acc = acc_s + static_cast<long>(warp) * d;
  for (int i = lane; i < d; i += 32) acc[i] = 0.f;
  __syncthreads();
  const float inv_d = 1.f / static_cast<float>(d);
  for (long r = static_cast<long>(blockIdx.x) * warps + warp; r < rows;
       r += static_cast<long>(gridDim.x) * warps) {
    const T* xr = x + r * d;
    const T* dyr = dy + r * d;
    T* dxr = dx + r * d;
    float ss = 0.f, gx = 0.f;
    if constexpr (kVec4) {
      for (int i = 4 * lane; i < d; i += 128) {
        float xv[4], gv[4];
        load4(xr + i, xv);
        load4(dyr + i, gv);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ss += xv[c] * xv[c];
          gx += gv[c] * scale_s[i + c] * xv[c];
        }
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float xv = to_float(xr[i]);
        ss += xv * xv;
        gx += to_float(dyr[i]) * scale_s[i] * xv;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
      gx += __shfl_xor_sync(0xffffffffu, gx, off);
    }
    const float rr = rsqrtf(ss * inv_d + eps);
    const float c = rr * rr * (gx * inv_d);
    if constexpr (kVec4) {
      for (int i = 4 * lane; i < d; i += 128) {
        float xv[4], gv[4], out[4];
        load4(xr + i, xv);
        load4(dyr + i, gv);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          out[k] = rr * (gv[k] * scale_s[i + k] - xv[k] * c);
          acc[i + k] += gv[k] * xv[k] * rr;
        }
        store4(dxr + i, out);
      }
    } else {
      for (int i = lane; i < d; i += 32) {
        const float xv = to_float(xr[i]);
        const float gv = to_float(dyr[i]);
        dxr[i] = from_float<T>(rr * (gv * scale_s[i] - xv * c));
        acc[i] += gv * xv * rr;
      }
    }
  }
  __syncthreads();
  float* out = partial + static_cast<long>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < warps; ++w) s += acc_s[static_cast<long>(w) * d + i];
    out[i] = s;
  }
}

// dscale[i] = the partial rows summed in block order: a warp's lanes take
// 32 columns, the block's kBwdSumSegs warps the rows w, w + 32, ... each
// (8 loads a thread at 256 partial rows, all in flight at once), then the
// warps' sums are added in warp order
template <typename S>
__global__ void __launch_bounds__(kBwdSumSegs * 32)
rmsnorm_bwd_sum_kernel(const float* __restrict__ partial,
                       S* __restrict__ dscale, int blocks, int d) {
  __shared__ float seg_s[kBwdSumSegs][32];
  const int lane = threadIdx.x % 32;
  const int seg = threadIdx.x / 32;
  const int i = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (i < d) {
#pragma unroll 8
    for (int b = seg; b < blocks; b += kBwdSumSegs) {
      s += partial[static_cast<long>(b) * d + i];
    }
  }
  seg_s[seg][lane] = s;
  __syncthreads();
  if (seg == 0 && i < d) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kBwdSumSegs; ++q) t += seg_s[q][lane];
    dscale[i] = from_float<S>(t);
  }
}

template <typename T, typename S>
using RowFn = void (*)(const T*, const S*, const T*, T*, float*, int, int,
                       float);

// the row kernel for rows of d elements (a multiple of the vector, at most
// kBwdRowMax) and the lanes it gives a row
template <typename T, typename S>
RowFn<T, S> row_kernel(int d, int* lanes) {
  constexpr int kVec = 16 / sizeof(T);
  const int nvmax = bwd_row_vecs(d / kVec);
  *lanes = bwd_row_lanes(nvmax);
#define ROW_CASE(n) \
  case n:           \
    return rmsnorm_bwd_row_kernel<T, S, bwd_row_lanes(n), bwd_lane_vecs(n)>;
  switch (nvmax) {
    ROW_CASE(8)
    ROW_CASE(16)
    ROW_CASE(32)
    ROW_CASE(64)
    ROW_CASE(128)
    ROW_CASE(256)
    ROW_CASE(512)
    ROW_CASE(1024)
    default: return nullptr;
  }
#undef ROW_CASE
}

template <typename T>
bool row_path(const void* x, const void* dy, const void* dx, int d) {
  auto a16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return a16(x) && a16(dy) && a16(dx) && d % (16 / sizeof(T)) == 0 &&
         d <= kBwdRowMax;
}

template <typename T, typename S>
cudaError_t launch_bwd(const void* xv, const void* scalev, const void* dyv,
                       void* dxv, void* dscalev, float* partial, int rows,
                       int d, float eps, int blocks, int threads, int smem,
                       cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const S* scale = static_cast<const S*>(scalev);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  cudaError_t err;
  if (row_path<T>(xv, dyv, dxv, d)) {
    int lanes = 0;
    const RowFn<T, S> kernel = row_kernel<T, S>(d, &lanes);
    if (kernel == nullptr || threads != kBwdThreads ||
        smem < bwd_row_smem(d, lanes)) {
      return cudaErrorInvalidValue;
    }
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<blocks, kBwdThreads, smem, stream>>>(x, scale, dy, dx, partial,
                                                  rows, d, eps);
  } else {
    const int warps = threads / 32;
    if (threads % 32 != 0 || warps < 1 || warps > kBwdMaxWarps ||
        static_cast<long>(smem) < (warps + 1L) * d * 4) {
      return cudaErrorInvalidValue;
    }
    const bool vec4 =
        d % 4 == 0 &&
        reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0 &&
        reinterpret_cast<uintptr_t>(dy) % (4 * sizeof(T)) == 0 &&
        reinterpret_cast<uintptr_t>(dx) % (4 * sizeof(T)) == 0;
    auto kernel = vec4 ? rmsnorm_bwd_generic_kernel<T, S, true>
                       : rmsnorm_bwd_generic_kernel<T, S, false>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<blocks, threads, smem, stream>>>(x, scale, dy, dx, partial,
                                              rows, d, eps);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  rmsnorm_bwd_sum_kernel<S><<<(d + 31) / 32, kBwdSumSegs * 32, 0, stream>>>(
      partial, static_cast<S*>(dscalev), blocks, d);
  return cudaGetLastError();
}

// blocks of the row kernel for rows of d elements that fit one SM at once
template <typename T, typename S>
cudaError_t occupancy_bwd(int d, int* out) {
  int lanes = 0;
  const RowFn<T, S> kernel = row_kernel<T, S>(d, &lanes);
  if (kernel == nullptr || d % (16 / sizeof(T)) != 0 || d > kBwdRowMax) {
    return cudaErrorInvalidValue;
  }
  const int smem = bwd_row_smem(d, lanes);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel,
                                                       kBwdThreads, smem);
}

}  // namespace

// x, dy, dx: (rows, d) contiguous, x's type; scale, dscale: (d,), scale's
// type; partial: (blocks, d) f32 scratch.  Rows of at most 4096 elements,
// a multiple of the 16-byte vector, with x, dy and dx 16-byte aligned take
// the row path: `threads` must be 256 and smem at least bwd_row_smem;
// others the generic path: `threads` a multiple of 32 up to 256, smem at
// least (threads / 32 + 1) * d * 4 bytes (rmsnorm_bwd_geometry in
// repro_torch/kernels/rmsnorm/rmsnorm.py chooses alike).
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy,
                           void* dx, void* dscale, void* partial, int rows,
                           int d, float eps, int x_dtype, int scale_dtype,
                           int blocks, int threads, int smem, void* stream) {
  if (rows <= 0 || d <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  if (x_dtype == kF32 && scale_dtype == kF32)
    return launch_bwd<float, float>(x, scale, dy, dx, dscale, p, rows, d, eps,
                                    blocks, threads, smem, s);
  if (x_dtype == kBF16 && scale_dtype == kF32)
    return launch_bwd<__nv_bfloat16, float>(x, scale, dy, dx, dscale, p, rows,
                                            d, eps, blocks, threads, smem, s);
  if (x_dtype == kF32 && scale_dtype == kBF16)
    return launch_bwd<float, __nv_bfloat16>(x, scale, dy, dx, dscale, p, rows,
                                            d, eps, blocks, threads, smem, s);
  if (x_dtype == kBF16 && scale_dtype == kBF16)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, scale, dy, dx, dscale, p, rows, d, eps, blocks, threads, smem, s);
  return cudaErrorInvalidValue;
}

// out[0]: blocks of the row path's kernel for rows of d elements that fit
// one SM at once
extern "C" int rmsnorm_bwd_occupancy(int d, int x_dtype, int scale_dtype,
                                     int* out) {
  if (x_dtype == kF32 && scale_dtype == kF32)
    return occupancy_bwd<float, float>(d, out);
  if (x_dtype == kBF16 && scale_dtype == kF32)
    return occupancy_bwd<__nv_bfloat16, float>(d, out);
  if (x_dtype == kF32 && scale_dtype == kBF16)
    return occupancy_bwd<float, __nv_bfloat16>(d, out);
  if (x_dtype == kBF16 && scale_dtype == kBF16)
    return occupancy_bwd<__nv_bfloat16, __nv_bfloat16>(d, out);
  return cudaErrorInvalidValue;
}
