// Forward flash attention for Hopper (sm_90a): online softmax over K/V tiles
// staged in shared memory; the (Sq x Sk) score matrix never reaches HBM.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py (_flash_kernel, :25,
// launched by flash_attention_fwd).  Same function: f32 running max, sum
// and accumulator; scale hd**-0.5; causal mask kpos <= qpos on absolute
// positions (no offset when Sq != Sk), filled with -1e30; denominator
// clamped at 1e-30.  Causal tiles that lie wholly above the rows a block
// (or a warpgroup) still has to produce are skipped: for those rows the
// reference's update is exactly the identity (the max does not move, so
// the rescale is 1, and every probability is 0).
//
// Bound on the H100: operations.  At hd = 128 each K/V byte staged in
// shared memory feeds ~block_q * 4 flops, above the card's ridge, so the
// rate at which the SM multiplies is the limit.  Two kernels:
//
// bf16 (flash_bf16_kernel) -- the tensor cores.  S = Q K^T and O += P V
//   run on wgmma, bf16 in and f32 out: QK^T reads the Q slab and the K
//   tile (both K-major) from shared memory; P V takes P from registers,
//   rounded to bf16, and the V tile as an MN-major operand (the transpose
//   bit).  One pass per K/V tile (FA2): S once, the tile's row max, the
//   rescale of the accumulator and the sum by exp(m_old - m_new), P =
//   exp(S - m_new), O += P V.  K/V tiles arrive by TMA, swizzled as the
//   wgmma descriptors expect (128 B for hd >= 64, 64 B for hd 32), into a
//   ring of up to 4 stages guarded by mbarriers; one producer warp keeps
//   the next tiles in flight while the consumer warpgroups compute.  A
//   consumer warpgroup owns a slab of 64 query rows; block_q < 64 pads the
//   slab (TMA zero-fills rows past Sq, and only the block's own rows are
//   stored), block_q 128 to 256 is 2 to 4 slabs.  Registers, not shared
//   memory, bound the warpgroups: S (64 x block_k f32) and O (64 x hd f32)
//   live in a thread's registers, so block_k <= 128 runs 2 consumer
//   warpgroups and block_k 192 and 256 one; a warpgroup walks the block's
//   slabs in rounds, sweeping the K/V tiles once per round.
//
// f32 (flash_f32_kernel) -- the CUDA cores.  The tensor cores have no f32
//   rate that holds the f32 tolerance (TF32 keeps 10 bits), so f32 runs as
//   FMAs, fed from shared memory: each K/V tile is read from HBM once per
//   block of block_q query rows and then read block_q times from shared
//   memory with 16-byte loads that four neighbouring threads share by
//   broadcast.  Each row is owned by 4 threads, each holding hd/4 of the
//   query and accumulator in registers (dims 16*i + 4*sub + c).  Per K/V
//   tile of block_k keys, pass 1 finds the tile's row max and pass 2
//   recomputes the scores, exponentiates and accumulates.
//
// A row's arithmetic (every instruction shape, the order of every sum, the
// rounding of P) depends on block_k and hd but not on block_q, so the
// error does not depend on block_q -- the contract of ERROR_KNOBS in
// repro_torch/kernels/workloads.py; in bf16 the output is bit-identical
// across block_q.

#include "common.cuh"
#include "hopper.cuh"
#include "wgmma_ops.cuh"

#include <algorithm>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// bf16 kernel's shared memory: the slack that aligns the buffers to 1024
// bytes (128-byte swizzle atoms), the barriers, the Q slabs, the stages.
// repro_torch/kernels/flash_attention/flash_attention.py holds the same
// numbers (smem_bytes).
constexpr int kMaxStages = 4;
constexpr int kAlignSlack = 1024;
constexpr int kBarrierBytes = 128;  // full[4], empty[4], q: 8 bytes each

template <typename T, int HD, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
flash_f32_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int Sq, int Sk, int block_q,
             int block_k, float scale, int causal) {
  constexpr int kVPT = HD / 4;  // dims per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [block_k][HD]
  T* vs = ks + block_k * HD;               // [block_k][HD]

  const int row = threadIdx.x >> 2;
  const int sub = threadIdx.x & 3;
  const int q0 = blockIdx.x * block_q;
  const int qpos = q0 + row;
  const long bh = blockIdx.y;
  const T* kb = k + bh * Sk * HD;
  const T* vb = v + bh * Sk * HD;

  float qr[kVPT];
  float acc[kVPT];
  const T* qrow = q + (bh * Sq + qpos) * HD;
#pragma unroll
  for (int i = 0; i < HD / 16; ++i) {
    load4(qrow + 16 * i + 4 * sub, qr + 4 * i);
  }
#pragma unroll
  for (int i = 0; i < kVPT; ++i) acc[i] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  int n_tiles = Sk / block_k;
  if (causal) {  // tiles past the block's last query row are all masked
    n_tiles = min(n_tiles, (q0 + block_q - 1) / block_k + 1);
  }
  const int tile_chunks = block_k * HD * static_cast<int>(sizeof(T)) / 16;

  for (int t = 0; t < n_tiles; ++t) {
    const long tile0 = static_cast<long>(t) * block_k * HD;
    const uint4* ksrc = reinterpret_cast<const uint4*>(kb + tile0);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vb + tile0);
    for (int c = threadIdx.x; c < tile_chunks; c += blockDim.x) {
      reinterpret_cast<uint4*>(ks)[c] = ksrc[c];
      reinterpret_cast<uint4*>(vs)[c] = vsrc[c];
    }
    __syncthreads();

    const int k0 = t * block_k;
    // pass 1: the row max over this tile
    float m_new = m;
    for (int j = 0; j < block_k; ++j) {
      const T* kr = ks + j * HD;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < HD / 16; ++i) {
        float kv[4];
        load4(kr + 16 * i + 4 * sub, kv);
#pragma unroll
        for (int c = 0; c < 4; ++c) part += qr[4 * i + c] * kv[c];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float s = part * scale;
      if (causal && k0 + j > qpos) s = kNegInf;
      m_new = fmaxf(m_new, s);
    }
    const float alpha = expf(m - m_new);
#pragma unroll
    for (int i = 0; i < kVPT; ++i) acc[i] *= alpha;

    // pass 2: the same scores again, exponentiated and accumulated
    float psum = 0.f;
    for (int j = 0; j < block_k; ++j) {
      const T* kr = ks + j * HD;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < HD / 16; ++i) {
        float kv[4];
        load4(kr + 16 * i + 4 * sub, kv);
#pragma unroll
        for (int c = 0; c < 4; ++c) part += qr[4 * i + c] * kv[c];
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float s = part * scale;
      if (causal && k0 + j > qpos) s = kNegInf;
      const float p = expf(s - m_new);
      psum += p;
      const T* vr = vs + j * HD;
#pragma unroll
      for (int i = 0; i < HD / 16; ++i) {
        float vv[4];
        load4(vr + 16 * i + 4 * sub, vv);
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[4 * i + c] += p * vv[c];
      }
    }
    l = alpha * l + psum;
    m = m_new;
    __syncthreads();  // the next tile overwrites ks / vs
  }

  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = o + (bh * Sq + qpos) * HD;
#pragma unroll
  for (int i = 0; i < HD / 16; ++i) {
    float out[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = acc[4 * i + c] * inv;
    store4(orow + 16 * i + 4 * sub, out);
  }
  // the row's log-sum-exp of the scaled scores, for the backward
  if (lse != nullptr && sub == 0) lse[bh * Sq + qpos] = m + logf(l);
}


__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Consumer warpgroups of a block_k: S (block_k / 2 f32 a thread), O (hd / 2)
// and P (block_k / 4) must fit a thread's registers at the launch bound.
template <int BK>
constexpr int max_warpgroups() {
  return BK <= 128 ? 2 : 1;
}

template <int HD, int BK, int kWG>
__global__ void __launch_bounds__(kWG * 128 + 32, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int Sq, int Sk, int block_q, float scale, int causal,
                  int stages) {
  // a panel is one swizzle width of columns (64 bf16 = 128 B, or 32 = 64 B)
  constexpr int kPanelCols = HD >= 64 ? 64 : 32;
  constexpr uint32_t kRowBytes = 2 * kPanelCols;
  constexpr int kPanels = HD / kPanelCols;
  constexpr int kStepsPerPanel = kPanelCols / 16;  // k-steps of 16 columns
  constexpr uint64_t kLayout = HD >= 64 ? kSwizzle128B : kSwizzle64B;
  constexpr uint32_t kSbo16 = 8 * kRowBytes / 16;  // 8 rows, 16-byte units
  constexpr uint32_t kSlabBytes = 64 * HD * 2;
  constexpr uint32_t kQPanelBytes = 64 * kRowBytes;
  constexpr uint32_t kTileBytes = BK * HD * 2;  // one K or V tile
  constexpr uint32_t kKVPanelBytes = BK * kRowBytes;

  extern __shared__ __align__(1024) unsigned char smem_bf16[];
  const uint32_t base = (smem_addr(smem_bf16) + 1023u) & ~1023u;
  const int nslab = (block_q + 63) / 64;
  const uint32_t q_s = base;
  const uint32_t kv_s = q_s + nslab * kSlabBytes;
  const uint32_t bars = kv_s + stages * 2 * kTileBytes;
  const uint32_t q_bar = bars + 16 * kMaxStages;
  auto full_bar = [&](int i) { return bars + 8 * i; };
  auto empty_bar = [&](int i) { return bars + 8 * (kMaxStages + i); };

  const int nwg = (blockDim.x - 32) / 128;  // consumer warpgroups
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full_bar(i), 1);            // the producer's arrival + bytes
      mbar_init(empty_bar(i), nwg * 4);     // one arrival per consumer warp
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // the blocks with the most causal tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * block_q;
  const int bh = blockIdx.y;
  const int rounds = (nslab + nwg - 1) / nwg;
  // K/V tiles of round r: up to the last row the round stores
  auto round_tiles = [&](int r) {
    const int last = min(q0 + (r + 1) * nwg * 64, q0 + block_q) - 1;
    const int all = Sk / BK;
    return causal ? min(all, last / BK + 1) : all;
  };

  if (warp == nwg * 4) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(q_bar, nslab * kSlabBytes);
      for (int j = 0; j < nslab; ++j) {
        for (int p = 0; p < kPanels; ++p) {
          tma_load_3d(q_s + j * kSlabBytes + p * kQPanelBytes, &tm_q, q_bar,
                      p * kPanelCols, q0 + 64 * j, bh);
        }
      }
      int it = 0;
      for (int r = 0; r < rounds; ++r) {
        const int n = round_tiles(r);
        for (int t = 0; t < n; ++t, ++it) {
          const int stage = it % stages;
          const uint32_t use = it / stages;
          mbar_wait(empty_bar(stage), (use & 1) ^ 1);  // use 0: at once
          mbar_arrive_expect_tx(full_bar(stage), 2 * kTileBytes);
          const uint32_t ks = kv_s + stage * 2 * kTileBytes;
          for (int p = 0; p < kPanels; ++p) {
            tma_load_3d(ks + p * kKVPanelBytes, &tm_k, full_bar(stage),
                        p * kPanelCols, t * BK, bh);
            tma_load_3d(ks + kTileBytes + p * kKVPanelBytes, &tm_v,
                        full_bar(stage), p * kPanelCols, t * BK, bh);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg, this thread's rows wrow and wrow + 8 of a slab
  const int wg = warp / 4;
  const int wrow = (warp % 4) * 16 + lane / 4;
  const int quad = lane % 4;
  __nv_bfloat16* ob = o + static_cast<long>(bh) * Sq * HD;
  mbar_wait(q_bar, 0);
  int it = 0;
  for (int r = 0; r < rounds; ++r) {
    const int j = r * nwg + wg;
    const bool active = j < nslab;
    const int s0 = q0 + 64 * j;
    const int slab_last = min(s0 + 63, q0 + block_q - 1);
    const int row0 = s0 + wrow;
    const int row1 = row0 + 8;
    const uint32_t q_slab = q_s + j * kSlabBytes;
    const int n = round_tiles(r);

    float acc[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    // Tiles [0, n_c) are computed; the rest of the round's tiles (wholly
    // above this slab's rows, or all of them for a warpgroup without a
    // slab this round) are only passed on to the producer.
    const int n_c = !active ? 0 : causal ? min(n, slab_last / BK + 1) : n;
    auto stage_of = [&](int t) { return (it + t) % stages; };
    auto parity_of = [&](int t) { return ((it + t) / stages) & 1; };
    auto release = [&](int t) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar(stage_of(t)));
    };

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    for (int t = 0; t < n_c; ++t) {
      mbar_wait(full_bar(stage_of(t)), parity_of(t));
      const uint32_t ks = kv_s + stage_of(t) * 2 * kTileBytes;
      const uint32_t vs = ks + kTileBytes;

      // S = Q K^T, k-steps of 16 head dims
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % kStepsPerPanel) * 32;
        const int p = kk / kStepsPerPanel;
        WgmmaSS<BK>::mma(
            s, gmma_desc(q_slab + p * kQPanelBytes + col, 1, kSbo16, kLayout),
            gmma_desc(ks + p * kKVPanelBytes + col, 1, kSbo16, kLayout),
            kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      const int k0 = t * BK;

      // scale, mask, the tile's row max (the 4 threads of a row)
      const bool mask = causal && k0 + BK - 1 > s0;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int g = 0; g < BK / 8; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[4 * g + e] * scale;
          const int kpos = k0 + 8 * g + 2 * quad + (e & 1);
          if (mask && kpos > ((e & 2) ? row1 : row0)) v = kNegInf;
          s[4 * g + e] = v;
        }
        mx0 = fmaxf(mx0, fmaxf(s[4 * g], s[4 * g + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * g + 2], s[4 * g + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0);
      const float mn1 = fmaxf(m1, mx1);
      // exactly 1 when the max does not move (a masked tile's identity)
      const float a0 = mn0 == m0 ? 1.f : exp2f((m0 - mn0) * kLog2e);
      const float a1 = mn1 == m1 ? 1.f : exp2f((m1 - mn1) * kLog2e);

      // P = exp(S - m_new): its f32 row sum, and bf16 pairs laid out as
      // wgmma's register operand A (m64k16: rows r, r + 8; columns
      // 2q, 2q + 1 and 2q + 8, 2q + 9 of each 16)
      float ps0 = 0.f, ps1 = 0.f;
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int g = 0; g < BK / 8; ++g) {
        const float p0 = exp2f((s[4 * g] - mn0) * kLog2e);
        const float p1 = exp2f((s[4 * g + 1] - mn0) * kLog2e);
        const float p2 = exp2f((s[4 * g + 2] - mn1) * kLog2e);
        const float p3 = exp2f((s[4 * g + 3] - mn1) * kLog2e);
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        pa[g / 2][(g % 2) * 2] = pack_bf16(p0, p1);
        pa[g / 2][(g % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = a0 * l0 + ps0;
      l1 = a1 * l1 + ps1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int g = 0; g < HD / 8; ++g) {
        acc[4 * g] *= a0;
        acc[4 * g + 1] *= a0;
        acc[4 * g + 2] *= a1;
        acc[4 * g + 3] *= a1;
      }

      // O += P V, k-steps of 16 keys; V's panels are LBO apart along hd
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        WgmmaRS<HD>::mma(acc, pa[kk],
                         gmma_desc(vs + kk * 16 * kRowBytes,
                                   kKVPanelBytes / 16, kSbo16, kLayout),
                         1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      release(t);
    }
    for (int t = n_c; t < n; ++t) {
      mbar_wait(full_bar(stage_of(t)), parity_of(t));
      release(t);
    }
    it += n;

    if (active) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f);
      const float inv1 = 1.f / fmaxf(l1, 1e-30f);
      const int end = q0 + block_q;  // the block's own rows only
#pragma unroll
      for (int g = 0; g < HD / 8; ++g) {
        const int col = 8 * g + 2 * quad;
        if (row0 < end) {
          *reinterpret_cast<__nv_bfloat162*>(ob + row0 * HD + col) =
              __floats2bfloat162_rn(acc[4 * g] * inv0, acc[4 * g + 1] * inv0);
        }
        if (row1 < end) {
          *reinterpret_cast<__nv_bfloat162*>(ob + row1 * HD + col) =
              __floats2bfloat162_rn(acc[4 * g + 2] * inv1,
                                    acc[4 * g + 3] * inv1);
        }
      }
      if (lse != nullptr && quad == 0) {  // log-sum-exp, for the backward
        float* lb = lse + static_cast<long>(bh) * Sq;
        if (row0 < end) lb[row0] = m0 + logf(l0);
        if (row1 < end) lb[row1] = m1 + logf(l1);
      }
    }
  }
}

template <int HD, int kMaxThreads>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int BH, int Sq, int Sk, int block_q,
                       int block_k, float scale, int causal, int smem,
                       cudaStream_t stream) {
  auto kernel = flash_f32_kernel<float, HD, kMaxThreads>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / block_q, BH);
  kernel<<<grid, block_q * 4, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk,
      block_q, block_k, scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32_threads(const void* q, const void* k, const void* v,
                               void* o, float* lse, int BH, int Sq, int Sk,
                               int block_q, int block_k, float scale,
                               int causal, int smem, cudaStream_t stream) {
  // a 512-thread bound leaves 128 registers a thread (no spills at hd 128);
  // block_q > 128 needs the 1024-thread bound, and so 64 registers
  if (block_q * 4 <= 512)
    return launch_f32<HD, 512>(q, k, v, o, lse, BH, Sq, Sk, block_q, block_k,
                               scale, causal, smem, stream);
  return launch_f32<HD, 1024>(q, k, v, o, lse, BH, Sq, Sk, block_q, block_k,
                              scale, causal, smem, stream);
}

cudaError_t launch_f32_hd(int hd, const void* q, const void* k, const void* v,
                          void* o, float* lse, int BH, int Sq, int Sk,
                          int block_q, int block_k, float scale, int causal,
                          int smem, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_f32_threads<32>(q, k, v, o, lse, BH, Sq, Sk, block_q,
                                    block_k, scale, causal, smem, stream);
    case 64:
      return launch_f32_threads<64>(q, k, v, o, lse, BH, Sq, Sk, block_q,
                                    block_k, scale, causal, smem, stream);
    case 128:
      return launch_f32_threads<128>(q, k, v, o, lse, BH, Sq, Sk, block_q,
                                     block_k, scale, causal, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int HD, int BK>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int BH, int Sq, int Sk, int block_q,
                        float scale, int causal, int smem,
                        cudaStream_t stream) {
  constexpr int kWG = max_warpgroups<BK>();
  constexpr int kPanelCols = HD >= 64 ? 64 : 32;
  const int nslab = (block_q + 63) / 64;
  const int q_bytes = nslab * 64 * HD * 2;
  const int stage_bytes = 2 * BK * HD * 2;
  const int stages = std::min(
      kMaxStages, (smem - kAlignSlack - kBarrierBytes - q_bytes) / stage_bytes);
  if (stages < 1) return cudaErrorInvalidValue;
  const CUtensorMapSwizzle swizzle =
      HD >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_bf16_3d(&tm_q, q, HD, Sq, BH, kPanelCols, 64, swizzle) ||
      !encode_bf16_3d(&tm_k, k, HD, Sk, BH, kPanelCols, BK, swizzle) ||
      !encode_bf16_3d(&tm_v, v, HD, Sk, BH, kPanelCols, BK, swizzle)) {
    return cudaErrorInvalidValue;
  }
  auto kernel = flash_bf16_kernel<HD, BK, kWG>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int nwg = std::min(nslab, kWG);
  dim3 grid(Sq / block_q, BH);
  kernel<<<grid, nwg * 128 + 32, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, Sq, Sk, block_q,
      scale, causal, stages);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_bf16_bk(int block_k, const void* q, const void* k,
                           const void* v, void* o, float* lse, int BH, int Sq,
                           int Sk, int block_q, float scale, int causal,
                           int smem, cudaStream_t stream) {
#define REPRO_FLASH_BK(BK)                                                 \
  case BK:                                                                 \
    return launch_bf16<HD, BK>(q, k, v, o, lse, BH, Sq, Sk, block_q,       \
                               scale, causal, smem, stream);
  switch (block_k) {
    REPRO_FLASH_BK(16)
    REPRO_FLASH_BK(32)
    REPRO_FLASH_BK(48)
    REPRO_FLASH_BK(64)
    REPRO_FLASH_BK(128)
    REPRO_FLASH_BK(192)
    REPRO_FLASH_BK(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_BK
}

cudaError_t launch_bf16_hd(int hd, int block_k, const void* q, const void* k,
                           const void* v, void* o, float* lse, int BH, int Sq,
                           int Sk, int block_q, float scale, int causal,
                           int smem, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_bf16_bk<32>(block_k, q, k, v, o, lse, BH, Sq, Sk, block_q,
                                scale, causal, smem, stream);
    case 64:
      return launch_bf16_bk<64>(block_k, q, k, v, o, lse, BH, Sq, Sk, block_q,
                                scale, causal, smem, stream);
    case 128:
      return launch_bf16_bk<128>(block_k, q, k, v, o, lse, BH, Sq, Sk,
                                 block_q, scale, causal, smem, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Backward (no TPU counterpart: the reference leaves the gradient of its
// jnp attention, src/repro/kernels/flash_attention/ref.py attention_ref, to
// XLA; here the forward is this kernel, so its gradient is one too).  With
// P = exp(s Q K^T - lse) recomputed from the forward's log-sum-exp and
// D = rowsum(dO o O):
//   dS = P o (dO V^T - D),  dV = P^T dO,  dK = s dS^T Q,  dQ = s dS K.
// Bound on the H100: operations (five products of Sq x Sk x hd, the causal
// half of them, against 4 tensors of Sq x hd read and 3 written).  No float
// atomics: every output element is summed by one block in a fixed order, so
// two calls give the same bits.
//
// bf16 -- the tensor cores, after the backward of FA2/FA3, in two passes:
// * flash_bwd_rows_kernel: lse * log2(e) and D of every row, one warp a
//   row, into a scratch padded to whole blocks of rows; padding rows get
//   lse = +inf, so their P is exactly 0, and D = 0;
// * flash_bwd_dkdv_bf16_kernel: a block per (bh, 128 keys), one consumer
//   warpgroup per 64 keys.  K and V arrive once by TMA; the 64-row query
//   tiles (Q, dO, lse, D) stream through a ring of kBwdStages stages that a
//   producer fills (TMA, mbarriers).  Per tile, S^T = K Q^T and then
//   dP^T = V dO^T on wgmma (both operands in shared memory, a commit group
//   each, so P^T is formed while dP^T runs), dS^T in registers, then
//   dV += P^T dO and dK += dS^T Q on wgmma with P^T and dS^T, rounded to
//   bf16, as the register operand and the Q and dO tiles read MN-major: P
//   and dS never touch shared memory;
// * flash_bwd_dq_bf16_kernel: a block per (bh, 128 query rows), one
//   warpgroup per 64 rows, with Q, dO, lse and D loaded once and the 64-key
//   K/V tiles streaming through the ring: S = Q K^T and dP = dO V^T (a
//   group each), dQ += dS K (dS from registers, K read MN-major).  A tile's
//   dQ product runs on while the next tile's S and dP are issued; its stage
//   is released once they are done.
// Seven products where the bound counts five (S and dP are formed in both
// passes), so the design's floor is 7/5 of the bound.  A single pass would
// have to sum dQ across the key blocks: by float atomics (other bits each
// call) or by per-block partials summed afterwards (Sk / 128 times dQ's
// bytes through HBM).  The second pass spends operations, which the tensor
// cores have, and keeps every sum in one order.  Causal tiles wholly above
// the diagonal are skipped, and only tiles that cross the diagonal or the
// end of the keys are masked.  The grid's x is (batch, head) and its y the
// block's tile, taken so that the blocks with the most tiles start first
// across every head.  P's exponentials run on the ex2 unit
// (ex2.approx.ftz, one MUFU.EX2 each): beside the tensor cores, the
// softmax's arithmetic is what a tile waits on.
// A thread of a dK/dV warpgroup holds hd / 2 f32 of dK and of dV plus 32 of
// S^T and of dP^T, 192 at hd 128: more than the 168 a thread that 384
// threads (or 288: nine warps sit 3/2/2/2 on the SM's four register files)
// get at launch.  So a block is two consumer warpgroups and a producer
// warpgroup, one thread of which issues the loads: setmaxnreg moves the
// producer's registers to the consumers (40 and 232), one block an SM.
// Holding P^T's bf16 registers while dS^T is formed, or a second S/dP
// buffer, does not fit that: ptxas spills and serializes the wgmma.
// Q, K, V and dO rows past Sq or Sk arrive as zeros.
//
// f32 -- the CUDA cores, the first version of the backward.  The tensor
// cores' only f32 path is TF32 (10 bits of mantissa), which misses the f32
// tolerance, so f32 stays on three kernels:
// * flash_bwd_delta_kernel: D, one warp a row;
// * flash_bwd_dkdv_kernel: a block per (bh, 64-key tile) walks the 64-row
//   query tiles from the causal start, recomputes P and dS for the tile
//   pair and accumulates dK and dV in registers;
// * flash_bwd_dq_kernel: a block per (bh, 64-row query tile) walks the key
//   tiles up to the causal end and accumulates dQ in registers.
// The tiles are converted to f32 in shared memory (rows padded by one
// float, so the 16 threads that read 16 rows hit 16 banks), and each of
// 256 threads owns a 4 x 4 block of the 64 x 64 scores (rows t / 16 + 16 i,
// columns t % 16 + 16 j) and 4 rows x hd / 16 columns of its accumulator.
// Rows past Sq or Sk are loaded as zeros and masked out of P, so any
// sequence lengths work; keys past the causal diagonal get P = 0.
// ---------------------------------------------------------------------------

constexpr int kBwdTile = 64;
constexpr int kBwdThreads = 256;

// dynamic shared memory of both f32 backward kernels (bwd_smem_bytes in
// repro_torch/kernels/flash_attention/flash_attention.py computes the same)
__host__ __device__ constexpr int bwd_f32_smem_bytes(int hd) {
  return (4 * kBwdTile * (hd + 1) + 2 * kBwdTile * (kBwdTile + 1) +
          2 * kBwdTile) * 4;
}

template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta, long rows,
                                       int hd) {
  const long r = static_cast<long>(blockIdx.x) * (blockDim.x / 32) +
                 threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float acc = 0.f;
  for (int c = lane; c < hd; c += 32) {
    acc += to_float(o[r * hd + c]) * to_float(dout[r * hd + c]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) delta[r] = acc;
}

// rows [row0, row0 + 64) of a (rows, HD) matrix of T into a shared tile of
// f32 rows of HD + 1; rows past `rows` are zeros
template <typename T, int HD>
__device__ __forceinline__ void bwd_load_tile(float* dst,
                                              const T* __restrict__ src,
                                              int row0, int rows) {
  for (int i = threadIdx.x; i < kBwdTile * HD; i += kBwdThreads) {
    const int r = i / HD, c = i % HD;
    dst[r * (HD + 1) + c] =
        row0 + r < rows ? to_float(src[static_cast<long>(row0 + r) * HD + c])
                        : 0.f;
  }
}

// P and dS of one (query tile, key tile) pair into shared memory,
// [query][key] with rows of 65: s = Q K^T, dp = dO V^T over the head dim,
// P = exp(scale s - lse) where the pair is in range and unmasked, else 0,
// dS = P (dp - D)
template <int HD>
__device__ __forceinline__ void bwd_scores(
    const float* qs, const float* ks, const float* dos, const float* vs,
    const float* lse_s, const float* delta_s, float* ps, float* dss, int q0,
    int k0, int Sq, int Sk, float scale, int causal) {
  constexpr int st = HD + 1;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  }
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], b[4], g[4], w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty + 16 * i) * st + d];
      g[i] = dos[(ty + 16 * i) * st + d];
      b[i] = ks[(tx + 16 * i) * st + d];
      w[i] = vs[(tx + 16 * i) * st + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += a[i] * b[j];
        dp[i][j] += g[i] * w[j];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = ty + 16 * i, qpos = q0 + qi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = tx + 16 * j, kpos = k0 + kj;
      const bool live = qpos < Sq && kpos < Sk && !(causal && kpos > qpos);
      const float p = live ? expf(s[i][j] * scale - lse_s[qi]) : 0.f;
      ps[qi * (kBwdTile + 1) + kj] = p;
      dss[qi * (kBwdTile + 1) + kj] = p * (dp[i][j] - delta_s[qi]);
    }
  }
}

// the block's shared memory: Q, dO, K, V tiles, then P and dS, then lse
// and D of the query tile
struct BwdSmem {
  float *qs, *dos, *ks, *vs, *ps, *dss, *lse, *delta;
  template <int HD>
  __device__ static BwdSmem make(float* base) {
    constexpr int tile = kBwdTile * (HD + 1);
    constexpr int pt = kBwdTile * (kBwdTile + 1);
    BwdSmem m;
    m.qs = base;
    m.dos = base + tile;
    m.ks = base + 2 * tile;
    m.vs = base + 3 * tile;
    m.ps = base + 4 * tile;
    m.dss = m.ps + pt;
    m.lse = m.dss + pt;
    m.delta = m.lse + kBwdTile;
    return m;
  }
};

// lse and D of the query tile's rows (0 past Sq)
__device__ __forceinline__ void bwd_load_rows(const BwdSmem& m,
                                              const float* lse,
                                              const float* delta, int q0,
                                              int Sq) {
  for (int i = threadIdx.x; i < kBwdTile; i += kBwdThreads) {
    const bool in = q0 + i < Sq;
    m.lse[i] = in ? lse[q0 + i] : 0.f;
    m.delta[i] = in ? delta[q0 + i] : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, float scale,
                      int causal) {
  constexpr int st = HD + 1;
  constexpr int kCols = HD / 16;  // accumulator columns a thread
  extern __shared__ __align__(16) float bwd_smem[];
  const BwdSmem m = BwdSmem::make<HD>(bwd_smem);
  const long bh = blockIdx.y;
  const int k0 = blockIdx.x * kBwdTile;  // the heaviest tiles come first
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const T* qb = q + bh * Sq * HD;
  const T* dob = dout + bh * Sq * HD;
  bwd_load_tile<T, HD>(m.ks, k + bh * Sk * HD, k0, Sk);
  bwd_load_tile<T, HD>(m.vs, v + bh * Sk * HD, k0, Sk);
  float dka[4][kCols], dva[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dka[i][c] = dva[i][c] = 0.f;
  }
  const int first = causal ? k0 / kBwdTile : 0;
  const int tiles = (Sq + kBwdTile - 1) / kBwdTile;
  for (int t = first; t < tiles; ++t) {
    const int q0 = t * kBwdTile;
    __syncthreads();  // the previous tile's Q, dO, P, dS are used up
    bwd_load_tile<T, HD>(m.qs, qb, q0, Sq);
    bwd_load_tile<T, HD>(m.dos, dob, q0, Sq);
    bwd_load_rows(m, lse + bh * Sq, delta + bh * Sq, q0, Sq);
    __syncthreads();
    bwd_scores<HD>(m.qs, m.ks, m.dos, m.vs, m.lse, m.delta, m.ps, m.dss, q0,
                   k0, Sq, Sk, scale, causal);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the tile's 64 query rows
    for (int r = 0; r < kBwdTile; ++r) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = m.ps[r * (kBwdTile + 1) + ty + 16 * i];
        ds[i] = m.dss[r * (kBwdTile + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float g = m.dos[r * st + tx + 16 * c];
        const float a = m.qs[r * st + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dva[i][c] += p[i] * g;
          dka[i][c] += ds[i] * a;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const long at = (bh * Sk + row) * HD + tx + 16 * c;
      dk[at] = from_float<T>(dka[i][c] * scale);
      dv[at] = from_float<T>(dva[i][c]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Sq, int Sk, float scale, int causal) {
  constexpr int st = HD + 1;
  constexpr int kCols = HD / 16;
  extern __shared__ __align__(16) float bwd_smem[];
  const BwdSmem m = BwdSmem::make<HD>(bwd_smem);
  const long bh = blockIdx.y;
  // the query tiles with the most causal key tiles start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBwdTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  bwd_load_tile<T, HD>(m.qs, q + bh * Sq * HD, q0, Sq);
  bwd_load_tile<T, HD>(m.dos, dout + bh * Sq * HD, q0, Sq);
  bwd_load_rows(m, lse + bh * Sq, delta + bh * Sq, q0, Sq);
  float dqa[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) dqa[i][c] = 0.f;
  }
  int tiles = (Sk + kBwdTile - 1) / kBwdTile;
  if (causal) {  // key tiles past the tile's last row are all masked
    tiles = min(tiles, (min(q0 + kBwdTile, Sq) - 1) / kBwdTile + 1);
  }
  const T* kb = k + bh * Sk * HD;
  const T* vb = v + bh * Sk * HD;
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kBwdTile;
    __syncthreads();  // the previous tile's K, V, dS are used up
    bwd_load_tile<T, HD>(m.ks, kb, k0, Sk);
    bwd_load_tile<T, HD>(m.vs, vb, k0, Sk);
    __syncthreads();
    bwd_scores<HD>(m.qs, m.ks, m.dos, m.vs, m.lse, m.delta, m.ps, m.dss, q0,
                   k0, Sq, Sk, scale, causal);
    __syncthreads();
    // dQ += dS K over the tile's 64 keys
    for (int r = 0; r < kBwdTile; ++r) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ds[i] = m.dss[(ty + 16 * i) * (kBwdTile + 1) + r];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float b = m.ks[r * st + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dqa[i][c] += ds[i] * b;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dq[(bh * Sq + row) * HD + tx + 16 * c] =
          from_float<T>(dqa[i][c] * scale);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* delta, void* dq, void* dk, void* dv, int BH,
                       int Sq, int Sk, float scale, int causal, int smem,
                       cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const long rows = static_cast<long>(BH) * Sq;
  flash_bwd_delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), dot, delta, rows, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto dkdv = flash_bwd_dkdv_kernel<T, HD>;
  auto dqk = flash_bwd_dq_kernel<T, HD>;
  if ((err = allow_smem(dkdv, smem)) != cudaSuccess) return err;
  if ((err = allow_smem(dqk, smem)) != cudaSuccess) return err;
  dkdv<<<dim3((Sk + kBwdTile - 1) / kBwdTile, BH), kBwdThreads, smem,
         stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dk),
                   static_cast<T*>(dv), Sq, Sk, scale, causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dqk<<<dim3((Sq + kBwdTile - 1) / kBwdTile, BH), kBwdThreads, smem,
        stream>>>(qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), Sq, Sk,
                  scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_bwd_f32_hd(int hd, const void* q, const void* k,
                              const void* v, const void* o, const void* dout,
                              const float* lse, float* delta, void* dq,
                              void* dk, void* dv, int BH, int Sq, int Sk,
                              float scale, int causal, int smem,
                              cudaStream_t stream) {
  switch (hd) {
#define REPRO_FLASH_BWD_HD(HD)                                              \
  case HD:                                                                  \
    if (smem < bwd_f32_smem_bytes(HD)) return cudaErrorInvalidValue;        \
    return launch_bwd<float, HD>(q, k, v, o, dout, lse, delta, dq, dk, dv,  \
                                 BH, Sq, Sk, scale, causal, smem, stream);
    REPRO_FLASH_BWD_HD(32)
    REPRO_FLASH_BWD_HD(64)
    REPRO_FLASH_BWD_HD(128)
#undef REPRO_FLASH_BWD_HD
    default:
      return cudaErrorInvalidValue;
  }
}

// -- bf16 backward on the tensor cores ---------------------------------------

constexpr int kBwdWG = 2;                      // consumer warpgroups a block
constexpr int kBwdThreadsBF16 = (kBwdWG + 1) * 128;  // and the producer's
constexpr int kBwdBlock = kBwdWG * kBwdTile;   // rows a block owns
// registers a thread after setmaxnreg: the producer warpgroup keeps 40,
// the consumers take 232 (2 x 128 x 232 + 128 x 40 <= 65,536); at launch,
// 384 threads have 168 each
constexpr int kBwdProducerRegs = 40;
constexpr int kBwdConsumerRegs = 232;
static_assert(kBwdWG * 128 * kBwdConsumerRegs + 128 * kBwdProducerRegs <=
                  65536,
              "the register file");
constexpr int kBwdStages = 3;                  // ring stages of streamed tiles
constexpr int kBwdRowBytes = 2 * kBwdTile * 4; // lse and D of one tile

// dynamic shared memory of both bf16 backward kernels (bwd_smem_bytes in
// repro_torch/kernels/flash_attention/flash_attention.py computes the same):
// the alignment slack, the barriers, the block's own four 64-row slabs (K
// and V, or Q and dO), and kBwdStages stages of two 64-row slabs each with
// their lse and D rows (the dQ pass keeps its own 128 rows' there)
__host__ __device__ constexpr int bwd_bf16_smem_bytes(int hd) {
  return kAlignSlack + kBarrierBytes + 2 * kBwdWG * kBwdTile * hd * 2 +
         kBwdStages * (2 * kBwdTile * hd * 2 + kBwdRowBytes);
}
static_assert(kBwdStages * kBwdRowBytes >= 2 * kBwdBlock * 4,
              "the row region holds the dQ block's lse and D");
static_assert(8 * (2 * kBwdStages + 1) <= kBarrierBytes, "barriers");

// rows of one (batch, head) in the lse/D scratch: Sq rounded up to blocks
__host__ __device__ constexpr int bwd_padded_rows(int Sq) {
  return (Sq + kBwdBlock - 1) / kBwdBlock * kBwdBlock;
}

// rows: (2, BH, Sqp) f32, lse * log2(e) then D = rowsum(o * dO); rows past
// Sq get +inf (their P is exactly 0) and 0
__global__ void flash_bwd_rows_kernel(const __nv_bfloat16* __restrict__ o,
                                      const __nv_bfloat16* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      float* __restrict__ rows, int BH,
                                      int Sq, int Sqp, int hd) {
  const long r = static_cast<long>(blockIdx.x) * (blockDim.x / 32) +
                 threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long n = static_cast<long>(BH) * Sqp;
  if (r >= n) return;
  const int bh = static_cast<int>(r / Sqp);
  const int i = static_cast<int>(r % Sqp);
  float acc = 0.f;
  float l2 = __int_as_float(0x7f800000);
  if (i < Sq) {
    const long at = (static_cast<long>(bh) * Sq + i) * hd;
    for (int c = 4 * lane; c < hd; c += 128) {
      float a[4], b[4];
      load4(o + at + c, a);
      load4(dout + at + c, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc += a[e] * b[e];
    }
    l2 = lse[static_cast<long>(bh) * Sq + i] * kLog2e;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0) {
    rows[r] = l2;
    rows[n + r] = acc;
  }
}

// 64-row slabs of a (BH, S, HD) bf16 tensor in shared memory, as TMA
// writes them: HD / kPanelCols panels of 64 rows, each row one swizzle
// width (128 B for hd >= 64, 64 B for hd 32), and their wgmma descriptors
template <int HD>
struct BwdSlab {
  static constexpr int kPanelCols = HD >= 64 ? 64 : 32;
  static constexpr uint32_t kRowBytes = 2 * kPanelCols;
  static constexpr int kPanels = HD / kPanelCols;
  static constexpr int kStepsPerPanel = kPanelCols / 16;
  static constexpr uint64_t kLayout = HD >= 64 ? kSwizzle128B : kSwizzle64B;
  static constexpr uint32_t kSbo16 = 8 * kRowBytes / 16;
  static constexpr uint32_t kPanel = kBwdTile * kRowBytes;
  static constexpr uint32_t kBytes = kBwdTile * HD * 2;

  __device__ static void load(uint32_t dst, const CUtensorMap* map,
                              uint32_t bar, int row0, int bh) {
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
      tma_load_3d(dst + p * kPanel, map, bar, p * kPanelCols, row0, bh);
    }
  }
  // k-step kk (16 head dims) read K-major: operand A, or B with N = 64 rows
  __device__ static uint64_t kmajor(uint32_t slab, int kk) {
    return gmma_desc(slab + (kk / kStepsPerPanel) * kPanel +
                         (kk % kStepsPerPanel) * 32,
                     1, kSbo16, kLayout);
  }
  // k-step kk (16 rows) read MN-major: operand B with N = HD; the panels
  // are LBO apart along the head dim
  __device__ static uint64_t mnmajor(uint32_t slab, int kk) {
    return gmma_desc(slab + kk * 16 * kRowBytes, kPanel / 16, kSbo16,
                     kLayout);
  }
};

// the shared memory of a bf16 backward block: the block's own slabs, the
// ring of streamed slabs, the lse/D rows, the barriers (full and empty per
// stage, one for the own slabs), initialised by thread 0
struct BwdRing {
  uint32_t own, ring, rows, bars;
  const float* rows_p;  // the lse/D rows through a generic pointer
  __device__ uint32_t full(int i) const { return bars + 8 * i; }
  __device__ uint32_t empty(int i) const {
    return bars + 8 * (kBwdStages + i);
  }
  __device__ uint32_t own_bar() const { return bars + 16 * kBwdStages; }

  template <int HD>
  __device__ static BwdRing make(unsigned char* raw) {
    constexpr uint32_t slab = BwdSlab<HD>::kBytes;
    BwdRing m;
    const uint32_t raw_s = smem_addr(raw);
    m.own = (raw_s + 1023u) & ~1023u;
    m.ring = m.own + 2 * kBwdWG * slab;
    m.rows = m.ring + kBwdStages * 2 * slab;
    m.bars = m.rows + kBwdStages * kBwdRowBytes;
    m.rows_p = reinterpret_cast<const float*>(raw + (m.rows - raw_s));
    if (threadIdx.x == 0) {
      for (int i = 0; i < kBwdStages; ++i) {
        mbar_init(m.full(i), 1);             // the producer's arrival + bytes
        mbar_init(m.empty(i), kBwdWG * 4);   // one arrival per consumer warp
      }
      mbar_init(m.own_bar(), 1);
      mbar_fence_init();
    }
    __syncthreads();
    return m;
  }
};

// One 64 x 64 tile in a warpgroup's accumulator layout (element e of
// column group g: row wrow + 8 (e >> 1), column 8 g + 2 quad + (e & 1)) as
// the bf16 register operand A of a product over its columns (m64k16: k-step
// kk in a[kk], rows r, r + 8, columns 2q, 2q + 1, 2q + 8, 2q + 9)
__device__ __forceinline__ void bwd_pack(const float (&x)[32],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    a[g / 2][(g % 2) * 2] = pack_bf16(x[4 * g], x[4 * g + 1]);
    a[g / 2][(g % 2) * 2 + 1] = pack_bf16(x[4 * g + 2], x[4 * g + 3]);
  }
}

// 2^v on the ex2 unit (one MUFU.EX2; -inf gives 0, subnormals flush)
__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// P = exp2(s sl2 - lse2) of a tile, in place; lse2(g, e) gives the
// element's query row's lse * log2(e), and where `mask`, dead(g, e) sets P
// to 0
template <class Lse, class Dead>
__device__ __forceinline__ void bwd_p(float (&s)[32], float sl2, bool mask,
                                      Lse lse2, Dead dead) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(s[4 * g + e] * sl2 - lse2(g, e));
      s[4 * g + e] = mask && dead(g, e) ? 0.f : p;
    }
  }
}

// dS = P (dP - D) of a tile, in place in dp; delta(g, e) gives the
// element's query row's D
template <class Delta>
__device__ __forceinline__ void bwd_ds(const float (&p)[32], float (&dp)[32],
                                       Delta delta) {
#pragma unroll
  for (int g = 0; g < 8; ++g) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dp[4 * g + e] = p[4 * g + e] * (dp[4 * g + e] - delta(g, e));
    }
  }
}

// the f32 accumulator rows wrow and wrow + 8 of a warpgroup's 64-row slab
// (rows r0, r1 of the (BH, S, HD) output), times `mul`, as bf16 pairs
template <int HD>
__device__ __forceinline__ void bwd_store(__nv_bfloat16* out,
                                          const float (&acc)[HD / 2],
                                          float mul, int r0, int rows,
                                          int quad) {
#pragma unroll
  for (int g = 0; g < HD / 8; ++g) {
    const int col = 8 * g + 2 * quad;
    if (r0 < rows) {
      *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long>(r0) * HD +
                                         col) =
          __floats2bfloat162_rn(acc[4 * g] * mul, acc[4 * g + 1] * mul);
    }
    if (r0 + 8 < rows) {
      *reinterpret_cast<__nv_bfloat162*>(
          out + static_cast<long>(r0 + 8) * HD + col) =
          __floats2bfloat162_rn(acc[4 * g + 2] * mul, acc[4 * g + 3] * mul);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreadsBF16, 1)
flash_bwd_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ rows,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                           int Sqp, float scale, int causal) {
  using L = BwdSlab<HD>;
  extern __shared__ __align__(1024) unsigned char smem_bwd[];
  const BwdRing m = BwdRing::make<HD>(smem_bwd);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBwdBlock;  // the heaviest blocks come first
  const int nq = (Sq + kBwdTile - 1) / kBwdTile;
  // query tiles wholly above the block's first key see none of its keys
  const int first = causal ? min(k0 / kBwdTile, nq) : 0;

  if (warp >= kBwdWG * 4) {  // the producer warpgroup: one thread loads
    setmaxnreg_dec<kBwdProducerRegs>();
    if (warp == kBwdWG * 4 && lane == 0) {
      mbar_arrive_expect_tx(m.own_bar(), 2 * kBwdWG * L::kBytes);
      for (int j = 0; j < kBwdWG; ++j) {
        L::load(m.own + j * L::kBytes, &tm_k, m.own_bar(),
                k0 + kBwdTile * j, bh);
        L::load(m.own + (kBwdWG + j) * L::kBytes, &tm_v, m.own_bar(),
                k0 + kBwdTile * j, bh);
      }
      const long plane = static_cast<long>(gridDim.x) * Sqp;
      for (int t = first, it = 0; t < nq; ++t, ++it) {
        const int stage = it % kBwdStages;
        const uint32_t use = it / kBwdStages;
        mbar_wait(m.empty(stage), (use & 1) ^ 1);  // use 0: at once
        mbar_arrive_expect_tx(m.full(stage), 2 * L::kBytes + kBwdRowBytes);
        const uint32_t qs = m.ring + stage * 2 * L::kBytes;
        L::load(qs, &tm_q, m.full(stage), t * kBwdTile, bh);
        L::load(qs + L::kBytes, &tm_do, m.full(stage), t * kBwdTile, bh);
        const float* src = rows + static_cast<long>(bh) * Sqp + t * kBwdTile;
        const uint32_t rs = m.rows + stage * kBwdRowBytes;
        bulk_load(rs, src, kBwdTile * 4, m.full(stage));
        bulk_load(rs + kBwdTile * 4, src + plane, kBwdTile * 4,
                  m.full(stage));
      }
    }
    return;
  }

  // consumers: warpgroup wg owns keys kw..kw + 63; this thread's rows of
  // them kr0 and kr0 + 8
  setmaxnreg_inc<kBwdConsumerRegs>();
  const int wg = warp / 4;
  const int wrow = (warp % 4) * 16 + lane / 4;
  const int quad = lane % 4;
  const int kw = k0 + kBwdTile * wg;
  const int kr0 = kw + wrow;
  const int kr1 = kr0 + 8;
  const uint32_t k_slab = m.own + wg * L::kBytes;
  const uint32_t v_slab = m.own + (kBwdWG + wg) * L::kBytes;
  const float sl2 = scale * kLog2e;
  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dka[i] = dva[i] = 0.f;
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(m.empty(stage));
  };
  mbar_wait(m.own_bar(), 0);
  for (int t = first, it = 0; t < nq; ++t, ++it) {
    const int stage = it % kBwdStages;
    mbar_wait(m.full(stage), (it / kBwdStages) & 1);
    const int q0 = t * kBwdTile;
    // a tile whose rows all lie above the slab's first key is skipped
    if (!(kw < Sk && !(causal && q0 + kBwdTile - 1 < kw))) {
      release(stage);
      continue;
    }
    const uint32_t qs = m.ring + stage * 2 * L::kBytes;
    const uint32_t dos = qs + L::kBytes;
    const float* lse2 = m.rows_p + stage * (kBwdRowBytes / 4);
    const float* dlt = lse2 + kBwdTile;

    // S^T = K Q^T, then dP^T = V dO^T (k-steps of 16 head dims), a group
    // each: P^T is formed while dP^T runs
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      WgmmaSS<kBwdTile>::mma(s, L::kmajor(k_slab, kk), L::kmajor(qs, kk),
                             kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      WgmmaSS<kBwdTile>::mma(dp, L::kmajor(v_slab, kk), L::kmajor(dos, kk),
                             kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();  // S^T done, dP^T runs on
    fence_regs(s);

    // rows are keys, columns query rows q0 + 8 g + 2 quad + (e & 1)
    const bool mask =
        (causal && kw + kBwdTile - 1 > q0) || kw + kBwdTile > Sk;
    bwd_p(
        s, sl2, mask,
        [&](int g, int e) { return lse2[8 * g + 2 * quad + (e & 1)]; },
        [&](int g, int e) {
          const int kpos = (e & 2) ? kr1 : kr0;
          return (causal && kpos > q0 + 8 * g + 2 * quad + (e & 1)) ||
                 kpos >= Sk;
        });
    wgmma_wait_all();
    fence_regs(dp);
    bwd_ds(s, dp,
           [&](int g, int e) { return dlt[8 * g + 2 * quad + (e & 1)]; });
    uint32_t pa[4][4], da[4][4];
    bwd_pack(s, pa);
    bwd_pack(dp, da);

    // dV += P^T dO and dK += dS^T Q, k-steps of 16 query rows
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdTile / 16; ++kk) {
      WgmmaRS<HD>::mma(dva, pa[kk], L::mnmajor(dos, kk), 1);
    }
#pragma unroll
    for (int kk = 0; kk < kBwdTile / 16; ++kk) {
      WgmmaRS<HD>::mma(dka, da[kk], L::mnmajor(qs, kk), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(pa);
    fence_regs(da);
    release(stage);
  }
  const long out0 = static_cast<long>(bh) * Sk * HD;
  bwd_store<HD>(dk + out0, dka, scale, kr0, Sk, quad);
  bwd_store<HD>(dv + out0, dva, 1.f, kr0, Sk, quad);
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreadsBF16, 1)
flash_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ rows,
                         __nv_bfloat16* __restrict__ dq, int Sq, int Sk,
                         int Sqp, float scale, int causal) {
  using L = BwdSlab<HD>;
  extern __shared__ __align__(1024) unsigned char smem_bwd[];
  const BwdRing m = BwdRing::make<HD>(smem_bwd);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  // the query blocks with the most causal key tiles start first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdBlock;
  const int nk_all = (Sk + kBwdTile - 1) / kBwdTile;
  // key tiles past the block's last row are all masked
  const int last = min(q0 + kBwdBlock, Sq) - 1;
  const int nk = causal ? min(nk_all, last / kBwdTile + 1) : nk_all;

  if (warp >= kBwdWG * 4) {  // the producer warpgroup: one thread loads
    setmaxnreg_dec<kBwdProducerRegs>();
    if (warp == kBwdWG * 4 && lane == 0) {
      mbar_arrive_expect_tx(m.own_bar(),
                            2 * kBwdWG * L::kBytes + 2 * kBwdBlock * 4);
      for (int j = 0; j < kBwdWG; ++j) {
        L::load(m.own + j * L::kBytes, &tm_q, m.own_bar(),
                q0 + kBwdTile * j, bh);
        L::load(m.own + (kBwdWG + j) * L::kBytes, &tm_do, m.own_bar(),
                q0 + kBwdTile * j, bh);
      }
      const float* src = rows + static_cast<long>(bh) * Sqp + q0;
      bulk_load(m.rows, src, kBwdBlock * 4, m.own_bar());
      bulk_load(m.rows + kBwdBlock * 4,
                src + static_cast<long>(gridDim.x) * Sqp, kBwdBlock * 4,
                m.own_bar());
      for (int t = 0; t < nk; ++t) {
        const int stage = t % kBwdStages;
        const uint32_t use = t / kBwdStages;
        mbar_wait(m.empty(stage), (use & 1) ^ 1);  // use 0: at once
        mbar_arrive_expect_tx(m.full(stage), 2 * L::kBytes);
        const uint32_t ks = m.ring + stage * 2 * L::kBytes;
        L::load(ks, &tm_k, m.full(stage), t * kBwdTile, bh);
        L::load(ks + L::kBytes, &tm_v, m.full(stage), t * kBwdTile, bh);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows qw..qw + 63; this thread's rows
  // of them r0 and r0 + 8
  setmaxnreg_inc<kBwdConsumerRegs>();
  const int wg = warp / 4;
  const int wrow = (warp % 4) * 16 + lane / 4;
  const int quad = lane % 4;
  const int qw = q0 + kBwdTile * wg;
  const int r0 = qw + wrow;
  const int r1 = r0 + 8;
  // key tiles [0, nc) are computed, the rest only passed on
  const int wg_last = min(qw + kBwdTile, Sq) - 1;
  const int nc = qw >= Sq ? 0 : causal ? min(nk, wg_last / kBwdTile + 1) : nk;
  const uint32_t q_slab = m.own + wg * L::kBytes;
  const uint32_t do_slab = m.own + (kBwdWG + wg) * L::kBytes;
  const float sl2 = scale * kLog2e;
  float dqa[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dqa[i] = 0.f;
  mbar_wait(m.own_bar(), 0);
  const float* own_rows = m.rows_p + kBwdTile * wg + wrow;
  const float l0 = own_rows[0], l1 = own_rows[8];
  const float d0 = own_rows[kBwdBlock], d1 = own_rows[kBwdBlock + 8];
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(m.empty(stage));
  };
  // a tile's dQ product runs on while the next tile's S and dP are issued
  int pending = -1;
  for (int t = 0; t < nk; ++t) {
    const int stage = t % kBwdStages;
    mbar_wait(m.full(stage), (t / kBwdStages) & 1);
    if (t >= nc) {  // the last tiles: finish the pending stage first
      if (pending >= 0) {
        wgmma_wait_all();
        fence_regs(dqa);
        release(pending);
        pending = -1;
      }
      release(stage);
      continue;
    }
    const uint32_t ks = m.ring + stage * 2 * L::kBytes;
    const uint32_t vs = ks + L::kBytes;

    // S = Q K^T and dP = dO V^T, k-steps of 16 head dims
    float s[32], dp[32];
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      WgmmaSS<kBwdTile>::mma(s, L::kmajor(q_slab, kk), L::kmajor(ks, kk),
                             kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      WgmmaSS<kBwdTile>::mma(dp, L::kmajor(do_slab, kk), L::kmajor(vs, kk),
                             kk > 0);
    }
    wgmma_commit();
    // S and the last tile's dQ product done; dP runs on while P is formed
    wgmma_wait<1>();
    fence_regs(s);
    fence_regs(dqa);
    if (pending >= 0) release(pending);

    // rows are query rows, columns keys k0 + 8 g + 2 quad + (e & 1)
    const int k0 = t * kBwdTile;
    const bool mask =
        (causal && k0 + kBwdTile - 1 > qw) || k0 + kBwdTile > Sk;
    bwd_p(
        s, sl2, mask, [&](int, int e) { return (e & 2) ? l1 : l0; },
        [&](int g, int e) {
          const int kpos = k0 + 8 * g + 2 * quad + (e & 1);
          return (causal && kpos > ((e & 2) ? r1 : r0)) || kpos >= Sk;
        });
    wgmma_wait_all();
    fence_regs(dp);
    bwd_ds(s, dp, [&](int, int e) { return (e & 2) ? d1 : d0; });

    // dQ += dS K, k-steps of 16 keys
    uint32_t da[4][4];
    bwd_pack(dp, da);
    fence_regs(da);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBwdTile / 16; ++kk) {
      WgmmaRS<HD>::mma(dqa, da[kk], L::mnmajor(ks, kk), 1);
    }
    wgmma_commit();
    fence_regs(da);
    pending = stage;
  }
  wgmma_wait_all();
  fence_regs(dqa);
  if (pending >= 0) release(pending);
  bwd_store<HD>(dq + static_cast<long>(bh) * Sq * HD, dqa, scale, r0, Sq,
                quad);
}

template <int HD>
cudaError_t launch_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const float* lse,
                            float* rows, void* dq, void* dk, void* dv, int BH,
                            int Sq, int Sk, float scale, int causal, int smem,
                            cudaStream_t stream) {
  using L = BwdSlab<HD>;
  if (smem < bwd_bf16_smem_bytes(HD)) return cudaErrorInvalidValue;
  const int Sqp = bwd_padded_rows(Sq);
  const long n = static_cast<long>(BH) * Sqp;
  flash_bwd_rows_kernel<<<static_cast<unsigned>((n + 7) / 8), 256, 0,
                          stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, rows, BH, Sq, Sqp, HD);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const CUtensorMapSwizzle swizzle =
      HD >= 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!encode_bf16_3d(&tm_q, q, HD, Sq, BH, L::kPanelCols, kBwdTile,
                      swizzle) ||
      !encode_bf16_3d(&tm_k, k, HD, Sk, BH, L::kPanelCols, kBwdTile,
                      swizzle) ||
      !encode_bf16_3d(&tm_v, v, HD, Sk, BH, L::kPanelCols, kBwdTile,
                      swizzle) ||
      !encode_bf16_3d(&tm_do, dout, HD, Sq, BH, L::kPanelCols, kBwdTile,
                      swizzle)) {
    return cudaErrorInvalidValue;
  }
  auto dkdv = flash_bwd_dkdv_bf16_kernel<HD>;
  auto dqk = flash_bwd_dq_bf16_kernel<HD>;
  if ((err = allow_smem(dkdv, smem)) != cudaSuccess) return err;
  if ((err = allow_smem(dqk, smem)) != cudaSuccess) return err;
  dkdv<<<dim3(BH, (Sk + kBwdBlock - 1) / kBwdBlock), kBwdThreadsBF16, smem,
         stream>>>(tm_q, tm_k, tm_v, tm_do, rows,
                   static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), Sq, Sk, Sqp, scale,
                   causal);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dqk<<<dim3(BH, Sqp / kBwdBlock), kBwdThreadsBF16, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, rows, static_cast<__nv_bfloat16*>(dq), Sq, Sk,
      Sqp, scale, causal);
  return cudaGetLastError();
}

cudaError_t launch_bwd_bf16_hd(int hd, const void* q, const void* k,
                               const void* v, const void* o, const void* dout,
                               const float* lse, float* rows, void* dq,
                               void* dk, void* dv, int BH, int Sq, int Sk,
                               float scale, int causal, int smem,
                               cudaStream_t stream) {
  switch (hd) {
#define REPRO_FLASH_BWD_BF16(HD)                                            \
  case HD:                                                                  \
    return launch_bwd_bf16<HD>(q, k, v, o, dout, lse, rows, dq, dk, dv, BH, \
                               Sq, Sk, scale, causal, smem, stream);
    REPRO_FLASH_BWD_BF16(32)
    REPRO_FLASH_BWD_BF16(64)
    REPRO_FLASH_BWD_BF16(128)
#undef REPRO_FLASH_BWD_BF16
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (BH, Sq, hd); k, v: (BH, Sk, hd), all contiguous and 16-byte
// aligned.  lse: (BH, Sq) f32, each row's log-sum-exp of its scaled scores
// (m + log l), or null for none.  smem is the block's dynamic shared
// memory, smem_bytes in
// repro_torch/kernels/flash_attention/flash_attention.py: for f32 at least
// 2 * block_k * hd * 4; for bf16 the alignment slack, the barriers, the Q
// slabs and at least one stage (the kernel uses as many stages as smem
// holds, up to 4).  bf16 takes block_k in {16, 32, 48, 64, 128, 192, 256}.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BH,
                                   int Sq, int Sk, int hd, int block_q,
                                   int block_k, float scale, int causal,
                                   int dtype, int smem, void* stream) {
  if (BH <= 0 || block_q <= 0 || block_k <= 0 || block_q % 8 != 0 ||
      block_q > 256 || Sq % block_q != 0 || Sk % block_k != 0) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == kF32) {
    if (smem < 2 * block_k * hd * 4) return cudaErrorInvalidValue;
    return launch_f32_hd(hd, q, k, v, o, l, BH, Sq, Sk, block_q, block_k,
                         scale, causal, smem, s);
  }
  if (dtype == kBF16)
    return launch_bf16_hd(hd, block_k, q, k, v, o, l, BH, Sq, Sk, block_q,
                          scale, causal, smem, s);
  return cudaErrorInvalidValue;
}

// The gradient of flash_attention_fwd: q, o, dout, dq: (BH, Sq, hd); k, v,
// dk, dv: (BH, Sk, hd), all contiguous (bf16: 16-byte aligned), one type
// (f32 or bf16); lse: the forward's (BH, Sq) f32 log-sum-exp; delta: f32
// scratch of bwd_scratch_floats in flash_attention.py (f32: BH * Sq; bf16:
// 2 * BH * Sq rounded up to 128 rows).  Any Sq and Sk; hd in {32, 64, 128};
// smem at least bwd_f32_smem_bytes(hd) or bwd_bf16_smem_bytes(hd).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int BH, int Sq, int Sk, int hd,
                                   float scale, int causal, int dtype,
                                   int smem, void* stream) {
  if (BH <= 0 || Sq <= 0 || Sk <= 0 || lse == nullptr) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (dtype == kF32)
    return launch_bwd_f32_hd(hd, q, k, v, o, dout, l, dl, dq, dk, dv, BH, Sq,
                             Sk, scale, causal, smem, s);
  if (dtype == kBF16)
    return launch_bwd_bf16_hd(hd, q, k, v, o, dout, l, dl, dq, dk, dv, BH,
                              Sq, Sk, scale, causal, smem, s);
  return cudaErrorInvalidValue;
}
