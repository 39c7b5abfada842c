// FlashAttention-2 forward for NVIDIA Hopper (sm_90a), f32 and bf16.
//
// Replaces the Pallas TPU kernel `_fa_kernel` in
// src/repro/kernels/attention/kernel.py (launched by `flash_attention_bhsd`).
// It computes the same function over folded (batch*head, S, D) arrays:
//
//   o[bh, i, :] = sum_j softmax_j(q[bh, i] . k[kv, j] / sqrt(D) + mask) v[kv, j]
//
// with kv = bh / group (the layout `jnp.repeat(k, group, axis=heads)` gives,
// indexed instead of materialised), the mask causal and top-left aligned
// (key j visible to query i iff j <= i) or absent, masked scores set to
// -1e30 as in the TPU kernel, the running max m, the normaliser l and the
// output accumulator in f32, l clamped at 1e-30, and the output rounded
// once to the input dtype.
//
// Design. The Pallas grid walks the key blocks as a sequential grid axis and
// carries m, l and the accumulator in VMEM scratch. Here one block of 256
// threads owns one (batch*head, 64-query tile) and loops over the 64-key
// tiles itself, with m, l and the accumulator in registers; nothing carries
// between blocks. Each tile of K and V is staged through shared memory as
// f32 (K transposed, so that a thread's 4 keys are one 16-byte load), and
// the 64 x 64 score tile is computed by scalar FMAs in a 4 x 4 register
// tile per thread (16 threads across the keys, 16 down the queries). The
// row max and the rescale factor are exchanged by warp shuffles among the
// 16 threads of a row; the probabilities go through shared memory
// (transposed) to the P.V product, where each thread owns 4 rows and
// D/16 output columns. A causal block stops at the last key tile that
// touches its diagonal, as the TPU kernel's `pl.when` skips the blocks
// above it, and the query tiles are scheduled heaviest first. Tails where
// S is not a multiple of 64 are zero-filled in shared memory and masked,
// and D up to 128 (a multiple of 4) is zero-padded to 64 or 128.
//
// What bounds it on an H100: at the serving shape (4 x 12 heads over 2 KV
// heads, S = 2048, D = 128, causal) the function needs 4 D S (S + 1) / 2
// operations per head, 5.16e10 in all: 0.052 ms at the bf16 tensor-core
// rate (989 TFLOP/s) against 0.018 ms to read q, k, v and write o once
// (58.7 MB at 3.35 TB/s), so it is bound by operations. This kernel does
// them as scalar f32 FMAs, whose peak is 67 TFLOP/s, with two 16-byte
// shared-memory loads per 16 FMAs in the score loop; tensor cores
// (mma.sync / wgmma) and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (IEEE division and
// expf: no fast-math). Dynamic shared memory: 112 KB per block for D > 64
// (two blocks per SM), 64 KB for D <= 64.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: tx across keys/columns, ty rows
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float x[4]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  x[0] = a.x;
  x[1] = a.y;
  x[2] = b.x;
  x[3] = b.y;
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [row0, row0 + 64) of a (rows, d) array into dst[DP][64] (transposed,
// f32), zero outside the array and for columns >= d.
template <typename T, int DP>
__device__ __forceinline__ void load_tile_t(float* __restrict__ dst,
                                            const T* __restrict__ src,
                                            int row0, int rows, int d) {
  const int r = threadIdx.x % 64;
  const int row = row0 + r;
  for (int c = threadIdx.x / 64; c < DP / 4; c += kThreads / 64) {
    const int col = c * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < rows && col < d) {
      load4(src + static_cast<int64_t>(row) * d + col, x);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(col + e) * 64 + r] = x[e];
  }
}

// Rows [row0, row0 + 64) of a (rows, d) array into dst[64][DP] (f32), zero
// outside the array and for columns >= d.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int row0, int rows, int d) {
  for (int idx = threadIdx.x; idx < 64 * (DP / 4); idx += kThreads) {
    const int r = idx / (DP / 4);
    const int col = (idx % (DP / 4)) * 4;
    const int row = row0 + r;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row < rows && col < d) {
      load4(src + static_cast<int64_t>(row) * d + col, x);
    }
    *reinterpret_cast<float4*>(dst + r * DP + col) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, 2)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
              int d, int group, float scale, int causal) {
  constexpr int kGroups = DP / 64;  // float4 column groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [DP][kBQ]
  float* ks = qs + DP * kBQ;                     // [DP][kBK]
  float* vs = ks + DP * kBK;                     // [kBK][DP]
  float* ps = vs + kBK * DP;                     // [kBK][kBQ]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBQ;
  const int64_t bh = blockIdx.x;
  const T* qb = q + bh * sq * d;
  const T* kb = k + (bh / group) * sk * d;
  const T* vb = v + (bh / group) * sk * d;
  T* ob = o + bh * sq * d;

  load_tile_t<T, DP>(qs, qb, q0, sq, d);

  float acc[4][4 * kGroups];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's ks, vs, ps are consumed
    load_tile_t<T, DP>(ks, kb, k0, sk, d);
    load_tile<T, DP>(vs, vb, k0, sk, d);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < DP; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(qs + dd * kBQ + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(ks + dd * kBK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // Online softmax, row by row; a row's 64 keys live in 16 lanes.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int iq = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ik = k0 + tx * 4 + j;
        const bool ok = ik < sk && (!causal || ik <= iq);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      }
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * alpha + rs;  // this thread's 4 keys; summed at the end
#pragma unroll
      for (int c = 0; c < 4 * kGroups; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(ps + (tx * 4 + j) * kBQ + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(ps + kk * kBQ + ty * 4);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 w =
            *reinterpret_cast<const float4*>(vs + kk * DP + g * 64 + tx * 4);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(pv[i], wv[e], acc[i][g * 4 + e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float den = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      den += __shfl_xor_sync(0xffffffffu, den, off);
    }
    den = fmaxf(den, 1e-30f);
    const int iq = q0 + ty * 4 + i;
    if (iq >= sq) continue;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = g * 64 + tx * 4 + e;
        if (c < d) {
          store1(ob + static_cast<int64_t>(iq) * d + c, acc[i][g * 4 + e] / den);
        }
      }
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int bh, int group, int sq, int sk, int d, float scale,
                   int causal, cudaStream_t stream) {
  const int smem = (2 * DP * 64 + 64 * DP + 64 * 64) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  if (n_qt > 65535) return cudaErrorInvalidConfiguration;
  fa_fwd_kernel<T, DP><<<dim3(bh, n_qt), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, group, scale,
      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int bh, int group, int sq, int sk, int d, float scale,
                     int causal, cudaStream_t stream) {
  if (d <= 64) {
    return launch<T, 64>(q, k, v, o, bh, group, sq, sk, d, scale, causal,
                         stream);
  }
  return launch<T, 128>(q, k, v, o, bh, group, sq, sk, d, scale, causal,
                        stream);
}

}  // namespace

// dtype codes: 0 f32, 1 bf16. q, o: (bh, sq, d); k, v: (bh / group, sk, d),
// contiguous, 16-byte aligned, d a multiple of 4 in [4, 128].
extern "C" int fa_fwd_launch(const void* q, const void* k, const void* v,
                             void* o, int bh, int group, int sq, int sk,
                             int d, float scale, int causal, int dtype,
                             void* stream) {
  if (bh < 1 || group < 1 || bh % group || sq < 1 || sk < 1 || d < 4 ||
      d > 128 || d % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_d<float>(q, k, v, o, bh, group, sq, sk, d, scale, causal,
                             st);
    case 1:
      return launch_d<__nv_bfloat16>(q, k, v, o, bh, group, sq, sk, d, scale,
                                     causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
