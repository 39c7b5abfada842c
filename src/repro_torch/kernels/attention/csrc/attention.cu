// FlashAttention-2 forward for NVIDIA Hopper (sm_90a), bf16 and f32.
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
// What bounds it on an H100: at the serving shape (4 x 12 heads over 2 KV
// heads, S = 2048, D = 128, causal) the function needs 4 D S (S + 1) / 2
// operations per head, 5.16e10 in all: 0.052 ms at the bf16 tensor-core
// rate (989 TFLOP/s) against 0.018 ms to read q, k, v and write o once
// (58.7 MB at 3.35 TB/s), so it is bound by operations, and only the
// tensor cores can approach that bound.
//
// Both kernels share the FlashAttention-2 structure. The Pallas grid walks
// the key blocks as a sequential grid axis and carries m, l and the
// accumulator in VMEM scratch; here one block owns one (batch*head,
// 64-query tile) and loops over the 64-key tiles itself, with m, l and the
// accumulator in registers, so nothing carries between blocks. A causal
// block stops at the last key tile that touches its diagonal (the TPU
// kernel's `pl.when` skips the tiles above it), only that tile and a
// ragged last tile are masked, and the query tiles are scheduled heaviest
// first. Tails where S is not a multiple of 64 are zero-filled in shared
// memory and masked, and D up to 128 (a multiple of 4) is zero-padded to
// 64 or 128.
//
// bf16, `fa_fwd_bf16_kernel`: tensor cores. Four warps per block, each
// owning 16 query rows whose Q fragments stay in registers for the whole
// key loop. K and V tiles (64 keys x D, bf16) are copied by cp.async into
// a two-stage ring of XOR-swizzled shared tiles, so tile t + 1 loads while
// tile t is multiplied and ldmatrix (.trans for V) reads them free of bank
// conflicts. Both products are mma.sync m16n8k16 bf16 x bf16 -> f32:
// S = Q K^T (products of bf16 inputs, exact in f32, as in the f32 kernel)
// and O += P V. The online softmax runs on the S accumulator fragments,
// with the row max and row sum reduced over the four lanes that share a
// row. P enters P V straight from the accumulator registers (the m16n8
// accumulator layout is the m16k16 A layout, so P never touches shared
// memory), split into two bf16 operands, hi = bf16(p) and lo = bf16(p -
// hi), each multiplied by V: hi + lo carries p to about 2^-17 relative, so
// P V keeps the f32 probabilities of the plain version and the TPU kernel
// where a single bf16 P (FlashAttention-2's choice) would move every
// output by up to 2^-9 relative, enough to flip its final bf16 rounding.
// The split issues half as many tensor-core products again. l sums the
// f32 P.
// Dynamic shared memory: 64 KB for D > 64 (Q is staged through the second
// K stage before the loop), 32 KB for D <= 64. Head dims that are not a
// multiple of 8 are copied in 8-byte pieces (the rows are then only 8-byte
// aligned).
//
// f32, `fa_fwd_f32_kernel`: scalar FMAs, since the tensor cores take f32
// only as TF32, which cannot meet the f32 bound (rtol = atol = 2e-5).
// 256 threads; K (transposed) and V tiles staged through shared memory,
// the 64 x 64 score tile from a 4 x 4 register tile per thread, the
// probabilities through shared memory to P V, where each thread owns 4
// rows and D/16 output columns. Its peak is the 67 TFLOP/s f32 rate.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (IEEE division and
// expf: no fast-math).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr float kNegInf = -1e30f;

// ---- bf16: tensor cores ---------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies `bytes` (16 or 8) from global `src` to shared `dst` when `valid`,
// else zero-fills them (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool valid) {
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(valid ? 8 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16, `lo` in the low half (the lower column index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Two f32 split into their bf16 roundings (`hi`) and the bf16 of what
// those leave (`lo`; x - float(bf16(x)) is exact in f32), x0 in the low
// half of each, as pack_bf16 packs them.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// Element offset of 8-element chunk `c` of row `r` in a [rows][DP] bf16
// tile whose chunks are XOR-swizzled by the row's low three bits: the 8
// rows an ldmatrix phase reads sit in 8 different 16-byte bank groups.
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DP + ((c ^ (r & 7)) << 3);
}

// Rows [row0, row0 + 64) of a (rows, d) bf16 array into the swizzled
// [64][DP] tile `dst` by cp.async, zero outside the array and for columns
// >= d. With d % 8 == 0 a thread copies 16-byte chunks; otherwise rows are
// only 8-byte aligned and each chunk is two 8-byte halves (d % 4 == 0).
template <int DP>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                int row0, int rows, int d) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < kBK * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    const int row = row0 + r;
    const uint32_t s = smem_addr(dst + swz<DP>(r, c));
    const int64_t base = static_cast<int64_t>(row) * d + c * 8;
    if (d % 8 == 0) {
      const bool ok = row < rows && c * 8 < d;
      cp_async(s, ok ? src + base : src, 16, ok);
    } else {
      const bool ok0 = row < rows && c * 8 < d;
      const bool ok1 = row < rows && c * 8 + 4 < d;
      cp_async(s, ok0 ? src + base : src, 8, ok0);
      cp_async(s + 8, ok1 ? src + base + 4 : src, 8, ok1);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kMmaThreads)
fa_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, bf16* __restrict__ o, int sq,
                   int sk, int d, int group, float scale, int causal) {
  constexpr int kTile = kBK * DP;  // elements of one K or V tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [2][64][DP]
  bf16* vs = ks + 2 * kTile;                     // [2][64][DP]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // accumulator row within the warp's 16 (and + 8)
  const int t = lane & 3;   // accumulator column pair
  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBQ;
  const int64_t bh = blockIdx.x;
  const bf16* qb = q + bh * sq * d;
  const bf16* kb = k + (bh / group) * sk * d;
  const bf16* vb = v + (bh / group) * sk * d;
  bf16* ob = o + bh * sq * d;

  int n_kt = (sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ - 1) / kBK + 1);

  // Prologue: Q through the second K stage, key tile 0 into the first.
  load_tile_async<DP>(ks + kTile, qb, q0, sq, d);
  load_tile_async<DP>(ks, kb, 0, sk, d);
  load_tile_async<DP>(vs, vb, 0, sk, d);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[DP / 16][4];  // A fragments of the warp's 16 rows x DP
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    ldmatrix_x4(qf[kk],
                smem_addr(ks + kTile + swz<DP>(row, 2 * kk + (lane >> 4))));
  }
  __syncthreads();  // Q is in registers; the second stage is free

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;  // rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;          // this lane's share of the row sums
  const int iq_lo = q0 + warp * 16 + g;
  const int iq_hi = iq_lo + 8;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt & 1;
    if (kt + 1 < n_kt) {  // the next tile loads while this one is multiplied
      load_tile_async<DP>(ks + (st ^ 1) * kTile, kb, (kt + 1) * kBK, sk, d);
      load_tile_async<DP>(vs + (st ^ 1) * kTile, vb, (kt + 1) * kBK, sk, d);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* kst = ks + st * kTile;
    const bf16* vst = vs + st * kTile;

    // S = Q K^T: 16 rows x 64 keys per warp, 8 accumulator tiles of 8 keys.
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
        uint32_t b[4];
        ldmatrix_x4(
            b, smem_addr(kst + swz<DP>(key, 2 * kk + ((lane >> 3) & 1))));
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // Online softmax on the fragments: lane holds keys 8j + 2t + {0, 1} of
    // rows g (s[j][0..1]) and g + 8 (s[j][2..3]).
    const int k0 = kt * kBK;
    const bool masked = k0 + kBK > sk || (causal && k0 + kBK - 1 > q0);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = s[j][e] * scale;
        float b = s[j][2 + e] * scale;
        if (masked) {
          const int ik = k0 + 8 * j + 2 * t + e;
          a = (ik < sk && (!causal || ik <= iq_lo)) ? a : kNegInf;
          b = (ik < sk && (!causal || ik <= iq_hi)) ? b : kNegInf;
        }
        s[j][e] = a;
        s[j][2 + e] = b;
        mx_lo = fmaxf(mx_lo, a);
        mx_hi = fmaxf(mx_hi, b);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = expf(m_lo - mn_lo);
    const float al_hi = expf(m_hi - mn_hi);
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] = expf(s[j][e] - mn_lo);
        s[j][2 + e] = expf(s[j][2 + e] - mn_hi);
        rs_lo += s[j][e];
        rs_hi += s[j][2 + e];
      }
    }
    l_lo = l_lo * al_lo + rs_lo;
    l_hi = l_hi * al_hi + rs_hi;
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= al_lo;
      acc[n][1] *= al_lo;
      acc[n][2] *= al_hi;
      acc[n][3] *= al_hi;
    }

    // O += P V: P from the accumulator tiles 2kk and 2kk + 1 as the A
    // operands hi and lo, each against the same V fragments.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a_hi[4], a_lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], a_hi[0], a_lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], a_hi[1], a_lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], a_hi[2], a_lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], a_hi[3], a_lo[3]);
      const int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dp = 0; dp < DP / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_addr(vst + swz<DP>(key, 2 * dp + (lane >> 4))));
        mma_bf16(acc[2 * dp], a_lo, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a_lo, b[2], b[3]);
        mma_bf16(acc[2 * dp], a_hi, b[0], b[1]);
        mma_bf16(acc[2 * dp + 1], a_hi, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  l_lo = fmaxf(l_lo, 1e-30f);
  l_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int c = n * 8 + 2 * t;  // d % 4 == 0: c < d implies c + 1 < d
    if (c >= d) continue;
    if (iq_lo < sq) {
      bf16* p = ob + static_cast<int64_t>(iq_lo) * d + c;
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(acc[n][0] / l_lo, acc[n][1] / l_lo);
    }
    if (iq_hi < sq) {
      bf16* p = ob + static_cast<int64_t>(iq_hi) * d + c;
      *reinterpret_cast<__nv_bfloat162*>(p) =
          __floats2bfloat162_rn(acc[n][2] / l_hi, acc[n][3] / l_hi);
    }
  }
}

// ---- f32: scalar FMAs -------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16: tx across keys/columns, ty rows

__device__ __forceinline__ void load4(const float* p, float x[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  x[0] = t.x;
  x[1] = t.y;
  x[2] = t.z;
  x[3] = t.w;
}

// Rows [row0, row0 + 64) of a (rows, d) array into dst[DP][64] (transposed),
// zero outside the array and for columns >= d.
template <int DP>
__device__ __forceinline__ void load_tile_t(float* __restrict__ dst,
                                            const float* __restrict__ src,
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

// Rows [row0, row0 + 64) of a (rows, d) array into dst[64][DP], zero
// outside the array and for columns >= d.
template <int DP>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
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

template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
fa_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int sq,
                  int sk, int d, int group, float scale, int causal) {
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
  const float* qb = q + bh * sq * d;
  const float* kb = k + (bh / group) * sk * d;
  const float* vb = v + (bh / group) * sk * d;
  float* ob = o + bh * sq * d;

  load_tile_t<DP>(qs, qb, q0, sq, d);

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
    load_tile_t<DP>(ks, kb, k0, sk, d);
    load_tile<DP>(vs, vb, k0, sk, d);
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
          ob[static_cast<int64_t>(iq) * d + c] = acc[i][g * 4 + e] / den;
        }
      }
  }
}

// ---- launch -----------------------------------------------------------------

template <typename T>
cudaError_t start(void (*kernel)(const T*, const T*, const T*, T*, int, int,
                                 int, int, float, int),
                  int threads, int smem, const void* q, const void* k,
                  const void* v, void* o, int bh, int group, int sq, int sk,
                  int d, float scale, int causal, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  if (n_qt > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<dim3(bh, n_qt), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, group, scale,
      causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int bh, int group, int sq, int sk, int d, float scale,
                       int causal, cudaStream_t stream) {
  const int smem = (2 * DP * 64 + 64 * DP + 64 * 64) * sizeof(float);
  return start<float>(fa_fwd_f32_kernel<DP>, kThreads, smem, q, k, v, o, bh,
                      group, sq, sk, d, scale, causal, stream);
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int bh, int group, int sq, int sk, int d, float scale,
                        int causal, cudaStream_t stream) {
  const int smem = 4 * kBK * DP * sizeof(bf16);  // K and V, two stages each
  return start<bf16>(fa_fwd_bf16_kernel<DP>, kMmaThreads, smem, q, k, v, o,
                     bh, group, sq, sk, d, scale, causal, stream);
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
  const bool narrow = d <= 64;
  switch (dtype) {
    case 0:
      return static_cast<int>(
          narrow ? launch_f32<64>(q, k, v, o, bh, group, sq, sk, d, scale,
                                  causal, st)
                 : launch_f32<128>(q, k, v, o, bh, group, sq, sk, d, scale,
                                   causal, st));
    case 1:
      return static_cast<int>(
          narrow ? launch_bf16<64>(q, k, v, o, bh, group, sq, sk, d, scale,
                                   causal, st)
                 : launch_bf16<128>(q, k, v, o, bh, group, sq, sk, d, scale,
                                    causal, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
