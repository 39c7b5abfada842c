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
// once to the input dtype. A causal call may also take a sliding window W
// (`window` > 0; 0 is none): key j is then visible to query i iff
// i - W < j <= i, the mask of the reference model's plain attention step
// with `sliding_window` (src/repro/models/layers.py, `_mask_bias`), which
// the TPU kernel does not have.
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
// accumulator in VMEM scratch; here one block owns one (batch*head, query
// tile) and loops over the 64-key tiles itself, with m, l and the
// accumulator in registers, so nothing carries between blocks. Each warp
// owns 16 query rows. A causal block stops at the last key tile that
// touches its diagonal (the TPU kernel's `pl.when` skips the tiles above
// it), only that tile and a ragged last tile are masked, and the query
// tiles are scheduled heaviest first. With a window a block also starts at
// the key tile that holds its lowest row's first visible key, q0 - W + 1,
// and masks the tiles that reach below its highest row's, in the same
// predicates. Every row sees its own key, so no row is wholly masked; a
// tile that is wholly masked for some rows of a block (only ever before
// their first visible key) leaves finite m, l and accumulator that the
// next tile's rescale, exp(-1e30 - m), multiplies by exactly 0. Tails where S is not a multiple of
// 64 are zero-filled in shared memory and masked, and D up to 128 (a
// multiple of 4) is zero-padded to 64 or 128.
//
// bf16, `fa_fwd_bf16_kernel`: tensor cores. Four warps per block, each
// owning 16 query rows whose Q fragments stay in registers for the whole
// key loop. K and V tiles (64 keys x D, bf16) are copied by cp.async into
// a two-stage ring of XOR-swizzled shared tiles, so tile t + 1 loads while
// tile t is multiplied and ldmatrix (.trans for V) reads them free of bank
// conflicts. Both products are mma.sync m16n8k16 bf16 x bf16 -> f32:
// S = Q K^T (products of bf16 inputs, exact in f32)
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
// f32, `fa_fwd_f32_kernel`: tensor cores in 3xTF32. The tensor cores take
// f32 only as TF32 (10 mantissa bits): one TF32 product errs by about
// 2^-11 relative, ~3.5e-3 in a score at D = 128, far above the f32 bound
// (rtol = atol = 2e-5). So every operand x is split into hi = tf32(x) and
// lo = x - hi (see split_tf32), and each product is hi hi + hi lo + lo hi
// (mma.sync m16n8k8 tf32 x tf32 -> f32, three per product, ~2^-21
// relative). At the serving shape that is 3 x 5.16e10 operations: 0.313 ms
// at the 494.7 TFLOP/s dense TF32 rate, which only wgmma reaches, against
// 0.770 ms for the function on the 67 TFLOP/s f32 cores. Eight warps per
// block, 128 query rows; the Q tile stays in shared memory and K and V
// tiles (64 keys x D, f32) come through a two-stage cp.async ring, padded
// (ldmatrix cannot transpose 32-bit elements, so no swizzle) so that every
// fragment load is free of bank conflicts. Each warp splits the fragments
// it loads in registers: hi and lo of K and V, once per tile in shared
// memory, do not fit beside Q and the ring. A warp skips causal tiles
// wholly above its own rows. The tensor cores' f32 accumulation rounds
// coarser than an f32 add (longer chains in it measured less accurate), so
// no long sum runs through it: each score is summed from zero over 32 head
// dims at a time and the partial sums added in f32, and each tile's P V is
// summed from zero and added to O in f32. P is used from the S
// accumulator with the key index permuted (see the P V step).
// Dynamic shared memory: 202 KB for D > 64, 106 KB for D <= 64.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (IEEE division and
// expf: no fast-math).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // queries per bf16 block
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
                   int sk, int d, int group, float scale, int causal,
                   int window) {
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
  // The window's first key tile: the one holding q0 - W + 1.
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  // Prologue: Q through the second K stage, key tile kt0 into the first.
  load_tile_async<DP>(ks + kTile, qb, q0, sq, d);
  load_tile_async<DP>(ks, kb, kt0 * kBK, sk, d);
  load_tile_async<DP>(vs, vb, kt0 * kBK, sk, d);
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

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int st = (kt - kt0) & 1;
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
    // Masked: a ragged last tile, the diagonal's, or one reaching below the
    // window of the block's highest row, q0 + kBQ - 1.
    const bool masked = k0 + kBK > sk || (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && k0 < q0 + kBQ - window);
    float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = s[j][e] * scale;
        float b = s[j][2 + e] * scale;
        if (masked) {
          const int ik = k0 + 8 * j + 2 * t + e;
          a = (ik < sk && (!causal || ik <= iq_lo) &&
               (window == 0 || ik > iq_lo - window))
                  ? a
                  : kNegInf;
          b = (ik < sk && (!causal || ik <= iq_hi) &&
               (window == 0 || ik > iq_hi - window))
                  ? b
                  : kNegInf;
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

// ---- f32: 3xTF32 tensor cores --------------------------------------------

constexpr int kBQ32 = 128;        // queries per f32 block
constexpr int kF32Threads = 256;  // 8 warps x 16 query rows
constexpr int kSC = 4;            // 8-dim blocks in each partial sum of S

// Row strides (floats) of the f32 tiles. Q and K fragments are read as
// float2 at (row g, column 2t) of an 8 x 8 block: a stride of 8 mod 32
// words puts each half-warp's 16 pairs on 32 different banks. V fragments
// are read as scalars at (row 2t, column g): a stride of 4 mod 32 puts the
// warp's 32 words on 32 different banks.
template <int DP>
struct F32Tile {
  static constexpr int kQKStride = DP + 8;
  static constexpr int kVStride = DP + 4;
  static constexpr int kQ = kBQ32 * kQKStride;  // floats of the Q tile
  static constexpr int kK = kBK * kQKStride;    // of one K stage
  static constexpr int kV = kBK * kVStride;     // of one V stage
  static constexpr int kSmemBytes = (kQ + 2 * kK + 2 * kV) * sizeof(float);
};

// x = hi + lo, hi = x rounded to TF32 (10 mantissa bits, to nearest, ties
// away from zero, as cvt.rna.tf32.f32 rounds: add half a TF32 ulp to the
// bits, clear the 13 below it) and lo = x - hi, exact in f32 with
// |lo| <= 2^-11 |x|. lo goes to the tensor cores as it is: they read a
// TF32 operand's top 19 bits (clearing the other 13 of lo leaves the
// kernel's output bit-equal), so lo is truncated to 2^-10 of itself.
// hi hi + hi lo + lo hi then carries a product to about 2^-21 relative,
// where one TF32 product errs by 2^-11. Three instructions an operand,
// fewer than cvt.rna.tf32.f32 takes.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) * b (8 x 8, col), TF32 inputs, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += (a_hi + a_lo)(b_hi + b_lo) less the a_lo b_lo term, small terms
// first.
__device__ __forceinline__ void mma_3xtf32(float c[4], const uint32_t ah[4],
                                           const uint32_t al[4], uint32_t bh0,
                                           uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}

// Rows [row0, row0 + N) of a (rows, d) f32 array into `dst` (row stride
// `stride` floats) by 16-byte cp.async, zero outside the array and for
// columns >= d (d % 4 == 0, so every row is 16-byte aligned). A thread
// keeps one 16-byte column chunk and steps down the rows.
template <int DP, int N>
__device__ __forceinline__ void load_rows_async(float* dst, int stride,
                                                const float* __restrict__ src,
                                                int row0, int rows, int d) {
  constexpr int kChunks = DP / 4;
  constexpr int kRowStep = kF32Threads / kChunks;
  static_assert(kF32Threads % kChunks == 0 && N % kRowStep == 0,
                "a pass covers whole rows");
  const int c = threadIdx.x % kChunks;
  const int r = threadIdx.x / kChunks;
  const bool col_ok = c * 4 < d;
  const float* s = src + static_cast<int64_t>(row0 + r) * d + c * 4;
  const uint32_t a = smem_addr(dst + r * stride + c * 4);
#pragma unroll
  for (int i = 0; i < N / kRowStep; ++i) {
    const bool ok = col_ok && row0 + r + i * kRowStep < rows;
    cp_async(a + i * kRowStep * stride * sizeof(float),
             ok ? s + static_cast<int64_t>(i) * kRowStep * d : src, 16, ok);
  }
}

template <int DP>
__global__ void __launch_bounds__(kF32Threads, 1)
fa_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int sq,
                  int sk, int d, int group, float scale, int causal,
                  int window) {
  using L = F32Tile<DP>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [128][DP + 8]
  float* ks = qs + L::kQ;                          // [2][64][DP + 8]
  float* vs = ks + 2 * L::kK;                      // [2][64][DP + 4]

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int n_qt = (sq + kBQ32 - 1) / kBQ32;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * kBQ32;
  const int r0 = q0 + warp * 16;  // the warp's first query row
  const int64_t bh = blockIdx.x;
  const float* qb = q + bh * sq * d;
  const float* kb = k + (bh / group) * sk * d;
  const float* vb = v + (bh / group) * sk * d;
  float* ob = o + bh * sq * d;

  int n_kt = (sk + kBK - 1) / kBK;
  if (causal) n_kt = min(n_kt, (q0 + kBQ32 - 1) / kBK + 1);
  // The window's first key tile: the one holding q0 - W + 1.
  const int kt0 = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  load_rows_async<DP, kBQ32>(qs, L::kQKStride, qb, q0, sq, d);
  load_rows_async<DP, kBK>(ks, L::kQKStride, kb, kt0 * kBK, sk, d);
  load_rows_async<DP, kBK>(vs, L::kVStride, vb, kt0 * kBK, sk, d);
  cp_async_commit();

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_lo = kNegInf, m_hi = kNegInf;  // rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;          // this lane's share of the row sums
  const int iq_lo = r0 + g;
  const int iq_hi = iq_lo + 8;
  // The warp's Q rows g and g + 8, at column 2t of each 8-column block.
  const float* qw = qs + (warp * 16 + g) * L::kQKStride + 2 * t;

  for (int kt = kt0; kt < n_kt; ++kt) {
    const int st = (kt - kt0) & 1;
    if (kt + 1 < n_kt) {  // the next tile loads while this one is multiplied
      load_rows_async<DP, kBK>(ks + (st ^ 1) * L::kK, L::kQKStride, kb,
                               (kt + 1) * kBK, sk, d);
      load_rows_async<DP, kBK>(vs + (st ^ 1) * L::kV, L::kVStride, vb,
                               (kt + 1) * kBK, sk, d);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * kBK;
    // Warp-uniform: causal tiles wholly above the warp's rows are skipped,
    // and so are tiles wholly below the window of its lowest row, r0 (so
    // below every row's).
    if ((!causal || k0 <= r0 + 15) &&
        (window == 0 || k0 + kBK > r0 - window + 1)) {
      const float* kst = ks + st * L::kK;
      const float* vst = vs + st * L::kV;

      // S = Q K^T, 16 rows x 64 keys per warp. The 8-deep sum of each
      // m16n8k8 product runs over head dims 2t and 2t + 1 of every
      // 8-column block where the PTX layout names t and t + 4: the same
      // permutation in A and B, so each lane reads both as one float2.
      // Each kSC x 8 head dims are summed from zero in the tensor cores and
      // the partial sums added in f32.
      float s[8][4];
#pragma unroll
      for (int kc = 0; kc < DP / 8; kc += kSC) {
        float part[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
        for (int kk = kc; kk < kc + kSC; ++kk) {
          const float2 qa = *reinterpret_cast<const float2*>(qw + 8 * kk);
          const float2 qc = *reinterpret_cast<const float2*>(
              qw + 8 * L::kQKStride + 8 * kk);
          uint32_t ah[4], al[4];
          split_tf32(qa.x, ah[0], al[0]);
          split_tf32(qc.x, ah[1], al[1]);
          split_tf32(qa.y, ah[2], al[2]);
          split_tf32(qc.y, ah[3], al[3]);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            const float2 kf = *reinterpret_cast<const float2*>(
                kst + (8 * nt + g) * L::kQKStride + 8 * kk + 2 * t);
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(kf.x, bh0, bl0);
            split_tf32(kf.y, bh1, bl1);
            mma_3xtf32(part[nt], ah, al, bh0, bh1, bl0, bl1);
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = kc == 0 ? part[j][e] : s[j][e] + part[j][e];
      }

      // Online softmax on the fragments: lane holds keys 8j + 2t + {0, 1}
      // of rows g (s[j][0..1]) and g + 8 (s[j][2..3]).
      // Masked: a ragged last tile, the warp's diagonal, or one reaching
      // below the window of the warp's highest row, r0 + 15.
      const bool masked = k0 + kBK > sk || (causal && k0 + kBK - 1 > r0) ||
                          (window > 0 && k0 < r0 + 16 - window);
      float mx_lo = kNegInf, mx_hi = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float a = s[j][e] * scale;
          float b = s[j][2 + e] * scale;
          if (masked) {
            const int ik = k0 + 8 * j + 2 * t + e;
            a = (ik < sk && (!causal || ik <= iq_lo) &&
                 (window == 0 || ik > iq_lo - window))
                    ? a
                    : kNegInf;
            b = (ik < sk && (!causal || ik <= iq_hi) &&
                 (window == 0 || ik > iq_hi - window))
                    ? b
                    : kNegInf;
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

      // O = O alpha + P V. The accumulator holds P at keys (2t, 2t + 1) of
      // each 8-key block, where the TF32 A layout wants (t, t + 4): the
      // key index is permuted instead (A's k = t is key 2t, k = t + 4 is
      // key 2t + 1) and V's B fragment is read from key rows 2t and
      // 2t + 1 to match, so P is used where it sits. The tile's P V is
      // summed from zero in the tensor cores and added to O in f32, so O's
      // running sum never passes through the tensor cores' accumulation.
      float pv[DP / 8][4];
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* vr = vst + (8 * j + 2 * t) * L::kVStride + g;
#pragma unroll
        for (int n = 0; n < DP / 8; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(vr[8 * n], bh0, bl0);
          split_tf32(vr[L::kVStride + 8 * n], bh1, bl1);
          mma_3xtf32(pv[n], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][0] = fmaf(acc[n][0], al_lo, pv[n][0]);
        acc[n][1] = fmaf(acc[n][1], al_lo, pv[n][1]);
        acc[n][2] = fmaf(acc[n][2], al_hi, pv[n][2]);
        acc[n][3] = fmaf(acc[n][3], al_hi, pv[n][3]);
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
      *reinterpret_cast<float2*>(ob + static_cast<int64_t>(iq_lo) * d + c) =
          make_float2(acc[n][0] / l_lo, acc[n][1] / l_lo);
    }
    if (iq_hi < sq) {
      *reinterpret_cast<float2*>(ob + static_cast<int64_t>(iq_hi) * d + c) =
          make_float2(acc[n][2] / l_hi, acc[n][3] / l_hi);
    }
  }
}

// ---- launch -----------------------------------------------------------------

template <typename T>
cudaError_t start(void (*kernel)(const T*, const T*, const T*, T*, int, int,
                                 int, int, float, int, int),
                  int threads, int bq, int smem, const void* q, const void* k,
                  const void* v, void* o, int bh, int group, int sq, int sk,
                  int d, float scale, int causal, int window,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + bq - 1) / bq;
  if (n_qt > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<dim3(bh, n_qt), threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, d, group, scale,
      causal, window);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int bh, int group, int sq, int sk, int d, float scale,
                       int causal, int window, cudaStream_t stream) {
  return start<float>(fa_fwd_f32_kernel<DP>, kF32Threads, kBQ32,
                      F32Tile<DP>::kSmemBytes, q, k, v, o, bh, group, sq, sk,
                      d, scale, causal, window, stream);
}

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int bh, int group, int sq, int sk, int d, float scale,
                        int causal, int window, cudaStream_t stream) {
  const int smem = 4 * kBK * DP * sizeof(bf16);  // K and V, two stages each
  return start<bf16>(fa_fwd_bf16_kernel<DP>, kMmaThreads, kBQ, smem, q, k, v,
                     o, bh, group, sq, sk, d, scale, causal, window, stream);
}

}  // namespace

// dtype codes: 0 f32, 1 bf16. q, o: (bh, sq, d); k, v: (bh / group, sk, d),
// contiguous, 16-byte aligned, d a multiple of 4 in [4, 128]. window: 0 for
// none, else W >= 1 on a causal call with sq == sk.
extern "C" int fa_fwd_launch(const void* q, const void* k, const void* v,
                             void* o, int bh, int group, int sq, int sk,
                             int d, float scale, int causal, int window,
                             int dtype, void* stream) {
  if (bh < 1 || group < 1 || bh % group || sq < 1 || sk < 1 || d < 4 ||
      d > 128 || d % 4 || window < 0 ||
      (window > 0 && (!causal || sq != sk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = d <= 64;
  switch (dtype) {
    case 0:
      return static_cast<int>(
          narrow ? launch_f32<64>(q, k, v, o, bh, group, sq, sk, d, scale,
                                  causal, window, st)
                 : launch_f32<128>(q, k, v, o, bh, group, sq, sk, d, scale,
                                   causal, window, st));
    case 1:
      return static_cast<int>(
          narrow ? launch_bf16<64>(q, k, v, o, bh, group, sq, sk, d, scale,
                                   causal, window, st)
                 : launch_bf16<128>(q, k, v, o, bh, group, sq, sk, d, scale,
                                    causal, window, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
