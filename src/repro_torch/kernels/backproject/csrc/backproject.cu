// iFDK factorized back-projection for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bp_kernel` in
// src/repro/kernels/backproject/kernel.py (launched by
// `backproject_dual_pallas`). It computes the same function:
//
//   out[i, j, 0, k] = sum_s w_s * bilinear(Q^T_s, u_s, v_s(k))
//   out[i, j, 1, k] = sum_s w_s * bilinear(Q^T_s, u_s, (N_v - 1) - v_s(k))
//
// with, per voxel column (i, j) and projection s (parameter row p, 13 f32:
// the 3x4 matrix row-major plus the stream codec's decode scale):
//   x0 = p0 i + p1 j + p3,  y0 = p4 i + p5 j + p7,  z = p8 i + p9 j + p11
//   f = 1/z,  u = x0 f,  w = f f p12,  v(k) = (y0 + p6 k) f
// and a zero-outside 4-tap bilinear gather from the transposed projection
// Q^T_s (N_u rows, N_v contiguous columns), each tap upcast to f32.
//
// What bounds it on an H100: the arithmetic the function needs (about 15.5
// f32 operations per voxel update at the RabbitCT size, counted in
// chip_smoke.py with the column terms once per column) over 67 TFLOP/s,
// far above the bytes bound (Q^T read once + the volume written once over
// 3.35 TB/s). The first port of this kernel ran at 5 % of that bound,
// held inside the SM, not by HBM (halving the wire bytes bought nothing):
// every lane recomputed its column's terms, a true division among them,
// for each voxel pair, and every tap was a scattered global load with
// 64-bit address arithmetic and four bound tests. Computing the column
// terms once per block alone does not remove it: this kernel with a
// staging budget of 0, which gathers every tap from global memory, is
// barely faster than the first port with a 16-bit wire and slower with
// f32 (PERF.md §6). The scattered tap loads were the cost.
//
// Design. The Pallas grid keeps an output tile resident in VMEM and sums
// over a sequential projection-batch grid axis; Hopper blocks run in
// parallel and in no order, so here a block owns a tile of kTI x kTJ
// columns x kTK values of k, loops over ALL projections with the front and
// mirror accumulators of its pairs in registers, and writes each output
// element once: no atomics, and the sum order is fixed (projection 0
// first, as in the oracles), so results are deterministic. Per projection:
//
// - Column terms once per (column, projection) per block: x0, y0, z, 1/z,
//   u, w and the row fraction are made by one thread each, two projections
//   ahead, into a table in shared memory that the warps read; only v(k)
//   and the gathers are per pair. Warp w owns kTI kTJ / kWarps columns and
//   lane l the k = k0 + l + 32 e, so a warp's gathers for one column walk
//   the contiguous N_v axis of two adjacent Q^T rows.
// - A (column, projection) whose two tap rows both miss the detector is
//   skipped as a whole, by a branch uniform across the warp (11.5 % of
//   pair-projections at RabbitCT).
// - Taps come from shared memory. The tile's footprint on Q^T_s -- u and
//   v are ratios of affine functions of (i, j, k) with z > 0, so their
//   extremes lie at the tile's 8 corners; one pixel of margin, clipped to
//   the detector -- is two boxes, front and mirror. They are staged with a
//   ring of one more pixel, zero where it leaves the detector, by cp.async
//   into a two-buffer ring, so that projection s + 1 loads while s is
//   gathered; the gathers then need no bound tests and use 32-bit offsets.
//   A gather with no tap on the detector reads a clamped column and adds
//   w * 0, exactly what skipping it would add, so the gathers carry no
//   branch and the compiler overlaps their shared loads (a branch per
//   gather kept them from overlapping).
//   Copies are 16, 8 or 4 bytes, the widest that divides the row pitch of
//   Q^T and its start, or single elements where none does.
// - A (tile, projection) whose boxes exceed the buffer, or whose z changes
//   sign over the tile, gathers that projection from global memory in the
//   same kernel with the same arithmetic and order, counted for the
//   caller (chip_smoke.py prints their share at RabbitCT).
//
// Offsets into Q^T and the volume are 64-bit: the paper's 4K problem holds
// 1.7e10 samples. The bilinear weights are explicit f32 arithmetic; the
// texture unit's 8-bit fractions cannot meet the f32 tolerance.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (no fast-math:
// 1/z must be a true division). Tolerance against the plain torch
// version: nvcc contracts a*b+c into FMAs, and in the coordinate chain
// that moves u or v by an ulp -- 1.2e-4 pixel at a 1248-pixel detector --
// which, times the gradient of a ramp-filtered projection, moved the 512^3
// result by 5.8e-5 of its max on an H100. So the coordinates (x0, y0, z,
// 1/z, u, w, v and the mirror v~) are computed with the _rn intrinsics,
// which are never contracted and round each operation as torch does. The
// taps, weights and accumulation may still use FMAs: that costs relative
// round-off of ~1e-7 per term, well inside the 1e-5 bound. The bilinear
// interpolation is continuous across pixel edges, so a floor() that lands
// on the other side of an edge costs round-off only.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

namespace {

constexpr int kParams = 13;  // 12 matrix entries + codec decode scale

__device__ __forceinline__ float fp8_to_float(unsigned char raw,
                                              __nv_fp8_interpretation_t kind) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(raw, kind)));
}

// A tap upcast to f32: from global memory through the read-only path
// (`load_tap`), or from shared memory (`smem_tap`).
template <typename T>
__device__ __forceinline__ float load_tap(const T* p);
template <typename T>
__device__ __forceinline__ float smem_tap(const T* p);

template <>
__device__ __forceinline__ float load_tap<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float smem_tap<float>(const float* p) {
  return *p;
}
template <>
__device__ __forceinline__ float load_tap<__half>(const __half* p) {
  return __half2float(__ldg(p));
}
template <>
__device__ __forceinline__ float smem_tap<__half>(const __half* p) {
  return __half2float(*p);
}
template <>
__device__ __forceinline__ float load_tap<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
template <>
__device__ __forceinline__ float smem_tap<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <>
__device__ __forceinline__ float load_tap<__nv_fp8_e4m3>(
    const __nv_fp8_e4m3* p) {
  return fp8_to_float(__ldg(reinterpret_cast<const unsigned char*>(p)),
                      __NV_E4M3);
}
template <>
__device__ __forceinline__ float smem_tap<__nv_fp8_e4m3>(
    const __nv_fp8_e4m3* p) {
  return fp8_to_float(*reinterpret_cast<const unsigned char*>(p), __NV_E4M3);
}
template <>
__device__ __forceinline__ float load_tap<__nv_fp8_e5m2>(
    const __nv_fp8_e5m2* p) {
  return fp8_to_float(__ldg(reinterpret_cast<const unsigned char*>(p)),
                      __NV_E5M2);
}
template <>
__device__ __forceinline__ float smem_tap<__nv_fp8_e5m2>(
    const __nv_fp8_e5m2* p) {
  return fp8_to_float(*reinterpret_cast<const unsigned char*>(p), __NV_E5M2);
}

// Theorems 2/3: the per-(column, projection) terms. The coordinate chain is
// rounded once per operation, exactly as the plain version computes it:
// the _rn intrinsics are never contracted into FMAs (see the note above).
struct ColumnTerms {
  float y0, f, w, u, dr;
  int r0;
};

__device__ __forceinline__ ColumnTerms column_terms(const float* p, float fi,
                                                    float fj) {
  const float x0 =
      __fadd_rn(__fadd_rn(__fmul_rn(p[0], fi), __fmul_rn(p[1], fj)), p[3]);
  const float y0 =
      __fadd_rn(__fadd_rn(__fmul_rn(p[4], fi), __fmul_rn(p[5], fj)), p[7]);
  const float z =
      __fadd_rn(__fadd_rn(__fmul_rn(p[8], fi), __fmul_rn(p[9], fj)), p[11]);
  const float f = __fdiv_rn(1.0f, z);
  const float u = __fmul_rn(x0, f);
  const float w = __fmul_rn(__fmul_rn(f, f), p[12]);  // T3 weight x scale
  const float r0f = floorf(u);
  return {y0, f, w, u, u - r0f, static_cast<int>(r0f)};
}

// v(k), affine in k.
__device__ __forceinline__ float v_of(float y0, float p6, float fk, float f) {
  return __fmul_rn(__fadd_rn(y0, __fmul_rn(p6, fk)), f);
}

// Zero-outside bilinear sample at row coordinate r0 + dr (u) and column
// coordinate v, from the two tap rows row0 = Q^T_s[r0], row1 = row0 + nv.
// Same operation order as the plain version: taps (r0,c0), (r0,c0+1),
// (r0+1,c0), (r0+1,c0+1), summed left to right. A tap is read only when
// its row is in [0, nu) (r0ok, r1ok) and its column in [0, nv).
template <typename T>
__device__ __forceinline__ float bilinear(const T* row0, const T* row1,
                                          bool r0ok, bool r1ok, float dr,
                                          float v, int nv) {
  const float c0f = floorf(v);
  const float dc = v - c0f;
  const int c0 = static_cast<int>(c0f);
  const bool c0ok = static_cast<unsigned>(c0) < static_cast<unsigned>(nv);
  const bool c1ok = static_cast<unsigned>(c0 + 1) < static_cast<unsigned>(nv);
  const float t00 =
      (r0ok && c0ok) ? load_tap(row0 + c0) * ((1.f - dr) * (1.f - dc)) : 0.f;
  const float t01 =
      (r0ok && c1ok) ? load_tap(row0 + c0 + 1) * ((1.f - dr) * dc) : 0.f;
  const float t10 =
      (r1ok && c0ok) ? load_tap(row1 + c0) * (dr * (1.f - dc)) : 0.f;
  const float t11 =
      (r1ok && c1ok) ? load_tap(row1 + c0 + 1) * (dr * dc) : 0.f;
  return t00 + t01 + t10 + t11;
}

// ---- the kernel ------------------------------------------------------------

// A block's tile is kTI x kTJ columns x kTK values of k, a template
// parameter of the kernel: the compiled tiles are kTiles (`bp_tiles` lists
// them; index 0 is the default). kTK is a multiple of 32 (a lane owns
// k = k0 + l + 32 e) and kTI kTJ a multiple of kWarps (a warp owns
// kTI kTJ / kWarps columns). A block has kWarps warps; kPrep projections'
// terms and boxes are made at once.
constexpr int kWarps = 8;
constexpr int kPrep = 2;
struct TileShape {
  int ti, tj, tk;
};
constexpr TileShape kTiles[] = {{8, 8, 64}, {8, 8, 32}, {16, 8, 32},
                                {4, 8, 64}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);
// The default staging budget, both buffers of the ring together, in Q^T
// pixels: 104 KB in f32 (two blocks per SM), 52 KB in 16-bit wire types
// and 26 KB in fp8 (three).
constexpr int kStagePixels = 26 * 1024;

// Blocks per SM the register cap is set for. Narrow wire types stage half
// the bytes or less at the default budget, so three blocks fit an SM's
// shared memory: 85 registers a thread (a few bytes spill with 32
// accumulators). An f32 block's default staging allows two; a tile with
// 16 accumulators a thread gets the cap of two blocks (128 registers),
// one with 32 none (the default tile's f32 kernel holds 1 block's worth).
template <typename T, int TI, int TJ, int TK>
constexpr int min_blocks() {
  return sizeof(T) < 4 ? 3 : ((TI * TJ / kWarps) * (TK / 32) <= 8 ? 2 : 1);
}

struct Box {
  int rlo, rows;  // first staged row of Q^T_s and the count (0: empty)
  int cf, cm;     // first staged column of the front and the mirror box
  int pitch;      // elements per staged row (a multiple of the copy width)
  int direct;     // 1: gather this projection from global memory
  float p6;
  int pad;
};

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int bytes, bool valid) {
  const int n = valid ? bytes : 0;  // 0: zero-fill, nothing is read
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  } else if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n));
  }
}

template <int N>
struct RawOf;
template <>
struct RawOf<1> {
  using type = unsigned char;
};
template <>
struct RawOf<2> {
  using type = unsigned short;
};
template <>
struct RawOf<4> {
  using type = unsigned int;
};

// Warp w owns columns [w * kColsPerWarp, (w + 1) * kColsPerWarp) of the
// block's tile (i fastest across tiles, j within), lane l the
// k = k0 + l + 32 e, e < kTK / 32. Registers are capped by min_blocks.
template <typename T, int kTI, int kTJ, int kTK>
__global__ void __launch_bounds__(kWarps * 32,
                                  min_blocks<T, kTI, kTJ, kTK>())
bp_dual_kernel(const float* __restrict__ params, const T* __restrict__ qt,
               float* __restrict__ out, int n_proj, int nu, int nv, int nx,
               int ny, int nzh, int tiles_y, int n_ktiles, int buf_elems,
               int vec_bytes, unsigned long long* __restrict__ direct_count) {
  constexpr int kCols = kTI * kTJ;
  constexpr int kThreads = kWarps * 32;
  constexpr int kColsPerWarp = kCols / kWarps;
  constexpr int kLaneK = kTK / 32;
  static_assert(kCols % kWarps == 0 && kTK % 32 == 0 && 8 * kPrep <= 32, "");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* bufs = reinterpret_cast<T*>(smem_raw);  // [2][buf_elems]
  __shared__ float4 tf[2][kPrep][kCols];     // y0, f, w, dr per column
  __shared__ int tr[2][kPrep][kCols];        // r0 per column
  __shared__ Box box[2][kPrep];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;
  const int kt = static_cast<int>(blockIdx.x % n_ktiles);
  const int ct = static_cast<int>(blockIdx.x / n_ktiles);
  const int i0 = (ct / tiles_y) * kTI;
  const int j0 = (ct % tiles_y) * kTJ;
  const int k0 = kt * kTK;
  const int i_hi = min(i0 + kTI - 1, nx - 1);
  const int j_hi = min(j0 + kTJ - 1, ny - 1);
  const int k_hi = min(k0 + kTK - 1, nzh - 1);
  const float vmax = static_cast<float>(nv - 1);
  const int64_t plane = static_cast<int64_t>(nu) * nv;
  // Elements per copy (a power of two); 1 with vec_bytes 0 (plain copies).
  const int vec_e = vec_bytes > 0 ? vec_bytes / static_cast<int>(sizeof(T)) : 1;

  // Column terms and boxes of projections [c kPrep, (c + 1) kPrep) into
  // table c & 1: one (column, projection) per thread; the last warp's
  // lanes take one corner of the tile's (i, j, k) box each.
  auto prepare = [&](int c) {
    const int t = c & 1;
    for (int idx = tid; idx < kPrep * kCols; idx += kThreads) {
      const int q = idx / kCols;
      const int col = idx % kCols;
      const int s = c * kPrep + q;
      if (s >= n_proj) break;
      const ColumnTerms cterm = column_terms(
          params + static_cast<int64_t>(s) * kParams,
          static_cast<float>(i0 + col / kTJ),
          static_cast<float>(j0 + col % kTJ));
      tf[t][q][col] = make_float4(cterm.y0, cterm.f, cterm.w, cterm.dr);
      tr[t][q][col] = cterm.r0;
    }
    if (warp != kWarps - 1 || lane >= 8 * kPrep) return;
    const int q = lane / 8;
    const int s = min(c * kPrep + q, n_proj - 1);
    const float* p = params + static_cast<int64_t>(s) * kParams;
    const float fi = static_cast<float>((lane & 1) ? i_hi : i0);
    const float fj = static_cast<float>((lane & 2) ? j_hi : j0);
    const float fk = static_cast<float>((lane & 4) ? k_hi : k0);
    const float z =
        __fadd_rn(__fadd_rn(__fmul_rn(p[8], fi), __fmul_rn(p[9], fj)), p[11]);
    const ColumnTerms cterm = column_terms(p, fi, fj);
    const float v = v_of(cterm.y0, p[6], fk, cterm.f);
    float umin = cterm.u, umax = cterm.u, vmin = v, vmx = v;
    int zpos = z > 0.f;
    constexpr unsigned kMask = 8 * kPrep == 32 ? 0xffffffffu
                                               : (1u << (8 * kPrep)) - 1u;
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {
      umin = fminf(umin, __shfl_xor_sync(kMask, umin, off));
      umax = fmaxf(umax, __shfl_xor_sync(kMask, umax, off));
      vmin = fminf(vmin, __shfl_xor_sync(kMask, vmin, off));
      vmx = fmaxf(vmx, __shfl_xor_sync(kMask, vmx, off));
      zpos &= __shfl_xor_sync(kMask, zpos, off);
    }
    if (lane % 8) return;
    // The footprint rule (`footprint_boxes` in kernel.py): a pair's taps
    // lie in [floor(x), floor(x) + 1] per axis, and u, v, v~ take their
    // extremes over the tile at its corners; one pixel of margin, clipped
    // to the detector. Staged with a ring of one more pixel (zero where it
    // leaves the detector), so that the gathers of every pair with a tap on
    // the detector stay inside and need no bound tests.
    auto lo = [](float x, int n) {
      return static_cast<int>(
          fminf(fmaxf(floorf(x) - 1.f, 0.f), static_cast<float>(n)));
    };
    auto hi = [](float x, int n) {
      return static_cast<int>(
          fmaxf(fminf(floorf(x) + 2.f, static_cast<float>(n - 1)), -1.f));
    };
    const int rlo = lo(umin, nu), rhi = hi(umax, nu);
    const int cflo = lo(vmin, nv), cfhi = hi(vmx, nv);
    const int cmlo = lo(__fsub_rn(vmax, vmx), nv);
    const int cmhi = hi(__fsub_rn(vmax, vmin), nv);
    const bool front = cflo <= cfhi, mirror = cmlo <= cmhi;
    Box b = {0, 0, 0, 0, 0, 0, p[6], 0};
    if (!zpos) {
      b.direct = 1;  // z changes sign over the tile: no corner rule
    } else if (rlo <= rhi && (front || mirror)) {
      b.rlo = rlo - 1;
      b.rows = rhi - rlo + 3;
      b.cf = (cflo - 1) & -vec_e;  // aligned down to the copy width
      b.cm = (cmlo - 1) & -vec_e;
      const int width =
          max(front ? cfhi + 2 - b.cf : 0, mirror ? cmhi + 2 - b.cm : 0);
      b.pitch = (width + vec_e - 1) & -vec_e;
      b.direct = 2 * b.rows * b.pitch > buf_elems;
    }
    box[t][q] = b;
    if (b.direct && c * kPrep + q < n_proj) atomicAdd(direct_count, 1ULL);
  };

  // Issue the copies of projection s's two boxes into buffer `buf`: each
  // warp takes rows, its lanes the copies along a row.
  auto stage = [&](int s, T* buf) {
    if (s >= n_proj) return;
    const Box b = box[(s / kPrep) & 1][s % kPrep];
    if (b.direct || b.rows == 0) return;
    const T* q = qt + static_cast<int64_t>(s) * plane;
    const int cpr = b.pitch / vec_e;
    for (int rr = warp; rr < 2 * b.rows; rr += kWarps) {
      const int half = rr >= b.rows;
      const int row = b.rlo + rr - half * b.rows;
      const bool rowok = row >= 0 && row < nu;
      const int c0 = half ? b.cm : b.cf;
      T* drow = buf + rr * b.pitch;
      const T* srow = q + static_cast<int64_t>(rowok ? row : 0) * nv;
      for (int c = lane; c < cpr; c += 32) {
        const int col = c0 + c * vec_e;
        const bool ok = rowok && col >= 0 && col < nv;
        if (vec_bytes > 0) {
          cp_async(static_cast<uint32_t>(
                       __cvta_generic_to_shared(drow + c * vec_e)),
                   ok ? srow + col : qt, vec_bytes, ok);
        } else {
          using Raw = typename RawOf<sizeof(T)>::type;
          reinterpret_cast<Raw*>(drow)[c] =
              ok ? reinterpret_cast<const Raw*>(srow)[col] : Raw(0);
        }
      }
    }
  };

  float acc_f[kColsPerWarp][kLaneK], acc_b[kColsPerWarp][kLaneK];
#pragma unroll
  for (int cc = 0; cc < kColsPerWarp; ++cc)
#pragma unroll
    for (int e = 0; e < kLaneK; ++e) acc_f[cc][e] = acc_b[cc][e] = 0.f;

  prepare(0);
  prepare(1);
  __syncthreads();
  stage(0, bufs);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int s = 0; s < n_proj; ++s) {
    // Projection s + 1 loads while s is gathered; the terms and boxes of
    // the step after next are made meanwhile.
    stage(s + 1, bufs + ((s + 1) & 1) * buf_elems);
    asm volatile("cp.async.commit_group;\n" ::);
    if (s % kPrep == 0 && s > 0) prepare(s / kPrep + 1);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    const int t = (s / kPrep) & 1;
    const int q = s % kPrep;
    const Box b = box[t][q];
    if (b.direct) {
#pragma unroll
      for (int cc = 0; cc < kColsPerWarp; ++cc) {
        const int col = warp * kColsPerWarp + cc;
        if (i0 + col / kTJ >= nx || j0 + col % kTJ >= ny) continue;  // per warp
        const float4 t4 = tf[t][q][col];
        const int r0 = tr[t][q][col];
        if (r0 < -1 || r0 >= nu) continue;  // both tap rows off: all 0
        const T* row0 = qt + static_cast<int64_t>(s) * plane +
                        static_cast<int64_t>(r0) * nv;
        const T* row1 = row0 + nv;
#pragma unroll
        for (int e = 0; e < kLaneK; ++e) {
          const float v =
              v_of(t4.x, b.p6, static_cast<float>(k0 + lane + 32 * e), t4.y);
          const float vm = __fsub_rn(vmax, v);  // Theorem-1 mirror
          acc_f[cc][e] += t4.z * bilinear(row0, row1, r0 >= 0, r0 + 1 < nu,
                                          t4.w, v, nv);
          acc_b[cc][e] += t4.z * bilinear(row0, row1, r0 >= 0, r0 + 1 < nu,
                                          t4.w, vm, nv);
        }
      }
    } else if (b.rows > 0) {
      // Staged: rows r0, r0 + 1 and columns c0, c0 + 1 of every gather with
      // a tap on the detector lie in the boxes, zero where they leave it.
      // The other gathers read a clamped column and add w * 0 -- exactly
      // what skipping them adds -- so the gathers have no branches.
      const T* fb = bufs + (s & 1) * buf_elems;
      const T* mb = fb + b.rows * b.pitch;
#pragma unroll
      for (int cc = 0; cc < kColsPerWarp; ++cc) {
        const int col = warp * kColsPerWarp + cc;
        if (i0 + col / kTJ >= nx || j0 + col % kTJ >= ny) continue;  // per warp
        const float4 t4 = tf[t][q][col];
        const int r0 = tr[t][q][col];
        if (r0 < -1 || r0 >= nu) continue;  // both tap rows off: all 0
        const float y0 = t4.x, f = t4.y, w = t4.z, dr = t4.w;
        const int off = (r0 - b.rlo) * b.pitch;
        const T* rows[2] = {fb + off, mb + off};
        const int c_lo[2] = {b.cf, b.cm};
#pragma unroll
        for (int e = 0; e < kLaneK; ++e) {
          const int k = k0 + lane + 32 * e;
          const float v = v_of(y0, b.p6, static_cast<float>(k), f);
          const float vs[2] = {v, __fsub_rn(vmax, v)};  // Theorem-1 mirror
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float c0f = floorf(vs[h]);
            const float dc = vs[h] - c0f;
            const int c0 = static_cast<int>(c0f);
            const bool on = static_cast<unsigned>(c0 + 1) <=
                                static_cast<unsigned>(nv) && k <= k_hi;
            const T* p = rows[h] + min(max(c0 - c_lo[h], 0), b.pitch - 2);
            const float sum = smem_tap(p) * ((1.f - dr) * (1.f - dc)) +
                              smem_tap(p + 1) * ((1.f - dr) * dc) +
                              smem_tap(p + b.pitch) * (dr * (1.f - dc)) +
                              smem_tap(p + b.pitch + 1) * (dr * dc);
            if (h == 0) {
              acc_f[cc][e] += w * (on ? sum : 0.f);
            } else {
              acc_b[cc][e] += w * (on ? sum : 0.f);
            }
          }
        }
      }
    }
    __syncthreads();  // buffer s & 1 and its table entries are consumed
  }

#pragma unroll
  for (int cc = 0; cc < kColsPerWarp; ++cc) {
    const int col = warp * kColsPerWarp + cc;
    const int i = i0 + col / kTJ;
    const int j = j0 + col % kTJ;
    if (i >= nx || j >= ny) continue;
    const int64_t base = (static_cast<int64_t>(i) * ny + j) * 2 * nzh;
#pragma unroll
    for (int e = 0; e < kLaneK; ++e) {
      const int k = k0 + lane + 32 * e;
      if (k <= k_hi) {
        out[base + k] = acc_f[cc][e];
        out[base + nzh + k] = acc_b[cc][e];
      }
    }
  }
}

// The largest copy width in {16, 8, 4} bytes that divides both the row
// pitch of Q^T and its start; 0 (element copies) if none does.
template <typename T>
int copy_width(const void* qt, int nv) {
  const int row_bytes = nv * static_cast<int>(sizeof(T));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(qt);
  for (int b = 16; b >= 4; b /= 2) {
    if (row_bytes % b == 0 && addr % b == 0) return b;
  }
  return 0;
}

template <typename T, int kTI, int kTJ, int kTK>
cudaError_t launch_tile(const float* params, const void* qt, float* out,
                        int n_proj, int nu, int nv, int nx, int ny, int nzh,
                        int stage_bytes, unsigned long long* direct_count,
                        cudaStream_t stream) {
  const int tiles_y = (ny + kTJ - 1) / kTJ;
  const int n_ktiles = (nzh + kTK - 1) / kTK;
  const int64_t blocks =
      static_cast<int64_t>((nx + kTI - 1) / kTI) * tiles_y * n_ktiles;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  if (stage_bytes < 0) {
    stage_bytes = kStagePixels * static_cast<int>(sizeof(T));
  }
  // Two buffers, each 16-byte aligned.
  const int buf_elems = stage_bytes / 2 / 16 * 16 / static_cast<int>(sizeof(T));
  const int smem = 2 * buf_elems * static_cast<int>(sizeof(T));
  auto kernel = bp_dual_kernel<T, kTI, kTJ, kTK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), dim3(32, kWarps), smem, stream>>>(
      params, static_cast<const T*>(qt), out, n_proj, nu, nv, nx, ny, nzh,
      tiles_y, n_ktiles, buf_elems, copy_width<T>(qt, nv), direct_count);
  return cudaGetLastError();
}

template <typename T, int kTI, int kTJ, int kTK>
cudaError_t static_smem_tile(int* bytes) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      cudaFuncGetAttributes(&attr, bp_dual_kernel<T, kTI, kTJ, kTK>);
  *bytes = static_cast<int>(attr.sharedSizeBytes);
  return err;
}

// One instantiation per compiled tile; `tile` indexes kTiles. CALL takes
// the tile's (TI, TJ, TK); BP_APPLY expands BP_TILE before the call.
#define BP_TILE(t) kTiles[t].ti, kTiles[t].tj, kTiles[t].tk
#define BP_APPLY(M, ...) M(__VA_ARGS__)
#define BP_TILE_CASES(CALL)            \
  case 0:                              \
    return BP_APPLY(CALL, BP_TILE(0)); \
  case 1:                              \
    return BP_APPLY(CALL, BP_TILE(1)); \
  case 2:                              \
    return BP_APPLY(CALL, BP_TILE(2)); \
  case 3:                              \
    return BP_APPLY(CALL, BP_TILE(3)); \
  default:                             \
    return cudaErrorInvalidValue;
static_assert(kNumTiles == 4, "BP_TILE_CASES has a case for every tile");

template <typename T>
cudaError_t launch(int tile, const float* params, const void* qt, float* out,
                   int n_proj, int nu, int nv, int nx, int ny, int nzh,
                   int stage_bytes, unsigned long long* direct_count,
                   cudaStream_t stream) {
#define BP_LAUNCH(TI, TJ, TK)                                              \
  launch_tile<T, TI, TJ, TK>(params, qt, out, n_proj, nu, nv, nx, ny, nzh, \
                             stage_bytes, direct_count, stream)
  switch (tile) { BP_TILE_CASES(BP_LAUNCH) }
#undef BP_LAUNCH
}

template <typename T>
cudaError_t static_smem(int tile, int* bytes) {
#define BP_STATIC(TI, TJ, TK) static_smem_tile<T, TI, TJ, TK>(bytes)
  switch (tile) { BP_TILE_CASES(BP_STATIC) }
#undef BP_STATIC
}

}  // namespace

// The compiled tiles, (columns along i, along j, values of k) each, into
// tiles[3 t .. 3 t + 2]; returns their count. Index 0 is the default.
extern "C" int bp_tiles(int* tiles) {
  for (int t = 0; t < kNumTiles; ++t) {
    tiles[3 * t] = kTiles[t].ti;
    tiles[3 * t + 1] = kTiles[t].tj;
    tiles[3 * t + 2] = kTiles[t].tk;
  }
  return kNumTiles;
}

// The default staging budget in Q^T pixels (both buffers of the ring).
extern "C" int bp_stage_pixels() { return kStagePixels; }

// The largest shared memory a block may opt in to on `device`
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), in bytes, into *bytes.
extern "C" int bp_smem_optin(int device, int* bytes) {
  return static_cast<int>(cudaDeviceGetAttribute(
      bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}

#define BP_WIRE_CASES(CALL)                 \
  switch (wire_dtype) {                     \
    case 0:                                 \
      return static_cast<int>(CALL(float)); \
    case 1:                                 \
      return static_cast<int>(CALL(__nv_bfloat16)); \
    case 2:                                 \
      return static_cast<int>(CALL(__half)); \
    case 3:                                 \
      return static_cast<int>(CALL(__nv_fp8_e4m3)); \
    case 4:                                 \
      return static_cast<int>(CALL(__nv_fp8_e5m2)); \
    default:                                \
      return static_cast<int>(cudaErrorInvalidValue); \
  }

// The static shared memory of the instantiation (wire dtype, tile), in
// bytes, into *bytes (the column-term tables and the boxes).
extern "C" int bp_static_smem(int wire_dtype, int tile, int* bytes) {
#define BP_SMEM(T) static_smem<T>(tile, bytes)
  BP_WIRE_CASES(BP_SMEM)
#undef BP_SMEM
}

// Wire dtype codes: 0 f32, 1 bf16, 2 fp16, 3 fp8 e4m3, 4 fp8 e5m2; `tile`
// indexes the compiled tiles. stage_bytes < 0: the default staging budget
// (kStagePixels pixels).
extern "C" int bp_dual_launch(const float* params, const void* qt, float* out,
                              int n_proj, int nu, int nv, int nx, int ny,
                              int nzh, int wire_dtype, int tile,
                              int stage_bytes,
                              unsigned long long* direct_count, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BP_CALL(T)                                                        \
  launch<T>(tile, params, qt, out, n_proj, nu, nv, nx, ny, nzh, stage_bytes, \
            direct_count, st)
  BP_WIRE_CASES(BP_CALL)
#undef BP_CALL
}

extern "C" const char* bp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
