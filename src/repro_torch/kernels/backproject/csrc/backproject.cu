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
// 3.35 TB/s). It is held inside the SM, not by HBM: the first port (5 % of
// that bound) recomputed each column's terms for every pair and gathered
// every tap from global memory; the scattered tap loads were its cost
// (PERF.md §6). What is left is the shared-memory gather loop: per voxel
// pair 8 tap reads (each two wavefronts where v moves more than one pixel
// a step of k, as at 512^3) and ~49 instructions issued, beside the copies
// that stage each (tile, projection)'s footprint (~52 KB at 512^3 f32,
// 208 GB a launch from L2). Time at RabbitCT follows the warps an SM holds,
// the work each (warp, column, projection) step shares, and how well the
// copies hide behind the gathers (PERF.md §6 times each part alone).
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
//   u, w and the row fraction are made ahead into the projection's stage
//   record in shared memory, which the warps read; only v(k) and the
//   gathers are per pair. A block has kWarps = 32 warps; warp w owns
//   kTI kTJ / 32 columns and lane l the k = k0 + l + 32 e, so a warp's
//   gathers for one column walk the contiguous N_v axis of two adjacent
//   Q^T rows, and a lane shares a column's terms over kTK / 32 values of k
//   (4 in the default tile).
// - Taps come from shared memory. The tile's footprint on Q^T_s -- u and
//   v are ratios of affine functions of (i, j, k) with z > 0, so their
//   extremes lie at the tile's 8 corners; one pixel of margin, clipped to
//   the detector -- is two boxes, front and mirror. Where a box meets the
//   detector's edge it is staged with a ring of two more pixels, zeros.
//   Every gather then reads inside the boxes with no test: its row and
//   column are clamped to the box, and a gather that has no tap on the
//   detector lies beyond the box only on a side where the box meets the
//   detector's edge, so the clamp lands it on two zero pixels of the ring
//   and it adds w * 0, exactly what skipping it would add (a box side with
//   no pixel on the detector is staged from columns past it: all zeros).
//   Columns outside the volume and k beyond it gather too, into
//   accumulators that are never written. So the gathers carry no branch
//   and no test, and use 32-bit offsets. Where front and mirror lie side
//   by side (the tiles at the middle of the volume's k), one box spanning
//   both columns is staged, no wider than the two.
// - The stages form a ring with no block-wide barrier in the projection
//   loop: kRec records (`records`: 8 of 64 columns, 7 of 128), each with a
//   full and an empty mbarrier. A warp waits only on the full barrier of
//   the projection it is about to gather, and arrives on its empty barrier
//   when done. The making rotates over the warps: warp p mod 32 makes
//   projection p's record (terms, boxes) at the end of its step
//   p - (kRec - 2), once every warp is done with p - kRec, and places its
//   pixels in the staging right after projection p - 1's (at the start
//   where they would pass its end), so the staging holds as many
//   projections as fit, up to kRec - 2 ahead. It copies them once every
//   warp is done with the newest projection whose pixels were there: the
//   zero ring by 16-byte stores and each staged row on the detector by one
//   cp.async.bulk that completes its bytes on the full barrier (rows whose
//   pitch or start is not 16-byte aligned take cp.async copies of 8, 4 or
//   1 bytes, zero-filled). So warps drift apart as far as the staging
//   allows, the side work of a projection stalls one warp and not 32, and
//   the copies are in flight several steps ahead. A bulk copy costs the SM
//   ~30 ns beside the gathers whatever its size (PERF.md §6), so the rows
//   are as few as the boxes allow. The kernel counts the steps at which a
//   warp found its stage not yet full (`ring_waits`).
// - A (tile, projection) whose boxes, ringed on every side at one pitch,
//   exceed half the staging budget, or whose z changes sign over the tile,
//   gathers that projection from global memory in the same kernel with the
//   same arithmetic and order, counted for the caller (chip_smoke.py
//   prints their share at RabbitCT).
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
// staged taps are interpolated as three lerps (along v in rows r0 and
// r0 + 1, then along u) where the plain version weights four taps; that
// and the FMAs of the weights and accumulation cost relative round-off of
// ~1e-7 per term, well inside the 1e-5 bound. The bilinear interpolation
// is continuous across pixel edges, so a floor() that lands on the other
// side of an edge costs round-off only.

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
// kTI kTJ / kWarps columns). A block has kWarps warps, 1024 threads of at
// most 64 registers, one block an SM.
constexpr int kWarps = 32;
struct TileShape {
  int ti, tj, tk;
};
constexpr TileShape kTiles[] = {{8, 8, 128}, {16, 8, 128}, {16, 8, 64},
                                {8, 8, 64}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);
// The default staging budget, the whole ring's, in Q^T pixels: 208 KB in
// f32 (the SM's one block takes nearly all its shared memory), 104 KB in
// 16-bit wire types and 52 KB in fp8.
constexpr int kStagePixels = 52 * 1024;
// Pixels of zero ring staged around the footprint where it meets the
// detector's edge: a clamped gather reads two of them.
constexpr int kRing = 2;
// Stage records: as many as fit beside the default f32 staging in the
// 227 KiB (232,448 bytes) an H100 block may have, at most kMaxRecords.
constexpr int kMaxRecords = 8;
constexpr int kSmemOptin = 232448;
constexpr int kTileBytes = 48;  // sizeof(Tile)
__host__ __device__ constexpr int record_bytes(int cols) {
  return 20 * cols + 64;  // a Record and its two barriers
}
__host__ __device__ constexpr int records(int cols) {
  return (kSmemOptin - 4 * kStagePixels - kTileBytes) / record_bytes(cols) <
                 kMaxRecords
             ? (kSmemOptin - 4 * kStagePixels - kTileBytes) /
                   record_bytes(cols)
             : kMaxRecords;
}

struct Box {
  int rlo, rows;  // first staged row of Q^T_s and the count (0: empty)
  int cf, cm;     // first staged column of the front and the mirror box
  int pitch;      // elements per staged row (a multiple of the copy width)
  int direct;     // 1: gather this projection from global memory
  float p6;
  int moff;       // elements from the front box to the mirror box (0: one
                  // box holds the columns of both)
};

// One stage of the ring: a projection's column terms and boxes, and where
// its pixels lie in the staging.
template <int kCols>
struct Record {
  float4 tf[kCols];  // y0, f, w, dr per column
  int tr[kCols];     // r0 per column
  Box box;
  int off, size;  // its pixels: elements [off, off + size) of the staging
  int wait;       // the projection every warp must be done with first
  int seq;        // the projection whose stage this is, once placed
};

// What a block's warps share of its tile and launch.
struct Tile {
  int i0, j0, k0, i_hi, j_hi, k_hi;
  int nu, nv;
  int total;      // staging elements (both halves of the budget)
  int buf_elems;  // half of them: the largest box staged
  int vec_bytes, vec_e;
};
static_assert(sizeof(Tile) == kTileBytes, "");

template <int kCols, int kRec>
struct Ring {
  Record<kCols> rec[kRec];
  uint64_t full[kRec];   // the record and its pixels are in place
  uint64_t empty[kRec];  // every warp is done with the record
  Tile tile;
};

// ---- mbarrier and copy primitives (PTX, sm_90) ----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// An arrival that first adds `bytes` the phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits for the phase of parity `parity`. A wait of more than 2^34 cycles
// (~9 s; a whole launch at RabbitCT 1024^3 takes 0.7 s) is a fault of the
// ring: it traps, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const long long t0 = clock64();
  uint32_t done;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// One bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// that completes its bytes on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

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

// The footprint boxes of the tile on projection p (parameter row `p`),
// the rule of `footprint_boxes` in kernel.py. Called by all 32 lanes of a
// warp, lane & 7 taking one corner of the tile's (i, j, k) box; every lane
// returns the boxes.
__device__ __forceinline__ Box footprint(const float* p, const Tile& tl,
                                         int lane) {
  const float fi = static_cast<float>((lane & 1) ? tl.i_hi : tl.i0);
  const float fj = static_cast<float>((lane & 2) ? tl.j_hi : tl.j0);
  const float fk = static_cast<float>((lane & 4) ? tl.k_hi : tl.k0);
  const float z =
      __fadd_rn(__fadd_rn(__fmul_rn(p[8], fi), __fmul_rn(p[9], fj)), p[11]);
  const ColumnTerms cterm = column_terms(p, fi, fj);
  const float v = v_of(cterm.y0, p[6], fk, cterm.f);
  float umin = cterm.u, umax = cterm.u, vmin = v, vmx = v;
  int zpos = z > 0.f;
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
    umin = fminf(umin, __shfl_xor_sync(0xffffffffu, umin, off));
    umax = fmaxf(umax, __shfl_xor_sync(0xffffffffu, umax, off));
    vmin = fminf(vmin, __shfl_xor_sync(0xffffffffu, vmin, off));
    vmx = fmaxf(vmx, __shfl_xor_sync(0xffffffffu, vmx, off));
    zpos &= __shfl_xor_sync(0xffffffffu, zpos, off);
  }
  // A pair's taps lie in [floor(x), floor(x) + 1] per axis, and u, v, v~
  // take their extremes over the tile at its corners; one pixel of margin,
  // clipped to the detector. Staged with a ring of kRing more pixels, zero
  // where the box meets the detector's edge: the gathers of every pair
  // with a tap on the detector stay inside, and a clamped one lands on two
  // ring pixels (only a gather with no tap on the detector is clamped, and
  // only on a side where the box meets the edge).
  auto lo = [](float x, int n) {
    return static_cast<int>(
        fminf(fmaxf(floorf(x) - 1.f, 0.f), static_cast<float>(n)));
  };
  auto hi = [](float x, int n) {
    return static_cast<int>(
        fmaxf(fminf(floorf(x) + 2.f, static_cast<float>(n - 1)), -1.f));
  };
  const int nu = tl.nu, nv = tl.nv, vec_e = tl.vec_e;
  const float vmax = static_cast<float>(nv - 1);
  const int rlo = lo(umin, nu), rhi = hi(umax, nu);
  const int cflo = lo(vmin, nv), cfhi = hi(vmx, nv);
  const int cmlo = lo(__fsub_rn(vmax, vmx), nv);
  const int cmhi = hi(__fsub_rn(vmax, vmin), nv);
  const bool front = cflo <= cfhi, mirror = cmlo <= cmhi;
  Box b = {0, 0, 0, 0, 0, 0, p[6], 0};
  if (!zpos) {
    b.direct = 1;  // z changes sign over the tile: no corner rule
  } else if (rlo <= rhi && (front || mirror)) {
    // What is staged and what is gathered directly: both boxes with the
    // ring on every side, at one pitch, against half the budget.
    {
      const int cf = (cflo - kRing) & -vec_e, cm = (cmlo - kRing) & -vec_e;
      const int width = max(front ? cfhi + 1 + kRing - cf : 0,
                            mirror ? cmhi + 1 + kRing - cm : 0);
      b.direct = 2 * (rhi - rlo + 1 + 2 * kRing) *
                     ((width + vec_e - 1) & -vec_e) >
                 tl.buf_elems;
    }
    // The staged box: the ring only where it meets the detector's edge;
    // the first column aligned down to the copy width; a side with no
    // pixel on the detector staged from columns past it, all zero.
    b.rlo = rlo - (rlo == 0 ? kRing : 0);
    b.rows = rhi + (rhi == nu - 1 ? kRing : 0) + 1 - b.rlo;
    const int past = (nv + vec_e) & -vec_e;
    auto first = [&](int c) { return (c - (c == 0 ? kRing : 0)) & -vec_e; };
    auto end = [&](int c) { return c + 1 + (c == nv - 1 ? kRing : 0); };
    b.cf = front ? first(cflo) : past;
    b.cm = mirror ? first(cmlo) : past;
    const int wf = front ? end(cfhi) - b.cf : 0;
    const int wm = mirror ? end(cmhi) - b.cm : 0;
    b.pitch = (max(wf, wm) + vec_e - 1) & -vec_e;
    b.moff = b.rows * b.pitch;
    if (front && mirror) {
      // One box for both where it is no wider than the two: one copy a
      // row in place of two.
      const int c0 = min(b.cf, b.cm);
      const int pitch =
          (max(b.cf + wf, b.cm + wm) - c0 + vec_e - 1) & -vec_e;
      if (pitch <= 2 * b.pitch) {
        b.cf = b.cm = c0;
        b.pitch = pitch;
        b.moff = 0;
      }
    }
  }
  return b;
}

// Waits until every warp is done with projection q (q < 0: at once): the
// phase of q's use of its record's empty barrier. Every caller is past the
// release of q - kRec (the phase before), so the parity names q's.
template <int kRec>
__device__ __forceinline__ void wait_released(uint64_t* empty, int q) {
  if (q >= 0) mbar_wait(&empty[q % kRec], (q / kRec) & 1);
}

// The table of projection p, into record p % kRec, by one warp: the
// column terms (a lane a column), the boxes, and the place of its pixels
// in the staging: right after projection p - 1's, or at the start where
// they would pass its end. Returns the projection whose release frees that
// place (the newest one that overlaps it, at least p - kRec), or INT_MIN
// for a projection with nothing to copy, which this call marks full.
// Each lane arrives once on the record's full barrier here, once when the
// copies are issued.
template <typename T, int kTI, int kTJ, int kRec>
__device__ __forceinline__ int make_table(Ring<kTI * kTJ, kRec>* ring,
                                          const float* params, int p,
                                          int lane,
                                          unsigned long long* counts) {
  constexpr int kCols = kTI * kTJ;
  // Places are 16-byte aligned.
  constexpr int kGran = sizeof(T) < 16 ? 16 / static_cast<int>(sizeof(T)) : 1;
  const Tile& tl = ring->tile;
  Record<kCols>& rec = ring->rec[p % kRec];
  const float* pp = params + static_cast<int64_t>(p) * kParams;
  for (int col = lane; col < kCols; col += 32) {
    const ColumnTerms cterm =
        column_terms(pp, static_cast<float>(tl.i0 + col / kTJ),
                     static_cast<float>(tl.j0 + col % kTJ));
    rec.tf[col] = make_float4(cterm.y0, cterm.f, cterm.w, cterm.dr);
    rec.tr[col] = cterm.r0;
  }
  const Box b = footprint(pp, tl, lane);
  const int size =
      b.direct || b.rows == 0
          ? 0
          : ((b.moff ? 2 : 1) * b.rows * b.pitch + kGran - 1) / kGran * kGran;
  // Place it after projection p - 1's pixels (its record is final once
  // its seq reads p - 1).
  int off = 0;
  if (p > 0) {
    const volatile Record<kCols>& prev = ring->rec[(p - 1) % kRec];
    while (prev.seq != p - 1) {
    }
    __threadfence_block();
    off = prev.off + prev.size;
  }
  if (off + size > tl.total) off = 0;
  int wait = p - kRec;
  if (size > 0) {
    for (int q = p - 1; q > p - kRec && q >= 0; --q) {
      const volatile Record<kCols>& o = ring->rec[q % kRec];
      const int o_off = o.off, o_size = o.size;
      if (o_size > 0 && o_off < off + size && off < o_off + o_size) {
        wait = q;
        break;
      }
    }
  }
  __syncwarp();
  if (lane == 0) {
    rec.box = b;
    rec.off = off;
    rec.size = size;
    rec.wait = wait;
    if (b.direct) atomicAdd(counts, 1ULL);
    __threadfence_block();
    static_cast<volatile Record<kCols>&>(rec).seq = p;
  }
  __syncwarp();
  mbar_arrive(&ring->full[p % kRec]);
  if (size == 0) {
    mbar_arrive(&ring->full[p % kRec]);
    return INT_MIN;
  }
  return wait;
}

// The copies of projection p's boxes into its place in the staging, by
// the warp that made its table, once every warp is done with what was
// there: the zero ring by 16-byte stores and each staged row on the
// detector by one bulk copy that completes its bytes on the record's full
// barrier, or (a pitch or start that is not 16-byte aligned) cp.async
// copies of 8, 4 or 1 bytes, zero-filled off the detector.
template <typename T, int kTI, int kTJ, int kRec>
__device__ __forceinline__ void copy_boxes(Ring<kTI * kTJ, kRec>* ring,
                                           const T* qt, int p, int lane) {
  extern __shared__ __align__(16) unsigned char smem_raw[];  // the staging
  constexpr int kCols = kTI * kTJ;
  const Tile& tl = ring->tile;
  const Record<kCols>& rec = ring->rec[p % kRec];
  uint64_t* full = &ring->full[p % kRec];
  const Box b = rec.box;
  // The place was last read by the warps' gathers (generic proxy); order
  // those reads before the copies' writes (async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  T* buf = reinterpret_cast<T*>(smem_raw) + rec.off;
  const T* q = qt + static_cast<int64_t>(p) * tl.nu * tl.nv;
  const int nv = tl.nv;
  if (tl.vec_bytes == 16) {
    // A lane a staged row: the part on the detector by one bulk copy, the
    // ring around it (and a row off the detector) zeroed. Every bound is
    // a multiple of the 16-byte copy width.
    const int vec_e = tl.vec_e;
    uint32_t bytes = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int rr = lane; rr < (b.moff ? 2 : 1) * b.rows; rr += 32) {
        // staged row rr (the front box's rows, then the mirror's, if it
        // has its own): [c0, c1) of Q^T row `row`, [a, e) of it on the
        // detector
        const int half = rr >= b.rows;
        const int row = b.rlo + rr - half * b.rows;
        const int c0 = half ? b.cm : b.cf;
        const int c1 = c0 + b.pitch;
        const bool rowok = row >= 0 && row < tl.nu;
        const int a = rowok ? min(max(c0, 0), c1) : c1;
        const int e = rowok ? max(min(nv, c1), a) : c1;
        T* drow = buf + rr * b.pitch;
        if (pass == 0) {
          const uint4 zero = make_uint4(0, 0, 0, 0);
          for (int c = c0; c < a; c += vec_e) {
            *reinterpret_cast<uint4*>(drow + (c - c0)) = zero;
          }
          for (int c = e; c < c1; c += vec_e) {
            *reinterpret_cast<uint4*>(drow + (c - c0)) = zero;
          }
          bytes += static_cast<uint32_t>((e - a) * sizeof(T));
        } else if (e > a) {
          bulk_copy(drow + (a - c0), q + static_cast<int64_t>(row) * nv + a,
                    static_cast<uint32_t>((e - a) * sizeof(T)), full);
        }
      }
      if (pass == 0) mbar_arrive_expect_tx(full, bytes);
    }
    return;
  }
  const int vec_e = tl.vec_bytes > 0 ? tl.vec_e : 1;
  const int cpr = b.pitch / vec_e;
  for (int rr = 0; rr < (b.moff ? 2 : 1) * b.rows; ++rr) {
    const int half = rr >= b.rows;
    const int row = b.rlo + rr - half * b.rows;
    const bool rowok = row >= 0 && row < tl.nu;
    const int c0 = half ? b.cm : b.cf;
    T* drow = buf + rr * b.pitch;
    const T* srow = q + static_cast<int64_t>(rowok ? row : 0) * nv;
    for (int c = lane; c < cpr; c += 32) {
      const int col = c0 + c * vec_e;
      const bool ok = rowok && col >= 0 && col < nv;
      if (tl.vec_bytes > 0) {
        cp_async(smem_addr(drow + c * vec_e), ok ? srow + col : qt,
                 tl.vec_bytes, ok);
      } else {
        using Raw = typename RawOf<sizeof(T)>::type;
        reinterpret_cast<Raw*>(drow)[c] =
            ok ? reinterpret_cast<const Raw*>(srow)[col] : Raw(0);
      }
    }
  }
  if (tl.vec_bytes > 0) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                     "r"(smem_addr(full))
                 : "memory");
  } else {
    mbar_arrive(full);
  }
}

// Warp w owns columns [w * kColsPerWarp, (w + 1) * kColsPerWarp) of the
// block's tile (i fastest across tiles, j within), lane l the
// k = k0 + l + 32 e, e < kTK / 32. counts[0] gathers the (tile,
// projection) pairs gathered directly, counts[1] the (warp, projection)
// steps whose stage was not yet full when the warp came to it.
template <typename T, int kTI, int kTJ, int kTK>
__global__ void __launch_bounds__(kWarps * 32)
bp_dual_kernel(const float* __restrict__ params, const T* __restrict__ qt,
               float* __restrict__ out, int n_proj, int nu, int nv, int nx,
               int ny, int nzh, int tiles_y, int n_ktiles, int buf_elems,
               int vec_bytes, unsigned long long* __restrict__ counts) {
  constexpr int kCols = kTI * kTJ;
  constexpr int kColsPerWarp = kCols / kWarps;
  constexpr int kLaneK = kTK / 32;
  constexpr int kRec = records(kCols);
  // Projection p's table is made at the end of step p - kLead, once every
  // warp is done with p - kRec, two steps back.
  constexpr int kLead = kRec - 2;
  static_assert(kCols % kWarps == 0 && kTK % 32 == 0 && kRec >= 3 &&
                    kRec <= kWarps,
                "");
  // The staging, 2 buf_elems elements (copy_boxes places each projection's
  // pixels in it).
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ Ring<kCols, kRec> ring;

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int kt = static_cast<int>(blockIdx.x % n_ktiles);
  const int ct = static_cast<int>(blockIdx.x / n_ktiles);
  const int i0 = (ct / tiles_y) * kTI;
  const int j0 = (ct % tiles_y) * kTJ;
  const int k0 = kt * kTK;
  if (warp == 0 && lane == 0) {
    Tile& tl = ring.tile;
    tl.i0 = i0;
    tl.j0 = j0;
    tl.k0 = k0;
    tl.i_hi = min(i0 + kTI - 1, nx - 1);
    tl.j_hi = min(j0 + kTJ - 1, ny - 1);
    tl.k_hi = min(k0 + kTK - 1, nzh - 1);
    tl.nu = nu;
    tl.nv = nv;
    tl.total = 2 * buf_elems;
    tl.buf_elems = buf_elems;
    tl.vec_bytes = vec_bytes;
    // Elements per copy (a power of two); 1 with vec_bytes 0 (plain).
    tl.vec_e = vec_bytes > 0 ? vec_bytes / static_cast<int>(sizeof(T)) : 1;
    for (int r = 0; r < kRec; ++r) {
      mbar_init(&ring.full[r], 2 * 32);  // the making warp's lanes, twice
      mbar_init(&ring.empty[r], kWarps);
      ring.rec[r].seq = -1;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // This warp's projection whose copies wait for a release (-1: none).
  int pending = -1;
  auto make = [&](int p, int s) {
    const int wait = make_table<T, kTI, kTJ, kRec>(&ring, params, p, lane,
                                                   counts);
    if (wait == INT_MIN) return;
    if (wait <= s) {
      wait_released<kRec>(ring.empty, wait);
      copy_boxes<T, kTI, kTJ, kRec>(&ring, qt, p, lane);
    } else {
      pending = p;
    }
  };
  // The first kLead projections: warp p makes projection p.
  if (warp < kLead && warp < n_proj) make(warp, -1);

  const float vmax = static_cast<float>(nv - 1);
  float acc_f[kColsPerWarp][kLaneK], acc_b[kColsPerWarp][kLaneK];
  float fk[kLaneK];  // this lane's k
#pragma unroll
  for (int e = 0; e < kLaneK; ++e) {
    fk[e] = static_cast<float>(k0 + lane + 32 * e);
#pragma unroll
    for (int cc = 0; cc < kColsPerWarp; ++cc) acc_f[cc][e] = acc_b[cc][e] = 0.f;
  }

  // Projection s is record r = s % kRec in its (s / kRec)-th use: the
  // phase parity ph of both its barriers.
  unsigned waits = 0;
  for (int s = 0; s < n_proj; ++s) {
    const int r = s % kRec;
    const uint32_t ph = (s / kRec) & 1;
    if (!mbar_test(&ring.full[r], ph)) {
      ++waits;  // this warp caught up with the copies
      mbar_wait(&ring.full[r], ph);
    }
    const Record<kCols>& rec = ring.rec[r];
    const Box b = rec.box;
    if (b.direct) {
#pragma unroll
      for (int cc = 0; cc < kColsPerWarp; ++cc) {
        const int col = warp * kColsPerWarp + cc;
        if (i0 + col / kTJ >= nx || j0 + col % kTJ >= ny) continue;  // per warp
        const float4 t4 = rec.tf[col];
        const int r0 = rec.tr[col];
        if (r0 < -1 || r0 >= nu) continue;  // both tap rows off: all 0
        const T* row0 = qt + (static_cast<int64_t>(s) * nu + r0) * nv;
        const T* row1 = row0 + nv;
#pragma unroll
        for (int e = 0; e < kLaneK; ++e) {
          const float v = v_of(t4.x, b.p6, fk[e], t4.y);
          const float vm = __fsub_rn(vmax, v);  // Theorem-1 mirror
          acc_f[cc][e] += t4.z * bilinear(row0, row1, r0 >= 0, r0 + 1 < nu,
                                          t4.w, v, nv);
          acc_b[cc][e] += t4.z * bilinear(row0, row1, r0 >= 0, r0 + 1 < nu,
                                          t4.w, vm, nv);
        }
      }
    } else if (b.rows > 0) {
      // Staged: every gather clamped into the boxes, none tested (the
      // design note at the top); three lerps a gather.
      const T* fb = reinterpret_cast<const T*>(smem_raw) + rec.off;
      const T* mb = fb + b.moff;
#pragma unroll
      for (int cc = 0; cc < kColsPerWarp; ++cc) {
        const int col = warp * kColsPerWarp + cc;
        const float4 t4 = rec.tf[col];
        const int r0 = rec.tr[col];
        const float y0 = t4.x, f = t4.y, w = t4.z, dr = t4.w;
        // clamped before the offset: a column outside the volume may hold
        // any r0 (its sums are never written)
        const int off =
            (min(max(r0, b.rlo), b.rlo + b.rows - 2) - b.rlo) * b.pitch;
        const T* rows[2] = {fb + off, mb + off};
        const int c_lo[2] = {b.cf, b.cm};
#pragma unroll
        for (int e = 0; e < kLaneK; ++e) {
          const float v = v_of(y0, b.p6, fk[e], f);
          const float vs[2] = {v, __fsub_rn(vmax, v)};  // Theorem-1 mirror
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float c0f = floorf(vs[h]);
            const float dc = vs[h] - c0f;
            const int c0 = static_cast<int>(c0f);
            const T* p = rows[h] +
                         (min(max(c0, c_lo[h]), c_lo[h] + b.pitch - 2) - c_lo[h]);
            const float t00 = smem_tap(p), t01 = smem_tap(p + 1);
            const float t10 = smem_tap(p + b.pitch);
            const float t11 = smem_tap(p + b.pitch + 1);
            const float a0 = fmaf(dc, t01 - t00, t00);
            const float a1 = fmaf(dc, t11 - t10, t10);
            const float sum = fmaf(dr, a1 - a0, a0);
            if (h == 0) {
              acc_f[cc][e] = fmaf(w, sum, acc_f[cc][e]);
            } else {
              acc_b[cc][e] = fmaf(w, sum, acc_b[cc][e]);
            }
          }
        }
      }
    }
    // Done with s: release its record; then this warp's share of the
    // making: copies that waited for s, and the table of s + kLead.
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[r]);
    if (pending >= 0 && ring.rec[pending % kRec].wait <= s) {
      wait_released<kRec>(ring.empty, ring.rec[pending % kRec].wait);
      copy_boxes<T, kTI, kTJ, kRec>(&ring, qt, pending, lane);
      pending = -1;
    }
    const int next = s + kLead;
    if (next < n_proj && next % kWarps == warp) {
      wait_released<kRec>(ring.empty, next - kRec);  // its record is free
      make(next, s);
    }
  }
  if (lane == 0 && waits > 0) atomicAdd(counts + 1, waits);

  const int k_hi = min(k0 + kTK - 1, nzh - 1);
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
                        int stage_bytes, unsigned long long* counts,
                        cudaStream_t stream) {
  const int tiles_y = (ny + kTJ - 1) / kTJ;
  const int n_ktiles = (nzh + kTK - 1) / kTK;
  const int64_t blocks =
      static_cast<int64_t>((nx + kTI - 1) / kTI) * tiles_y * n_ktiles;
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  if (stage_bytes < 0) {
    stage_bytes = kStagePixels * static_cast<int>(sizeof(T));
  }
  // Half the budget, a multiple of 16 bytes: the largest box staged.
  const int buf_elems = stage_bytes / 2 / 16 * 16 / static_cast<int>(sizeof(T));
  const int smem = 2 * buf_elems * static_cast<int>(sizeof(T));
  auto kernel = bp_dual_kernel<T, kTI, kTJ, kTK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), dim3(32, kWarps), smem, stream>>>(
      params, static_cast<const T*>(qt), out, n_proj, nu, nv, nx, ny, nzh,
      tiles_y, n_ktiles, buf_elems, copy_width<T>(qt, nv), counts);
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
                   int stage_bytes, unsigned long long* counts,
                   cudaStream_t stream) {
#define BP_LAUNCH(TI, TJ, TK)                                              \
  launch_tile<T, TI, TJ, TK>(params, qt, out, n_proj, nu, nv, nx, ny, nzh, \
                             stage_bytes, counts, stream)
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

// The default staging budget in Q^T pixels (the whole ring's).
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
// bytes, into *bytes (the ring's stage records and barriers).
extern "C" int bp_static_smem(int wire_dtype, int tile, int* bytes) {
#define BP_SMEM(T) static_smem<T>(tile, bytes)
  BP_WIRE_CASES(BP_SMEM)
#undef BP_SMEM
}

// Wire dtype codes: 0 f32, 1 bf16, 2 fp16, 3 fp8 e4m3, 4 fp8 e5m2; `tile`
// indexes the compiled tiles. stage_bytes < 0: the default staging budget
// (kStagePixels pixels). counts: two zeroed counters the kernel adds to,
// the directly gathered (tile, projection) pairs and the ring waits.
extern "C" int bp_dual_launch(const float* params, const void* qt, float* out,
                              int n_proj, int nu, int nv, int nx, int ny,
                              int nzh, int wire_dtype, int tile,
                              int stage_bytes,
                              unsigned long long* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define BP_CALL(T)                                                        \
  launch<T>(tile, params, qt, out, n_proj, nu, nv, nx, ny, nzh, stage_bytes, \
            counts, st)
  BP_WIRE_CASES(BP_CALL)
#undef BP_CALL
}

extern "C" const char* bp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
