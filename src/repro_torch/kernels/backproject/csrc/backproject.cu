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
// Design. The Pallas grid keeps an output tile resident in VMEM and sums
// over a sequential projection-batch grid axis; Hopper blocks run in
// parallel and in no order, so here every thread owns one mirrored voxel
// pair (i, j, k < nz/2), loops over ALL projections with the front and
// mirror accumulators in registers, and writes each output element once:
// no atomics, and the sum order is fixed (projection 0 first, as in the
// oracles), so results are deterministic. A warp covers 32 consecutive k
// of one column: u, w and the row weights are uniform across the warp,
// and the taps walk the contiguous N_v axis of two adjacent Q^T rows (the
// paper's "L1-Tran" layout), read through the read-only path. Columns are
// enumerated in 16 x 16 tiles so that the blocks resident at one time
// cover a compact patch of the volume whose projections share Q^T rows in
// L1/L2. Parameter rows are staged in shared memory 32 projections at a
// time (the paper's batch). Offsets into Q^T and the volume are 64-bit:
// the paper's 4K problem holds 1.7e10 samples. The bilinear weights are
// explicit f32 arithmetic; the texture unit's 8-bit fractions cannot meet
// the f32 tolerance.
//
// What bounds it on an H100: the arithmetic the function needs (about 15.5
// f32 operations per voxel update at the RabbitCT size, counted in
// chip_smoke.py with the column terms once per column) over 67 TFLOP/s,
// far above the bytes bound (Q^T read once + the volume written once over
// 3.35 TB/s). This kernel also recomputes the column terms, a true
// division among them, in every thread of a column, and the four
// scattered tap loads per update through L1 limit it before either bound.
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
constexpr int kChunk = 32;   // parameter rows staged in shared memory
constexpr int kWarps = 8;    // warps per block; one warp = one column x 32 k
constexpr int kTile = 16;    // columns are enumerated in kTile x kTile tiles

template <typename T>
__device__ __forceinline__ float load_tap(const T* p);

template <>
__device__ __forceinline__ float load_tap<float>(const float* p) {
  return __ldg(p);
}

template <>
__device__ __forceinline__ float load_tap<__half>(const __half* p) {
  return __half2float(__ldg(p));
}

template <>
__device__ __forceinline__ float load_tap<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float fp8_to_float(unsigned char raw,
                                              __nv_fp8_interpretation_t kind) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(raw, kind)));
}

template <>
__device__ __forceinline__ float load_tap<__nv_fp8_e4m3>(
    const __nv_fp8_e4m3* p) {
  return fp8_to_float(__ldg(reinterpret_cast<const unsigned char*>(p)),
                      __NV_E4M3);
}

template <>
__device__ __forceinline__ float load_tap<__nv_fp8_e5m2>(
    const __nv_fp8_e5m2* p) {
  return fp8_to_float(__ldg(reinterpret_cast<const unsigned char*>(p)),
                      __NV_E5M2);
}

// Zero-outside bilinear sample of one Q^T plane at row coordinate
// r0 + dr (u) and column coordinate v. Same operation order as the plain
// version: taps (r0,c0), (r0,c0+1), (r0+1,c0), (r0+1,c0+1), summed left to
// right. A tap is read only when its row is in [0, nu) and its column in
// [0, nv).
template <typename T>
__device__ __forceinline__ float bilinear(const T* __restrict__ q, int nu,
                                          int nv, int r0, float dr, float v) {
  const float c0f = floorf(v);
  const float dc = v - c0f;
  const int c0 = static_cast<int>(c0f);
  const bool r0ok = r0 >= 0 && r0 < nu;
  const bool r1ok = r0 + 1 >= 0 && r0 + 1 < nu;
  const bool c0ok = c0 >= 0 && c0 < nv;
  const bool c1ok = c0 + 1 >= 0 && c0 + 1 < nv;
  const int64_t o00 = static_cast<int64_t>(r0) * nv + c0;
  const float t00 =
      (r0ok && c0ok) ? load_tap(q + o00) * ((1.f - dr) * (1.f - dc)) : 0.f;
  const float t01 =
      (r0ok && c1ok) ? load_tap(q + o00 + 1) * ((1.f - dr) * dc) : 0.f;
  const float t10 =
      (r1ok && c0ok) ? load_tap(q + o00 + nv) * (dr * (1.f - dc)) : 0.f;
  const float t11 =
      (r1ok && c1ok) ? load_tap(q + o00 + nv + 1) * (dr * dc) : 0.f;
  return t00 + t01 + t10 + t11;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
bp_dual_kernel(const float* __restrict__ params, const T* __restrict__ qt,
               float* __restrict__ out, int n_proj, int nu, int nv, int nx,
               int ny, int nzh, int n_kchunks, int tiles_y) {
  __shared__ float sp[kChunk * kParams];
  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * 32 + lane;

  // unit = (column, 32-wide k chunk), k chunk fastest; columns in tiles.
  const int64_t unit = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  const int kc = static_cast<int>(unit % n_kchunks);
  const int64_t col = unit / n_kchunks;
  const int64_t tile = col / (kTile * kTile);
  const int within = static_cast<int>(col % (kTile * kTile));
  const int i = static_cast<int>(tile / tiles_y) * kTile + within / kTile;
  const int j = static_cast<int>(tile % tiles_y) * kTile + within % kTile;
  const int k = kc * 32 + lane;
  const bool active = i < nx && j < ny && k < nzh;

  const float fi = static_cast<float>(i);
  const float fj = static_cast<float>(j);
  const float fk = static_cast<float>(k);
  const float vmax = static_cast<float>(nv - 1);
  const int64_t plane = static_cast<int64_t>(nu) * nv;
  float acc_f = 0.f;
  float acc_b = 0.f;

  for (int s0 = 0; s0 < n_proj; s0 += kChunk) {
    const int nb = min(kChunk, n_proj - s0);
    __syncthreads();  // previous chunk fully consumed
    for (int t = tid; t < nb * kParams; t += kWarps * 32) {
      sp[t] = params[static_cast<int64_t>(s0) * kParams + t];
    }
    __syncthreads();
    if (!active) continue;
    for (int s = 0; s < nb; ++s) {
      const float* p = sp + s * kParams;
      // The coordinate chain is rounded once per operation, exactly as the
      // plain version computes it: the _rn intrinsics are never contracted
      // into FMAs (see the note on tolerance at the top).
      // Theorems 2/3: per-column invariants.
      const float x0 = __fadd_rn(
          __fadd_rn(__fmul_rn(p[0], fi), __fmul_rn(p[1], fj)), p[3]);
      const float y0 = __fadd_rn(
          __fadd_rn(__fmul_rn(p[4], fi), __fmul_rn(p[5], fj)), p[7]);
      const float z = __fadd_rn(
          __fadd_rn(__fmul_rn(p[8], fi), __fmul_rn(p[9], fj)), p[11]);
      const float f = __fdiv_rn(1.0f, z);
      const float u = __fmul_rn(x0, f);
      // T3 weight x codec decode scale
      const float w = __fmul_rn(__fmul_rn(f, f), p[12]);
      // v is affine in k
      const float v = __fmul_rn(__fadd_rn(y0, __fmul_rn(p[6], fk)), f);
      const float vm = __fsub_rn(vmax, v);  // Theorem-1 mirror
      const float r0f = floorf(u);
      const float dr = u - r0f;
      const int r0 = static_cast<int>(r0f);
      const T* q = qt + static_cast<int64_t>(s0 + s) * plane;
      acc_f += w * bilinear(q, nu, nv, r0, dr, v);
      acc_b += w * bilinear(q, nu, nv, r0, dr, vm);
    }
  }
  if (active) {
    const int64_t base = (static_cast<int64_t>(i) * ny + j) * 2 * nzh + k;
    out[base] = acc_f;
    out[base + nzh] = acc_b;
  }
}

template <typename T>
cudaError_t launch(const float* params, const void* qt, float* out,
                   int n_proj, int nu, int nv, int nx, int ny, int nzh,
                   cudaStream_t stream) {
  const int n_kchunks = (nzh + 31) / 32;
  const int tiles_x = (nx + kTile - 1) / kTile;
  const int tiles_y = (ny + kTile - 1) / kTile;
  const int64_t units =
      static_cast<int64_t>(tiles_x) * tiles_y * kTile * kTile * n_kchunks;
  const int64_t blocks = units / kWarps;  // kTile^2 is a multiple of kWarps
  if (blocks < 1 || blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  bp_dual_kernel<T><<<static_cast<unsigned>(blocks), dim3(32, kWarps), 0,
                      stream>>>(params, static_cast<const T*>(qt), out,
                                n_proj, nu, nv, nx, ny, nzh, n_kchunks,
                                tiles_y);
  return cudaGetLastError();
}

}  // namespace

// Wire dtype codes: 0 f32, 1 bf16, 2 fp16, 3 fp8 e4m3, 4 fp8 e5m2.
extern "C" int bp_dual_launch(const float* params, const void* qt, float* out,
                              int n_proj, int nu, int nv, int nx, int ny,
                              int nzh, int wire_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wire_dtype) {
    case 0:
      return launch<float>(params, qt, out, n_proj, nu, nv, nx, ny, nzh, st);
    case 1:
      return launch<__nv_bfloat16>(params, qt, out, n_proj, nu, nv, nx, ny,
                                   nzh, st);
    case 2:
      return launch<__half>(params, qt, out, n_proj, nu, nv, nx, ny, nzh, st);
    case 3:
      return launch<__nv_fp8_e4m3>(params, qt, out, n_proj, nu, nv, nx, ny,
                                   nzh, st);
    case 4:
      return launch<__nv_fp8_e5m2>(params, qt, out, n_proj, nu, nv, nx, ny,
                                   nzh, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* bp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
