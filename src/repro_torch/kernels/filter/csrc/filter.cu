// FDK ramp filter of every detector row for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's filter is `jnp.fft` code
// (src/repro/core/filtering.py), and the port ran it on the card through
// torch.fft (cuFFT). That chain made every detector row into a zero-filled
// row of pad samples, a spectrum of pad/2 + 1 complex bins, its product
// with the ramp's response, an inverse transform, a crop and a scale, each
// a pass over device memory: at RabbitCT (496 x 960 rows of 1248 samples,
// pad 4096) on the order of 100 GB a scan for a function that needs 4.75
// GB, 36 ms a scan on an H100 where the bytes bound is 1.42 ms. This
// kernel was added to remove those passes.
//
// It computes, for every row x (N_u samples) of a (B, N_v, N_u) batch,
// with c the row's cosine weights and pad = 2M the filter's FFT length:
//
//   out = tau_u * irfft(rfft(x * c, pad) * H, pad)[:N_u]
//
// in one pass over device memory: each raw sample is read once and each
// filtered sample written once (f32), and the padded row and its spectrum
// live in shared memory only. Its least time is therefore the bytes bound,
// (raw + filtered bytes) over 3.35 TB/s: 1.42 ms at RabbitCT. What holds
// it above that is the transform itself, which runs out of registers and
// shared memory: at pad 4096 about 2,150 instructions a thread and row,
// some 1,250 of them the f32 arithmetic of the two transforms, the split
// and the twiddles (the other ~900 address, load and store the values),
// so the SM's instruction issue bounds it; it ran at 4.6 ms on an H100,
// 31 % of the bytes bound (PERF.md). Every index into a thread's register
// arrays must be a constant after unrolling: one left to run time turns
// the array into compares and predicated moves, which tripled the time.
//
// Algorithm (kernel.py's docstring; `filter_rows_torch` is its plain
// torch version):
// - The real transform of length 2M is the complex transform of length M
//   of z[n] = x[2n] + i x[2n+1]. Only n < ceil(N_u / 2) <= M / 2 is
//   nonzero, so only those inputs are loaded (the first pass's zero inputs
//   are pruned), and only the outputs below N_u are stored (the last
//   pass's others are pruned).
// - The forward and the inverse transform are Stockham passes (natural
//   order in and out): one pass of radix 2^(log2 M mod 4), where that is
//   not 1, then passes of radix 16; the inverse in reverse order. Each
//   thread holds 16 complex values in registers; a pass is radix-2 stages
//   in registers, and the passes trade values through shared memory. A
//   thread t of the T = M / 16 threads of a row holds positions t + T e,
//   e < 16, before the first pass and after the last one of either
//   transform, so the loads, the split and the stores need no exchange.
// - Between the transforms, Z'[k] = P[k] Z[k] + Q[k] conj(Z[M - k]): the
//   real split, the response, the inverse split, tau_u and 1/pad in one
//   complex table of (P, Q) made on the host in float64 and rounded once.
// - Twiddles come from one table made on the host in float64 and rounded
//   once, one (R - 1, Ns) block per pass with Ns > 1, laid out so that a
//   warp reads contiguous entries; the radix-16 stages' own twiddles are
//   float64 values rounded once. No __sinf, no fast math; nvcc may
//   contract multiplies and adds into FMAs.
// - Shared memory holds one padded slot after every 16 complex values, so
//   the passes' strided stores do not conflict on banks.
// - A row of even N_u whose tensors start 8-byte aligned is loaded and
//   stored as float2 (a thread's complex input is two adjacent samples);
//   any other row takes the scalar path. At RabbitCT the float2 path ran
//   4.65 ms against 5.30 ms with the scalar path forced, bit-equal, on an
//   H100 (PERF.md).
// - A block owns row_slots() detector rows (one per group of T threads,
//   128 threads at least) and walks kProjPerBlock projections for them,
//   keeping each row's cosine weights in registers; the launch bounds ask
//   for kSmThreads threads an SM (80 registers a thread). Each row is
//   filtered alone, so its result does not depend on the batch it came in.
//
// Compiled for pad = 2^6 .. 2^14 (two passes at least each way); the
// wrapper raises for any other.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 (kernels/build.py).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kE = 16;              // complex values a thread holds
constexpr int kMinThreads = 128;    // threads a block, or a row's if more
constexpr int kSmThreads = 768;     // threads an SM should hold (occupancy)
constexpr int kProjPerBlock = 8;    // projections a block walks
constexpr int kMinLog2Pad = 6;
constexpr int kMaxLog2Pad = 14;

// ---- The schedule: kernel.py's `radices` and `twiddle_table` -----------
// log2m = log2(pad) - 1.
__host__ __device__ constexpr int num_passes(int log2m) {
  return log2m / 4 + (log2m % 4 != 0 ? 1 : 0);
}

__host__ __device__ constexpr int radix(int log2m, bool inverse, int p) {
  return (log2m % 4 != 0 && p == (inverse ? num_passes(log2m) - 1 : 0))
             ? 1 << (log2m % 4)
             : 16;
}

__host__ __device__ constexpr int ns_of(int log2m, bool inverse, int p) {
  int ns = 1;
  for (int i = 0; i < p; ++i) ns *= radix(log2m, inverse, i);
  return ns;
}

__host__ __device__ constexpr int entries_of(int log2m, bool inverse, int p) {
  return ns_of(log2m, inverse, p) > 1
             ? (radix(log2m, inverse, p) - 1) * ns_of(log2m, inverse, p)
             : 0;
}

// Entries of the twiddle table before pass p of a transform: the forward
// transform's blocks first, then the inverse's.
__host__ __device__ constexpr int tw_offset(int log2m, bool inverse, int p) {
  int off = 0;
  if (inverse)
    for (int i = 0; i < num_passes(log2m); ++i) off += entries_of(log2m, false, i);
  for (int i = 0; i < p; ++i) off += entries_of(log2m, inverse, i);
  return off;
}

__host__ __device__ constexpr int block_threads(int log2m) {
  return (1 << log2m) / kE > kMinThreads ? (1 << log2m) / kE : kMinThreads;
}

// Blocks an SM should hold, which caps the registers a thread may use.
__host__ __device__ constexpr int min_blocks(int log2m) {
  return kSmThreads / block_threads(log2m) > 1
             ? kSmThreads / block_threads(log2m)
             : 1;
}

__host__ __device__ constexpr int row_slots(int log2m) {
  return block_threads(log2m) / ((1 << log2m) / kE);
}

// float2 slots of a row in shared memory: one padded slot per 16.
__host__ __device__ constexpr int row_stride(int log2m) {
  return (1 << log2m) + (1 << log2m) / 16;
}

__host__ __device__ constexpr int log2_of(int r) {
  return r == 2 ? 1 : r == 4 ? 2 : r == 8 ? 3 : 4;
}

// i with its `bits` low bits reversed (bits <= 4), in plain arithmetic so
// that it folds once i is a constant.
__host__ __device__ constexpr int bit_reverse(int i, int bits) {
  return (((i & 1) << 3) | ((i & 2) << 1) | ((i & 4) >> 1) | ((i & 8) >> 3)) >>
         (4 - bits);
}

// ---- Complex arithmetic --------------------------------------------------
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// cos and sin of 2 pi m / 16, m < 8: float64 values rounded once.
__device__ __forceinline__ float cos16(int m) {
  switch (m) {
    case 0: return 1.0f;
    case 1: return 0.92387953251128675613f;
    case 2: return 0.70710678118654752440f;
    case 3: return 0.38268343236508977173f;
    case 4: return 0.0f;
    case 5: return -0.38268343236508977173f;
    case 6: return -0.70710678118654752440f;
    default: return -0.92387953251128675613f;
  }
}

__device__ __forceinline__ float sin16(int m) {
  switch (m) {
    case 0: return 0.0f;
    case 1: return 0.38268343236508977173f;
    case 2: return 0.70710678118654752440f;
    case 3: return 0.92387953251128675613f;
    case 4: return 1.0f;
    case 5: return 0.92387953251128675613f;
    case 6: return 0.70710678118654752440f;
    default: return 0.38268343236508977173f;
  }
}

// a * W_16^m forward (W = exp(-2 pi i / 16)), a * W_16^-m inverse; m < 8.
template <bool INV>
__device__ __forceinline__ float2 rot16(float2 a, int m) {
  if (m == 0) return a;
  if (m == 4) return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
  const float c = cos16(m), s = INV ? sin16(m) : -sin16(m);
  return make_float2(a.x * c - a.y * s, a.x * s + a.y * c);
}

// One radix-2 stage of a decimation in frequency over u[0..R): blocks of
// 2 HALF values, the second half of each rotated by W_{2 HALF}^i; then the
// next stage. With ZERO_HI the upper half of u is zero (the first pass's
// pruned inputs), so this stage only rotates. Every index is a constant
// once the loop is unrolled.
template <int R, int HALF, bool INV, bool ZERO_HI>
__device__ __forceinline__ void dif_stages(float2 (&u)[R]) {
#pragma unroll
  for (int b = 0; b < R / 2; ++b) {
    const int i = b % HALF;
    const int lo = (b / HALF) * 2 * HALF + i;
    const float2 x = u[lo], y = u[lo + HALF];
    if constexpr (ZERO_HI) {
      u[lo + HALF] = rot16<INV>(x, i * (8 / HALF));
    } else {
      u[lo] = cadd(x, y);
      u[lo + HALF] = rot16<INV>(csub(x, y), i * (8 / HALF));
    }
  }
  if constexpr (HALF > 1) dif_stages<R, HALF / 2, INV, false>(u);
}

// In-register DFT of length R <= 16, natural order in and out: the radix-2
// stages, then the bit reversal (a renaming of registers). Outputs the
// caller never reads are removed by the compiler with what feeds only them
// (the inverse's last pass stores only its lower half).
template <int R, bool INV, bool ZERO_HI>
__device__ __forceinline__ void dft(float2 (&u)[R]) {
  dif_stages<R, R / 2, INV, ZERO_HI>(u);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = bit_reverse(i, log2_of(R));
    if (i < r) {
      const float2 t = u[i];
      u[i] = u[r];
      u[r] = t;
    }
  }
}

// ---- One Stockham pass ----------------------------------------------------
// In a pass of radix R after passes whose radices multiply to NS, butterfly
// j (of M / R) reads positions j + r M / R, multiplies input r by
// W_{NS R}^{r (j mod NS)}, transforms, and writes output r to
// (j / NS) NS R + (j mod NS) + r NS. Thread t runs butterflies t + q T,
// q < 16 / R, so its inputs are always t + T e with e = q + (16 / R) r.

__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// The forward transform's first pass has zero inputs r >= R / 2: they are
// its values e = q + Q r >= 8, positions t + T e >= M / 2 (ZERO_HI).
template <int R, bool INV, bool ZERO_HI>
__device__ __forceinline__ void butterflies(float2 (&v)[kE]) {
  constexpr int Q = kE / R;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    float2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = v[q + Q * r];
    dft<R, INV, ZERO_HI>(u);
#pragma unroll
    for (int r = 0; r < R; ++r) v[q + Q * r] = u[r];
  }
}

template <int R, int NS, int T, bool INV>
__device__ __forceinline__ void twiddle(float2 (&v)[kE],
                                        const float2* __restrict__ tw, int t) {
  constexpr int Q = kE / R;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int k = (t + q * T) & (NS - 1);
#pragma unroll
    for (int r = 1; r < R; ++r) {
      float2 w = __ldg(tw + (r - 1) * NS + k);
      if (INV) w.y = -w.y;
      v[q + Q * r] = cmul(v[q + Q * r], w);
    }
  }
}

// The slot of i + c is slot(i) + slot(c) when c is a multiple of 16.
template <int T>
__device__ __forceinline__ void load_held(float2 (&v)[kE], const float2* buf,
                                          int t) {
  if constexpr (T % 16 == 0) {
    const float2* p = buf + slot(t);
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = p[slot(T * e)];
  } else {
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = buf[slot(t + T * e)];
  }
}

template <int R, int NS, int T>
__device__ __forceinline__ void store_expanded(float2* buf,
                                               const float2 (&v)[kE], int t) {
  constexpr int Q = kE / R;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int j = t + q * T;
    const int base = (j & ~(NS - 1)) * R + (j & (NS - 1));
    if constexpr (NS % 16 == 0) {
      float2* p = buf + slot(base);
#pragma unroll
      for (int r = 0; r < R; ++r) p[slot(r * NS)] = v[q + Q * r];
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) buf[slot(base + r * NS)] = v[q + Q * r];
    }
  }
}

// Pass P of the forward (INV false) or inverse transform. The first pass
// starts from the registers; every pass but the inverse's last leaves its
// outputs in shared memory (the forward's last also in the registers, at
// the positions the thread holds); the inverse's last leaves them in the
// registers only, for the store to device memory.
template <int LOG2M, bool INV, int P>
__device__ __forceinline__ void pass(float2 (&v)[kE], float2* buf,
                                     const float2* __restrict__ tw, int t) {
  constexpr int R = radix(LOG2M, INV, P);
  constexpr int NS = ns_of(LOG2M, INV, P);
  constexpr int T = (1 << LOG2M) / kE;
  if constexpr (P > 0) {
    load_held<T>(v, buf, t);
    twiddle<R, NS, T, INV>(v, tw + tw_offset(LOG2M, INV, P), t);
  }
  butterflies<R, INV, !INV && P == 0>(v);
  if constexpr (!(INV && P == num_passes(LOG2M) - 1)) {
    __syncthreads();  // every read of the buffer before this store is done
    store_expanded<R, NS, T>(buf, v, t);
    __syncthreads();
  }
}

template <int LOG2M, bool INV, int P = 0>
__device__ __forceinline__ void transform(float2 (&v)[kE], float2* buf,
                                          const float2* __restrict__ tw,
                                          int t) {
  pass<LOG2M, INV, P>(v, buf, tw, t);
  if constexpr (P + 1 < num_passes(LOG2M))
    transform<LOG2M, INV, P + 1>(v, buf, tw, t);
}

// Z'[k] = P[k] Z[k] + Q[k] conj(Z[(M - k) mod M]) for the thread's k.
template <int LOG2M>
__device__ __forceinline__ void split(float2 (&v)[kE], const float2* buf,
                                      const float4* __restrict__ pq, int t) {
  constexpr int M = 1 << LOG2M, T = M / kE;
#pragma unroll
  for (int e = 0; e < kE; ++e) {
    const int k = t + T * e;
    const float2 m = buf[slot((M - k) & (M - 1))];
    const float4 f = __ldg(pq + k);
    const float2 z = v[e];
    v[e] = make_float2(f.x * z.x - f.y * z.y + f.z * m.x + f.w * m.y,
                       f.x * z.y + f.y * z.x + f.w * m.x - f.z * m.y);
  }
}

template <int LOG2M>
__global__ void __launch_bounds__(block_threads(LOG2M), min_blocks(LOG2M))
    ramp_filter_kernel(const float* __restrict__ proj,
                       const float* __restrict__ fcos,
                       const float2* __restrict__ tw,
                       const float4* __restrict__ pq, float* __restrict__ out,
                       int n_proj, int nv, int nu, bool pairs) {
  constexpr int M = 1 << LOG2M, T = M / kE, kRows = row_slots(LOG2M);
  extern __shared__ float2 smem[];
  const int t = threadIdx.x & (T - 1);
  const int s = threadIdx.x / T;
  float2* buf = smem + s * row_stride(LOG2M);
  const int jv = blockIdx.x * kRows + s;
  const bool live = jv < nv;
  // Complex inputs and outputs that count: n < nz (none in a dead slot).
  const int nz = live ? (nu + 1) / 2 : 0;

  // This row's cosine weights at the thread's inputs (n = t + T e < M / 2,
  // so e < 8), kept across the projections.
  float2 cw[kE / 2];
#pragma unroll
  for (int e = 0; e < kE / 2; ++e) {
    const int n = t + T * e;
    cw[e] = make_float2(0.0f, 0.0f);
    if (n < nz) {
      const float* c = fcos + static_cast<size_t>(jv) * nu + 2 * n;
      cw[e].x = __ldg(c);
      if (2 * n + 1 < nu) cw[e].y = __ldg(c + 1);
    }
  }

  const int p_end = min(n_proj, static_cast<int>(blockIdx.y + 1) * kProjPerBlock);
  for (int p = blockIdx.y * kProjPerBlock; p < p_end; ++p) {
    const size_t row = (static_cast<size_t>(p) * nv + jv) * nu;
    float2 v[kE];
#pragma unroll
    for (int e = 0; e < kE; ++e) v[e] = make_float2(0.0f, 0.0f);
    if (pairs) {
      const float2* x = reinterpret_cast<const float2*>(proj + row);
#pragma unroll
      for (int e = 0; e < kE / 2; ++e) {
        const int n = t + T * e;
        if (n < nz) {
          const float2 a = __ldg(x + n);
          v[e] = make_float2(a.x * cw[e].x, a.y * cw[e].y);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < kE / 2; ++e) {
        const int n = t + T * e;
        if (n < nz) {
          v[e].x = __ldg(proj + row + 2 * n) * cw[e].x;
          if (2 * n + 1 < nu) v[e].y = __ldg(proj + row + 2 * n + 1) * cw[e].y;
        }
      }
    }
    transform<LOG2M, false>(v, buf, tw, t);
    split<LOG2M>(v, buf, pq, t);
    transform<LOG2M, true>(v, buf, tw, t);
    if (pairs) {
      float2* y = reinterpret_cast<float2*>(out + row);
#pragma unroll
      for (int e = 0; e < kE / 2; ++e)
        if (t + T * e < nz) y[t + T * e] = v[e];
    } else {
#pragma unroll
      for (int e = 0; e < kE / 2; ++e) {
        const int n = t + T * e;
        if (n < nz) {
          out[row + 2 * n] = v[e].x;
          if (2 * n + 1 < nu) out[row + 2 * n + 1] = v[e].y;
        }
      }
    }
  }
}

template <int LOG2M>
cudaError_t launch(const float* proj, const float* fcos,
                   const float* tw, const float* pq, float* out, int n_proj,
                   int nv, int nu, cudaStream_t stream) {
  constexpr int kRows = row_slots(LOG2M);
  constexpr int kSmem = static_cast<int>(sizeof(float2)) * kRows * row_stride(LOG2M);
  auto* kernel = ramp_filter_kernel<LOG2M>;
  if (kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
  }
  // Rows start 8-byte aligned in both tensors: float2 loads and stores.
  const bool pairs = nu % 2 == 0 && reinterpret_cast<size_t>(proj) % 8 == 0 &&
                     reinterpret_cast<size_t>(out) % 8 == 0;
  const dim3 grid((nv + kRows - 1) / kRows,
                  (n_proj + kProjPerBlock - 1) / kProjPerBlock);
  kernel<<<grid, block_threads(LOG2M), kSmem, stream>>>(
      proj, fcos, reinterpret_cast<const float2*>(tw),
      reinterpret_cast<const float4*>(pq), out, n_proj, nv, nu, pairs);
  return cudaGetLastError();
}

}  // namespace

// Entries of the twiddle table for pad = 2^log2_pad (-1: not compiled).
extern "C" int rf_twiddle_count(int log2_pad) {
  if (log2_pad < kMinLog2Pad || log2_pad > kMaxLog2Pad) return -1;
  return tw_offset(log2_pad - 1, true, num_passes(log2_pad - 1));
}

// proj (n_proj, nv, nu) and fcos (nv, nu) f32, tw the twiddle table
// (8-byte aligned), pq the (P, Q) table (pad / 2 float4, 16-byte aligned),
// out (n_proj, nv, nu) f32; all contiguous, nu <= pad / 2.
extern "C" int rf_launch(const float* proj, const float* fcos,
                         const float* tw, const float* pq, float* out,
                         int n_proj, int nv, int nu, int log2_pad,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define RF_CASE(L)                                                       \
  case L:                                                                \
    return static_cast<int>(launch<L - 1>(proj, fcos, tw, pq, out,        \
                                          n_proj, nv, nu, st))
  switch (log2_pad) {
    RF_CASE(6);
    RF_CASE(7);
    RF_CASE(8);
    RF_CASE(9);
    RF_CASE(10);
    RF_CASE(11);
    RF_CASE(12);
    RF_CASE(13);
    RF_CASE(14);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RF_CASE
}

extern "C" const char* rf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
