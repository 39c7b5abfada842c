// The rate `mma.sync` m16n8k8 TF32 reaches alone: every warp runs CHAINS
// independent accumulator chains of products on operands held in
// registers, nothing loaded. It is the ceiling of any 3xTF32 kernel built
// on `mma.sync`, such as fa_fwd_f32_kernel in attention.cu.
#include <cstdint>
#include <cuda_runtime.h>

template <int CHAINS>
__global__ void mma_tf32_chains(float* out, int iters) {
  uint32_t a[4], b0 = threadIdx.x * 3u, b1 = threadIdx.x * 7u;
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x + i) << 13;
  float c[CHAINS][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < CHAINS; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

// out holds blocks * threads floats; chains is 8 or 16.
extern "C" int mma_tf32_rate_launch(float* out, int blocks, int threads,
                                    int iters, int chains) {
  if (chains == 8)
    mma_tf32_chains<8><<<blocks, threads>>>(out, iters);
  else if (chains == 16)
    mma_tf32_chains<16><<<blocks, threads>>>(out, iters);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
