// Issue-rate probe of the instructions behind two choices of the kernels:
//   kind 0: mma.sync m16n8k256 .b1 .xor.popc. sm_90a has no XOR form in
//           hardware: ptxas emits two BMMA .AND.POPC on complemented
//           operands and adds them.
//   kind 1: mma.sync m16n8k256 .b1 .and.popc (one BMMA), which
//           hamming_top2.cu uses: a Hamming distance is then
//           |a| + |b| - 2 popc(a & b)
//   kind 2: fp32 min/max (FMNMX), the FAST kernel's arc minima and the
//           rate chip_smoke.py's FAST bound charges them at: 8 independent
//           fminf/fmaxf chains a thread, 2 per step
// Each warp runs 8 independent chains, so the issue rate and not the
// latency of one chain is what the time shows. Used only by
// plslam_torch/utils/mma_rate.py; no kernel of the main path calls it.

#include <cuda_runtime.h>

namespace {

constexpr int CHAINS = 8;

template <int KIND>
__global__ void __launch_bounds__(128) mma_rate_kernel(int iters, int* sink) {
  const unsigned a0 = threadIdx.x * 0x9E3779B9u, a1 = a0 ^ 0x55555555u,
                 a2 = a0 + 7u, a3 = a0 * 3u;
  const unsigned b0 = blockIdx.x * 0x85EBCA6Bu + threadIdx.x, b1 = b0 ^ 0x33333333u;
  int acc[CHAINS][4] = {};
  if (KIND == 2) {
    float f[CHAINS];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) f[c] = __uint_as_float(a0 + c) + 1.f;
    const float lo = __uint_as_float(b0 & 0x3fffffffu), hi = __uint_as_float(b1 | 0x40000000u);
    for (int i = 0; i < iters; ++i)
#pragma unroll
      for (int c = 0; c < CHAINS; ++c) f[c] = fmaxf(fminf(f[c], hi), lo);
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) acc[c][0] = __float_as_int(f[c]);
  }
  for (int i = 0; i < (KIND == 2 ? 0 : iters); ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      if (KIND == 1) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]), "+r"(acc[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      } else {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]), "+r"(acc[c][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  if (s == 0x7fffffff) sink[0] = s;  // keeps the chains live
}

}  // namespace

// Launches `blocks` blocks of 4 warps; each warp issues iters * 8 mma, or
// iters * 16 FMNMX for kind 2.
extern "C" int mma_rate_launch(int kind, int blocks, int iters, int* sink,
                               cudaStream_t stream) {
  if (kind == 0)
    mma_rate_kernel<0><<<blocks, 128, 0, stream>>>(iters, sink);
  else if (kind == 1)
    mma_rate_kernel<1><<<blocks, 128, 0, stream>>>(iters, sink);
  else
    mma_rate_kernel<2><<<blocks, 128, 0, stream>>>(iters, sink);
  return static_cast<int>(cudaGetLastError());
}
