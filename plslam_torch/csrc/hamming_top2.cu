// Fused gated Hamming distance + top-2 over 256-bit descriptors.
//
// Replaces the JAX package's Pallas kernel ops/pallas_matching.py::hamming_top2
// (body `_kernel`, pallas_call at :116). For each query row i and the target
// columns j with gate[i, j] set, it returns
//   best[i]   = min_j popcount(q[i] ^ t[j])
//   idx[i]    = the lowest j attaining best (strict < while scanning)
//   second[i] = the min over every gated column except idx[i]
// and best = second = BIG (1 << 20), idx = -1 on a row with nothing gated.
// The N x M distance matrix never exists in memory.
//
// What bounds it on an H100: at the local-map shape (8192 x 1024) it must
// read the 8.4 MB gate once (2.5 us at 3.35 TB/s); a dense gate would need
// 8192*1024*8 = 67 M popcounts, ~16 us at 16 __popc per clock per SM, so as
// written it is bound by popcounts where the gate is dense. The engine's
// gates are sparse (projection windows), and the kernel does the XOR and
// popcount only for gated pairs, so the real work is the gate read plus the
// gated pairs.
//
// Design: one warp per query row; the query's eight 32-bit words sit in
// registers. Targets are staged through shared memory in chunks of 1024
// rows (32 KB). Lanes stride over columns (lane, lane+32, ...), so each
// warp's gate reads are 32 consecutive bytes, and each lane keeps a running
// (best, idx, second) over its columns in ascending order, replacing only
// on a strictly smaller value. A shuffle reduction merges the lanes:
//   best = min(bA, bB); idx from the smaller best, the smaller index on a
//   tie; second = min(max(bA, bB), sA, sB).
// Later work: a tensor-core popcount (XOR as b1 mma) for dense gates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;
constexpr int CHUNK = 1024;  // target rows staged per pass: 32 KB
constexpr int BIG = 1 << 20;

__global__ void __launch_bounds__(NT)
hamming_top2_kernel(const uint4* __restrict__ q, const uint4* __restrict__ t,
                    const uint8_t* __restrict__ gate, int n, int m,
                    int* __restrict__ best_out, int* __restrict__ idx_out,
                    int* __restrict__ second_out) {
  __shared__ uint4 s_t[CHUNK * 2];

  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool live = row < n;

  uint4 qa = make_uint4(0, 0, 0, 0), qb = make_uint4(0, 0, 0, 0);
  if (live) {
    qa = q[(size_t)row * 2];
    qb = q[(size_t)row * 2 + 1];
  }
  const uint8_t* grow = gate + (size_t)(live ? row : 0) * m;

  int best = BIG, idx = -1, second = BIG;
  for (int c0 = 0; c0 < m; c0 += CHUNK) {
    const int cn = min(CHUNK, m - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * 2; i += NT) s_t[i] = t[(size_t)c0 * 2 + i];
    __syncthreads();
    if (live) {
      for (int j = lane; j < cn; j += 32) {
        if (!grow[c0 + j]) continue;
        const uint4 ta = s_t[j * 2], tb = s_t[j * 2 + 1];
        const int d = __popc(qa.x ^ ta.x) + __popc(qa.y ^ ta.y) +
                      __popc(qa.z ^ ta.z) + __popc(qa.w ^ ta.w) +
                      __popc(qb.x ^ tb.x) + __popc(qb.y ^ tb.y) +
                      __popc(qb.z ^ tb.z) + __popc(qb.w ^ tb.w);
        if (d < best) {
          second = best;
          best = d;
          idx = c0 + j;
        } else if (d < second) {
          second = d;
        }
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    const int os = __shfl_down_sync(0xffffffffu, second, off);
    const int lo = min(best, ob), hi = max(best, ob);
    // equal bests below BIG both carry a real index; equal BIGs carry -1
    const int ni = ob < best ? oi : (best < ob ? idx : min(idx, oi));
    second = min(hi, min(second, os));
    best = lo;
    idx = ni;
  }
  if (lane == 0) {
    best_out[row] = best;
    idx_out[row] = idx;
    second_out[row] = second;
  }
}

}  // namespace

extern "C" int hamming_top2_launch(const void* q, const void* t,
                                   const uint8_t* gate, int n, int m, int* best,
                                   int* idx, int* second, cudaStream_t stream) {
  const dim3 grid((n + WARPS - 1) / WARPS);
  hamming_top2_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(t), gate, n, m,
      best, idx, second);
  return static_cast<int>(cudaGetLastError());
}
