// FAST-9 corner score + 3x3 non-max suppression, one launch per pyramid level.
//
// Replaces the JAX package's Pallas kernel ops/pallas_fast.py::fast_score_nms
// (body `_kernel`, pallas_call at :120), which computes
// nms3x3(fast_score_map(img, min_th)) of ops/fast.py. The output here is
// bit-identical to the plain PyTorch version in plslam_torch/ops/fast.py:
// every operation is an f32 subtract, min, max or compare, all exact, and
// min/max do not depend on the order in which they are taken; the dark arc
// uses min(-d) == -max(d), exact in IEEE arithmetic.
//
// What bounds it on an H100: per pixel the function reads 4 B and writes
// 4 B, and needs ~185 f32 operations (16 subtracts, two 16-way log-doubling
// arc minima with their maxima, the threshold and the 3x3 NMS). At 640x480
// that is 2.5 MB (0.7 us at 3.35 TB/s) against 57 MFLOP (0.85 us at
// 67 TFLOP/s): about balanced, and below a launch's own latency, so at the
// pyramid's sizes the kernel is latency-bound. This first version spends
// more operations than the bound counts: it evaluates each of the 16 arcs
// directly (8 min and 8 max per arc and pixel) and recomputes the score
// ring around every tile.
//
// Design: one thread per output pixel. A 32x8 block stages its tile plus a
// 4-px halo (3 px for the Bresenham circle, 1 px for NMS) in shared memory
// once, so every circle read is a shared-memory read; it then computes the
// score for the tile plus a 1-px ring into shared memory, synchronises, and
// applies NMS and the border mask from shared memory. The image is read
// from device memory once and the score map is written once. Any H and W;
// the ragged edge is masked. Later work: batch the 8 levels into one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr int HALO = 4;
constexpr int SW = TILE_W + 2 * HALO;
constexpr int SH = TILE_H + 2 * HALO;
constexpr int CW = TILE_W + 2;
constexpr int CH = TILE_H + 2;
constexpr int NT = TILE_W * TILE_H;

__global__ void __launch_bounds__(NT)
fast_score_nms_kernel(const float* __restrict__ img, float* __restrict__ out,
                      int h, int w, float min_th) {
  // Bresenham circle of radius 3 in circular order, (dx, dy), y down.
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int DY[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

  __shared__ float s_img[SH][SW];
  __shared__ float s_score[CH][CW];

  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;

  for (int i = tid; i < SH * SW; i += NT) {
    const int sy = i / SW, sx = i % SW;
    const int gy = y0 - HALO + sy, gx = x0 - HALO + sx;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) v = img[(size_t)gy * w + gx];
    s_img[sy][sx] = v;
  }
  __syncthreads();

  // scores on the tile plus a 1-px ring; 0 outside the 3-px-inset interior
  for (int i = tid; i < CH * CW; i += NT) {
    const int cy = i / CW, cx = i % CW;
    const int gy = y0 - 1 + cy, gx = x0 - 1 + cx;
    float s = 0.f;
    if (gy >= 3 && gy < h - 3 && gx >= 3 && gx < w - 3) {
      const int sy = cy + HALO - 1, sx = cx + HALO - 1;
      const float c = s_img[sy][sx];
      float d[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) d[k] = s_img[sy + DY[k]][sx + DX[k]] - c;
      float bright = -INFINITY, dark = -INFINITY;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        float mn = d[k], mx = d[k];
#pragma unroll
        for (int j = 1; j < 9; ++j) {
          mn = fminf(mn, d[(k + j) & 15]);
          mx = fmaxf(mx, d[(k + j) & 15]);
        }
        bright = fmaxf(bright, mn);
        dark = fmaxf(dark, -mx);
      }
      s = fmaxf(bright, dark);
      s = s > min_th ? s : 0.f;
    }
    s_score[cy][cx] = s;
  }
  __syncthreads();

  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx < w && gy < h) {
    const int cy = threadIdx.y + 1, cx = threadIdx.x + 1;
    const float c = s_score[cy][cx];
    float m = c;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) m = fmaxf(m, s_score[cy + dy][cx + dx]);
    out[(size_t)gy * w + gx] = c >= m ? c : 0.f;
  }
}

}  // namespace

extern "C" int fast_score_nms_launch(const float* img, float* out, int h, int w,
                                     float min_th, cudaStream_t stream) {
  const dim3 block(TILE_W, TILE_H);
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H);
  fast_score_nms_kernel<<<grid, block, 0, stream>>>(img, out, h, w, min_th);
  return static_cast<int>(cudaGetLastError());
}
