// FAST-9 corner score + 3x3 non-max suppression for a whole image pyramid,
// of one image or of a batch of images, in one launch.
//
// Replaces the JAX package's Pallas kernel ops/pallas_fast.py::fast_score_nms
// (body `_kernel`, pallas_call at :120), which computes
// nms3x3(fast_score_map(img, min_th)) of ops/fast.py for one level. The
// output here is bit-identical to the plain PyTorch version in
// plslam_torch/ops/fast.py: every operation is an f32 subtract, min, max or
// compare, all exact, and min/max do not depend on the order in which they
// are taken; the dark side is the bright one of -d, exact in IEEE arithmetic.
//
// Exact early reject (the compass pre-test). Any 9 contiguous points of the
// 16-point circle contain two adjacent compass points (indices 0/4, 4/8,
// 8/12 or 12/0): among 9 consecutive indices there are at least two
// multiples of 4, and two multiples of 4 less than 9 apart are adjacent
// ones. A pixel scores above min_th only if some 9-arc has every d > min_th
// (bright) or every d < -min_th (dark), and then both compass points inside
// that arc pass the same test. So a side (bright or dark) with no adjacent
// compass pair beyond +-min_th scores at most min_th, which the threshold
// turns into exactly 0, and skips the arc work. As score = max(bright,
// dark), a pixel's thresholded score is the larger of its passing sides'
// thresholded scores, or 0 when no side passes.
//
// What bounds it on an H100: with the exact reject, the work every
// evaluation must do is reading each pixel once and writing its output once,
// 8 B/px: 0.95 M px for the 8 levels of a 640x480 frame is 7.6 MB, 2.27 us
// at 3.35 TB/s. The operations are ~30 per pixel (pre-test and NMS) plus
// ~65 per passing side, most of them fp32 min/max, which issue at 64 per
// clock per SM, half the rate of a subtract. The room's textures pass ~49%
// of the sides, so the operations bind (chip_smoke.py counts both).
//
// Design:
// - One launch for up to MAX_LEVELS levels. The level table (input, output,
//   H, W, image stride, tiles per row, first block) is a kernel parameter;
//   each block finds its level by an unrolled scan of the table, so no level
//   pays a launch of its own and the small levels share the card with the
//   large one.
// - A batch of images (B sequences tracked in one step) shares one pyramid
//   geometry: level l of image b lies at a fixed stride from level l of
//   image 0. blockIdx.y is the image, so the scan of the table does not grow
//   with B, and block (x, y) does exactly what block x of a single image
//   does: a single image is the B = 1 case of the same kernel.
// - A 62x16 output tile per 256-thread block: the image tile plus a 4-px
//   halo (3 px for the circle, 1 px for NMS) is staged in shared memory once
//   (1.69 loads per output pixel; rows by warp, every load issued before the
//   first store, no per-element division), with a negated copy for the dark
//   side. Scores are computed for the tile plus a 1-px ring (1.16 per output
//   pixel): 64 score columns, so each lane of two warps owns a column and the
//   four warp pairs walk a quarter of the rows each, then NMS and the border
//   mask run down the same column strips (3-wide maxima of 6 score rows,
//   then 3-high maxima). Any H and W; the ragged edge is masked, and a level
//   smaller than one tile is one partial tile.
// - The pre-test runs on every pixel of the score region; the sides that
//   pass go to a shared-memory queue, compacted by warp ballots, and the
//   block's threads then take the arc minima on full warps of queued sides,
//   so no lane idles behind a neighbour that passed. The arcs are taken on
//   the pixel values (the dark side on the negated tile), and pairs of
//   neighbouring arcs share their 7 common points: 63 fp32 min/max a side,
//   against the plain version's 79. It needs min_th >= 0: a score is then +0
//   or positive, and an integer atomicMax on its bits keeps the larger side.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

// One pyramid level as the host passes it.
struct FastLevel {
  const float* img;    // image 0 of the batch
  float* out;
  int h;
  int w;
  long long stride;    // elements from one image of the batch to the next
};

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int TILE_W = 62;  // + a 1-px ring = 64 score columns, two warps wide
constexpr int TILE_H = 16;
constexpr int HALO = 4;
constexpr int SW = TILE_W + 2 * HALO;
constexpr int SH = TILE_H + 2 * HALO;
constexpr int CW = TILE_W + 2;
constexpr int CH = TILE_H + 2;
constexpr int WARPS = 8;
constexpr int NT = WARPS * 32;

struct LevelDesc {
  const float* img;
  float* out;
  long long stride;
  int h, w, tiles_x, first_block;
};

struct LevelTable {
  LevelDesc lv[MAX_LEVELS];
};

// Compass pre-test of the pixel at s[sy][sx]: bit 0 set if an adjacent
// pair of compass points is brighter than the centre by more than th, bit 1
// if one is darker by more than th.
__device__ __forceinline__ unsigned compass_sides(const float (*s)[SW], int sy, int sx,
                                                  float th) {
  const float c = s[sy][sx];
  const float n0 = s[sy + 3][sx] - c, n4 = s[sy][sx + 3] - c;
  const float n8 = s[sy - 3][sx] - c, n12 = s[sy][sx - 3] - c;
  const bool b0 = n0 > th, b4 = n4 > th, b8 = n8 > th, b12 = n12 > th;
  const bool k0 = n0 < -th, k4 = n4 < -th, k8 = n8 < -th, k12 = n12 < -th;
  const bool bright = (b0 && b4) || (b4 && b8) || (b8 && b12) || (b12 && b0);
  const bool dark = (k0 && k4) || (k4 && k8) || (k8 && k12) || (k12 && k0);
  return (bright ? 1u : 0u) | (dark ? 2u : 0u);
}

// One side of the FAST-9 score of the pixel at s[sy][sx], thresholded (0
// unless > th). On the image it is the bright score max_k min(d[k..k+8]),
// d = p - c; on the negated image it is the dark one, max_k min(-d[k..k+8]).
// x -> fl(x - c) is monotone, so min and max commute with it: the arcs are
// taken on the pixel values p and c is subtracted once, with the same bits
// as subtracting it from each of them first.
__device__ __forceinline__ float arc_score(const float (*s)[SW], int sy, int sx, float th) {
  // Bresenham circle of radius 3 in circular order, (dx, dy), y down.
  const int DX[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int DY[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
  float p[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) p[k] = s[sy + DY[k]][sx + DX[k]];
  // Arcs k and k+1 (k even) share the 7 points W = p[k+1..k+7], and
  //   max(min(p[k], W, p[k+8]), min(W, p[k+8], p[k+9]))
  //     = min(W, p[k+8], max(p[k], p[k+9])),
  // so the best of the 16 arcs takes 8 windows of 7 from the odd starts
  // (log-doubling: 2, 4, 6, 7) and 3 min/max a pair: 63 in all, not 79.
  float w2[8], w4[8], a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w2[i] = fminf(p[2 * i + 1], p[(2 * i + 2) & 15]);
#pragma unroll
  for (int i = 0; i < 8; ++i) w4[i] = fminf(w2[i], w2[(i + 1) & 7]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float w7 = fminf(fminf(w4[i], w2[(i + 2) & 7]), p[(2 * i + 7) & 15]);
    a[i] = fminf(fminf(w7, p[(2 * i + 8) & 15]), fmaxf(p[2 * i], p[(2 * i + 9) & 15]));
  }
  // max over the pairs as a tree, written out so that every index is a constant
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = fmaxf(a[i], a[i + 4]);
  const float sc = fmaxf(fmaxf(a[0], a[2]), fmaxf(a[1], a[3])) - s[sy][sx];
  return sc > th ? sc : 0.f;
}

__global__ void __launch_bounds__(NT)
fast_score_nms_kernel(const LevelTable tab, float min_th) {
  __shared__ float s_img[SH][SW];
  __shared__ float s_neg[SH][SW];  // -s_img: the dark side's input
  __shared__ float s_score[CH][CW + 2];  // 2 spare columns for the last lanes' NMS
  __shared__ uint16_t s_queue[2 * CH * CW];  // (side << 15) | (cy << 7) | cx
  __shared__ int s_qn;

  // this block's level: the last entry whose first block is <= blockIdx.x
  const int bid = blockIdx.x;
  const float* img = tab.lv[0].img;
  float* out = tab.lv[0].out;
  long long stride = tab.lv[0].stride;
  int h = tab.lv[0].h, w = tab.lv[0].w, tiles_x = tab.lv[0].tiles_x;
  int first = 0;
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i) {
    if (bid >= tab.lv[i].first_block) {
      img = tab.lv[i].img;
      out = tab.lv[i].out;
      stride = tab.lv[i].stride;
      h = tab.lv[i].h;
      w = tab.lv[i].w;
      tiles_x = tab.lv[i].tiles_x;
      first = tab.lv[i].first_block;
    }
  }
  // image blockIdx.y of the batch
  img += (size_t)blockIdx.y * stride;
  out += (size_t)blockIdx.y * stride;
  const int tb = bid - first;
  const int ty = tb / tiles_x;
  const int x0 = (tb - ty * tiles_x) * TILE_W;
  const int y0 = ty * TILE_H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_qn = 0;

  // Stage rows y0-4 .. y0+19, columns x0-4 .. x0+65: warp w takes rows w,
  // w+8 and w+16, and every load is issued before the first store. Entries
  // outside the image hold 0 and are never read: only pixels at least 3 px
  // inside the image are scored, and their circles stay inside it.
  static_assert(SH == 3 * WARPS && SW <= 3 * 32, "staging covers the tile in 3 x 3 steps");
  {
    float v[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int gy = y0 - HALO + warp + WARPS * r;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int gx = x0 - HALO + lane + 32 * c;
        v[r][c] = 0.f;
        if (lane + 32 * c < SW && gy >= 0 && gy < h && gx >= 0 && gx < w)
          v[r][c] = __ldg(img + (size_t)gy * w + gx);
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if (lane + 32 * c < SW) {
          s_img[warp + WARPS * r][lane + 32 * c] = v[r][c];
          s_neg[warp + WARPS * r][lane + 32 * c] = -v[r][c];
        }
  }
  __syncthreads();

  // Each lane owns one score column (two warps span the 64) and walks down
  // a quarter of the score rows: pre-test every pixel of the tile plus a
  // 1-px ring (0 outside the 3-px inset interior) and queue each side that
  // passes, compacted by warp ballots with one shared atomic per warp, so
  // that the arc work below runs on full warps.
  static_assert(CW == 2 * 32 && WARPS == 8, "two warps a score row, four row groups");
  const int col = ((warp & 1) << 5) + lane;  // score column; output column col - 1
  const int group = warp >> 1;
  {
    constexpr int RMAX = (CH + 3) / 4;  // rows a group: 4 or 5
    const int rb = CH * group / 4, re = CH * (group + 1) / 4;
    const int gx = x0 - 1 + col;
    const bool col_in = gx >= 3 && gx < w - 3;
    unsigned bb[RMAX], bd[RMAX];
    int total = 0;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const int cy = rb + r, gy = y0 - 1 + cy;
      unsigned sides = 0;
      if (cy < re) {  // the test reads the staged tile only, so it runs unmasked
        const bool inside = col_in && gy >= 3 && gy < h - 3;
        sides = compass_sides(s_img, cy + HALO - 1, col + HALO - 1, min_th) & (inside ? 3u : 0u);
        s_score[cy][col] = 0.f;
      }
      bb[r] = __ballot_sync(0xffffffffu, sides & 1u);
      bd[r] = __ballot_sync(0xffffffffu, sides & 2u);
      total += __popc(bb[r]) + __popc(bd[r]);
    }
    int base = 0;
    if (lane == 0 && total) base = atomicAdd(&s_qn, total);
    base = __shfl_sync(0xffffffffu, base, 0);
    const unsigned lt = (1u << lane) - 1u;
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const unsigned e = ((rb + r) << 7) | col;
      if ((bb[r] >> lane) & 1u) s_queue[base + __popc(bb[r] & lt)] = e;
      base += __popc(bb[r]);
      if ((bd[r] >> lane) & 1u) s_queue[base + __popc(bd[r] & lt)] = e | 0x8000u;
      base += __popc(bd[r]);
    }
  }
  __syncthreads();

  // Arc scores of the queued sides. A score is +0 or above min_th >= 0, so
  // the larger of a pixel's two sides wins an integer atomicMax on its bits.
  const int qn = s_qn;
  for (int i = threadIdx.x; i < qn; i += NT) {
    const unsigned e = s_queue[i];
    const int cy = (e >> 7) & 31, cx = e & 127;
    const float sc = arc_score((e & 0x8000u) ? s_neg : s_img, cy + HALO - 1, cx + HALO - 1,
                               min_th);
    if (sc > 0.f) atomicMax(reinterpret_cast<int*>(&s_score[cy][cx]), __float_as_int(sc));
  }
  __syncthreads();

  // NMS down the same column strips: the 3-wide maxima of the 6 score rows
  // around a group's 4 output rows, then 3-high maxima of those.
  {
    const int oy0 = group * (TILE_H / 4);
    float hm[TILE_H / 4 + 2];
#pragma unroll
    for (int i = 0; i < TILE_H / 4 + 2; ++i)
      hm[i] = fmaxf(fmaxf(s_score[oy0 + i][col - 1 < 0 ? 0 : col - 1], s_score[oy0 + i][col]),
                    s_score[oy0 + i][col + 1]);
    const int ox = col - 1, gx = x0 + ox;
    if (ox >= 0 && ox < TILE_W && gx < w) {
#pragma unroll
      for (int i = 0; i < TILE_H / 4; ++i) {
        const int gy = y0 + oy0 + i;
        if (gy >= h) break;
        const float c = s_score[oy0 + i + 1][col];
        const float m = fmaxf(fmaxf(hm[i], hm[i + 1]), hm[i + 2]);
        out[(size_t)gy * w + gx] = c >= m ? c : 0.f;
      }
    }
  }
}

}  // namespace

// Scores every level of `levels` (1..MAX_LEVELS entries) of each of the
// n_images images in one launch: level l of image b is the contiguous (h, w)
// float32 image at levels[l].img + b * levels[l].stride, its output at the
// same offset from levels[l].out.
extern "C" int fast_score_nms_launch(const FastLevel* levels, int n_levels, int n_images,
                                     float min_th, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return cudaErrorInvalidValue;
  if (n_images < 1 || n_images > 65535) return cudaErrorInvalidValue;
  LevelTable tab;
  int blocks = 0;
  for (int i = 0; i < MAX_LEVELS; ++i) {
    if (i < n_levels) {
      const FastLevel& l = levels[i];
      if (l.h < 1 || l.w < 1 || (n_images > 1 && l.stride < (long long)l.h * l.w))
        return cudaErrorInvalidValue;
      const int tx = (l.w + TILE_W - 1) / TILE_W, ty = (l.h + TILE_H - 1) / TILE_H;
      tab.lv[i] = LevelDesc{l.img, l.out, l.stride, l.h, l.w, tx, blocks};
      blocks += tx * ty;
    } else {
      tab.lv[i] = LevelDesc{nullptr, nullptr, 0, 0, 0, 1, INT_MAX};  // never chosen
    }
  }
  fast_score_nms_kernel<<<dim3(blocks, n_images), NT, 0, stream>>>(tab, min_th);
  return static_cast<int>(cudaGetLastError());
}
