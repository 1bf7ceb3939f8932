// Fused gated Hamming distance + top-2 over 256-bit descriptors.
//
// Replaces the JAX package's Pallas kernel ops/pallas_matching.py::hamming_top2
// (body `_kernel`, pallas_call at :116). For each query row i and the target
// columns j with gate[i, j] set, it returns
//   best[i]   = min_j popcount(q[i] ^ t[j])
//   idx[i]    = the lowest j attaining best
//   second[i] = the min over every gated column except idx[i]
// and best = second = BIG (1 << 20), idx = -1 on a row with nothing gated.
// The N x M distance matrix never exists in memory.
//
// What bounds it on an H100: the gate must be read once, N*M bytes (8.4 MB
// at the local-map shape 8192 x 1024, 2.5 us at 3.35 TB/s), beside the
// descriptors (32 B per row and column). Distances cost 512 bit-operations
// a pair; on the int8 tensor cores (1979 T/s) even a fully gated 8192 x 1024
// block is 2.2 us, so the gate's bytes bind whether it is windowed or dense.
//
// Design: a block takes a tile of ROWS = 16 query rows (the m16 of the
// tensor-core instruction); each of its 8 warps walks two of the rows, and
// the block walks the columns in groups of GROUP = 2 tiles of COLS = 512.
// Per group:
// - Each warp reads its rows' gate 16 bytes a lane (512 columns in one warp
//   instruction), every chunk of the group issued before the first is used.
//   Chunks are aligned down from the row start: where a row does not start
//   on 16 bytes (M % 16 != 0), each lane takes its neighbour's chunk by a
//   shuffle (lane 31 the next tile's first one, lane 0 loading one past the
//   group), and the bytes become a 16-bit mask shifted into column order, so
//   lane l holds columns c0+16l..+15 of each tile.
// - The block counts each tile's gated pairs (one __syncthreads per group;
//   counts and masks are double-buffered in shared memory).
// - A tile with at most DENSE_MIN_PAIRS gated pairs goes to the sparse walk:
//   each lane visits its gated columns of both rows in ascending order and
//   reads each target's 32 bytes with __ldg (the 32 KB target table stays in
//   L1/L2; nothing is staged), with no barrier in the walk.
// - A tile with more runs on the tensor cores. Every warp holds the block's
//   16 queries as the A fragment of mma.sync m16n8k256 .b1 .and.popc, which
//   gives popc(q & t) for 16 queries x 8 targets in one instruction with no
//   unpacking, and the distance is |q| + |t| - 2 popc(q & t) (the 1-bit
//   counts come from the fragments by shuffles). Each warp takes 8 of the
//   tile's 64 n8 column blocks, issues their 8 target reads at once, reads
//   the gate bits from the shared masks and folds the gated distances. The
//   .xor.popc form has no instruction of its own on sm_90a: ptxas emits two
//   BMMA .AND.POPC for it. Such a tile adds 1 to the `dense_tiles` counter.
// DENSE_MIN_PAIRS: the sparse walk costs about one dependent 32-byte L1/L2
// read and 8 __popc per gated pair on one lane, the tensor-core path a fixed
// 64 instructions and 16 KB of target reads per tile. chip_smoke.py times
// both on 8192 x 1024 gates against an empty one: on an H100 (700 W) 8-9 ps
// a walked pair and 7-8 ns a tensor-core tile, equal near 850 of a tile's
// 8192 pairs (PERF.md); 1024 keeps tiles near that line on the walk.
// Every path keeps per lane the two smallest keys (distance << 22 | column)
// of its gated pairs: the smallest gives best and the lowest-index idx, the
// second smallest the minimum over every other gated column, ties included.
// Partial results merge with best = min(bA, bB), second = min(max(bA, bB),
// sA, sB). A row tile walks every column tile, so no merge crosses blocks.
// Grid: one block per 16 rows, 64 blocks at 1024 x 1024 (512 at 8192 x
// 1024, all resident at once at 4 blocks an SM), fewer than the 132 SMs at
// 1024 rows. The 16-row tile is the unit that shares each target read among
// 16 queries on the dense path; spreading a row's columns over more blocks
// would need a merge across blocks. At 1024 rows the walk is bound by the
// latency of its dependent reads, not by SMs.
// Batches: gridDim.y = B problems, each with its own targets, gate and
// outputs at a fixed stride, and its queries at a stride q_stride rows: 0
// when the problems share the queries (the local mapper projects one
// candidate set into 10 keyframes at once), n when each has its own (B
// sequences tracked in one step match their own frames against their own
// maps). Block (x, y) is the 16-row tile x of problem y and does exactly
// what block x of a single problem does, so an unbatched call is the B = 1
// case of the same kernel. 10 x 2048 rows give 1280 blocks where 2048 rows
// alone give 128, fewer than the 132 SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 16;              // query rows per block: the m16 of the mma
constexpr int WARPS = 8;              // warp w walks rows w and w + 8
constexpr int NT = WARPS * 32;
constexpr int COLS = 512;             // column tile: 16 gate bytes a lane
constexpr int GROUP = 2;              // column tiles loaded per barrier
constexpr int N8_PER_WARP = COLS / 8 / WARPS;
constexpr int BIG = 1 << 20;
constexpr int DENSE_MIN_PAIRS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// A gated pair as one int key, distance << IDX_BITS | column: keys order
// by distance, then by the lower column, so the smallest key is (best, idx)
// with the lowest-index tie rule, and the second smallest key's distance is
// the minimum over every other gated column. NONE stands for no pair.
constexpr int IDX_BITS = 22;  // columns < 2^22; distances <= 256 fit above
constexpr int NONE = 0x7fffffff;

__device__ __forceinline__ int key(int d, int j) { return (d << IDX_BITS) | j; }

// the two smallest keys seen; best <= second always
struct Top2 {
  int best, second;
};

__device__ __forceinline__ void fold(Top2& r, int k) {
  r.second = min(r.second, max(r.best, k));
  r.best = min(r.best, k);
}

__device__ __forceinline__ void merge(Top2& r, const Top2& o) {
  r.second = min(max(r.best, o.best), min(r.second, o.second));
  r.best = min(r.best, o.best);
}

// merge across lanes whose ids differ in bits FIRST, FIRST/2, ..., 1
template <int FIRST>
__device__ __forceinline__ void warp_merge(Top2& r) {
#pragma unroll
  for (int off = FIRST; off > 0; off >>= 1)
    merge(r, Top2{__shfl_xor_sync(FULL, r.best, off), __shfl_xor_sync(FULL, r.second, off)});
}

__device__ __forceinline__ int hamming(const uint4& qa, const uint4& qb, const uint32_t* tp) {
  const uint4 ta = __ldg(reinterpret_cast<const uint4*>(tp));
  const uint4 tb = __ldg(reinterpret_cast<const uint4*>(tp) + 1);
  return __popc(qa.x ^ ta.x) + __popc(qa.y ^ ta.y) + __popc(qa.z ^ ta.z) +
         __popc(qa.w ^ ta.w) + __popc(qb.x ^ tb.x) + __popc(qb.y ^ tb.y) +
         __popc(qb.z ^ tb.z) + __popc(qb.w ^ tb.w);
}

// bit k set iff byte k of the 16-byte chunk is nonzero
__device__ __forceinline__ unsigned chunk_mask(const uint4& v) {
  auto m4 = [](unsigned w) { return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28; };
  return m4(v.x) | (m4(v.y) << 4) | (m4(v.z) << 8) | (m4(v.w) << 12);
}

// One query row's gate, read as 16-byte chunks aligned down from its start.
struct GateRow {
  const uint8_t* abase;  // the row's first byte, aligned down to 16
  int mis;               // the row start's offset from abase
  bool live;
};

// Issues the loads of the group of column tiles at c0: chunk k*32 + lane of
// the row for k < GROUP, and on lane 0 the chunk after the group, which a
// misaligned row's last tile needs on lane 31.
__device__ __forceinline__ void load_chunks(const GateRow& r, int m, int c0, int lane,
                                            uint4 (&v)[GROUP + 1]) {
#pragma unroll
  for (int k = 0; k <= GROUP; ++k) {
    v[k] = make_uint4(0, 0, 0, 0);
    const int col = c0 + k * COLS + 16 * lane - r.mis;  // column of the chunk's first byte
    const bool need = k < GROUP ? col + 16 > 0 && col < m : lane == 0 && r.mis && col < m;
    if (r.live && need)
      v[k] = __ldg(reinterpret_cast<const uint4*>(r.abase + c0 + k * COLS + 16 * lane));
  }
}

// Turns loaded chunks into each lane's 16-bit mask of columns
// c0 + k*COLS + 16*lane .. +15 (bit b = column + b), clipped at m.
__device__ __forceinline__ void chunk_masks(const uint4 (&v)[GROUP + 1], int mis, int m,
                                            int c0, int lane, unsigned (&out)[GROUP]) {
  unsigned mk[GROUP + 1];
#pragma unroll
  for (int k = 0; k <= GROUP; ++k) mk[k] = chunk_mask(v[k]);
#pragma unroll
  for (int k = 0; k < GROUP; ++k) {
    unsigned next = __shfl_down_sync(FULL, mk[k], 1);
    const unsigned first_of_next = __shfl_sync(FULL, mk[k + 1], 0);
    if (lane == 31) next = first_of_next;
    unsigned mask = ((mk[k] | (next << 16)) >> mis) & 0xffffu;
    const int cl = c0 + k * COLS + 16 * lane;
    if (cl + 16 > m) mask &= cl >= m ? 0u : (1u << (m - cl)) - 1u;
    out[k] = mask;
  }
}

__global__ void __launch_bounds__(NT, 4)
hamming_top2_kernel(const uint32_t* __restrict__ q, const uint32_t* __restrict__ t,
                    const uint8_t* __restrict__ gate, int n, int m, int q_stride,
                    int* __restrict__ best_out, int* __restrict__ idx_out,
                    int* __restrict__ second_out, int* __restrict__ dense_tiles) {
  __shared__ uint16_t s_bits[2][GROUP][ROWS][32];  // per tile, row, lane: 16 gate bits
  __shared__ int s_cnt[2][GROUP][WARPS];
  __shared__ Top2 s_part[WARPS][ROWS];

  // problem blockIdx.y of the batch: its queries, targets, gate and outputs
  q += (size_t)blockIdx.y * q_stride * 8;
  t += (size_t)blockIdx.y * m * 8;
  gate += (size_t)blockIdx.y * n * m;
  best_out += (size_t)blockIdx.y * n;
  idx_out += (size_t)blockIdx.y * n;
  second_out += (size_t)blockIdx.y * n;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // mma fragment coordinates
  const int row0 = blockIdx.x * ROWS;
  const int ra = row0 + warp, rb = ra + 8;  // this warp's two rows

  // the block's 16 queries as the A fragment: rows g and g+8, words 2tq and
  // 2tq+1 (the B fragment takes the same words of each target, so the k
  // order is the same permutation on both sides)
  uint2 alo = make_uint2(0, 0), ahi = alo;
  if (row0 + g < n) alo = __ldg(reinterpret_cast<const uint2*>(q + (size_t)(row0 + g) * 8) + tq);
  if (row0 + g + 8 < n)
    ahi = __ldg(reinterpret_cast<const uint2*>(q + (size_t)(row0 + g + 8) * 8) + tq);
  // |q| of rows g and g+8, summed over the 4 lanes that hold their words
  int pq0 = __popc(alo.x) + __popc(alo.y), pq1 = __popc(ahi.x) + __popc(ahi.y);
  pq0 += __shfl_xor_sync(FULL, pq0, 1);
  pq1 += __shfl_xor_sync(FULL, pq1, 1);
  pq0 += __shfl_xor_sync(FULL, pq0, 2);
  pq1 += __shfl_xor_sync(FULL, pq1, 2);

  auto gate_row = [&](int r) {
    const uint8_t* p = gate + (size_t)(r < n ? r : 0) * m;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
    return GateRow{p - mis, mis, r < n};
  };
  const GateRow ga = gate_row(ra), gb = gate_row(rb);

  Top2 sa{NONE, NONE}, sb{NONE, NONE};  // sparse walk: rows ra, rb on this lane
  Top2 d0{NONE, NONE}, d1{NONE, NONE};  // tensor cores: rows row0+g, row0+g+8
  bool any_dense = false;

  for (int c0 = 0, buf = 0; c0 < m; c0 += GROUP * COLS, buf ^= 1) {
    uint4 va[GROUP + 1], vb[GROUP + 1];
    load_chunks(ga, m, c0, lane, va);
    load_chunks(gb, m, c0, lane, vb);
    unsigned ma[GROUP], mb[GROUP];
    chunk_masks(va, ga.mis, m, c0, lane, ma);
    chunk_masks(vb, gb.mis, m, c0, lane, mb);
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int cnt = __reduce_add_sync(FULL, __popc(ma[k]) + __popc(mb[k]));
      s_bits[buf][k][warp][lane] = static_cast<uint16_t>(ma[k]);
      s_bits[buf][k][warp + 8][lane] = static_cast<uint16_t>(mb[k]);
      if (lane == 0) s_cnt[buf][k][warp] = cnt;
    }
    __syncthreads();

    unsigned wa = 0, wb = 0;  // sparse tiles' bits: tile k at bits 16k..16k+15
#pragma unroll
    for (int k = 0; k < GROUP; ++k) {
      const int ck = c0 + k * COLS;
      if (ck >= m) break;
      int total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) total += s_cnt[buf][k][w];
      if (total <= DENSE_MIN_PAIRS) {
        wa |= ma[k] << (16 * k);
        wb |= mb[k] << (16 * k);
        continue;
      }
      any_dense = true;
      if (threadIdx.x == 0) atomicAdd(dense_tiles, 1);
      uint2 bv[N8_PER_WARP];  // all target reads in flight before the first mma
#pragma unroll
      for (int i = 0; i < N8_PER_WARP; ++i) {
        const int cb = ck + (warp + WARPS * i) * 8;
        bv[i] = make_uint2(0, 0);
        if (cb < m)
          bv[i] = __ldg(reinterpret_cast<const uint2*>(t + (size_t)min(cb + g, m - 1) * 8) + tq);
      }
#pragma unroll
      for (int i = 0; i < N8_PER_WARP; ++i) {
        const int nt = warp + WARPS * i;
        const int cb = ck + nt * 8;
        if (cb >= m) break;
        // |t| of column cb+g over its group's 4 lanes, then of columns j, j+1
        int pt = __popc(bv[i].x) + __popc(bv[i].y);
        pt += __shfl_xor_sync(FULL, pt, 1);
        pt += __shfl_xor_sync(FULL, pt, 2);
        const int pt0 = __shfl_sync(FULL, pt, 8 * tq), pt1 = __shfl_sync(FULL, pt, 8 * tq + 4);
        int e0 = 0, e1 = 0, e2 = 0, e3 = 0;  // popc(q & t)
        asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(e0), "+r"(e1), "+r"(e2), "+r"(e3)
            : "r"(alo.x), "r"(ahi.x), "r"(alo.y), "r"(ahi.y), "r"(bv[i].x), "r"(bv[i].y));
        // popc(q ^ t) = |q| + |t| - 2 popc(q & t); e0, e1: row g, columns
        // j, j+1; e2, e3: row g+8, the same columns
        const int sh = ((nt & 1) << 3) + 2 * tq;
        const unsigned g0 = s_bits[buf][k][g][nt >> 1] >> sh;
        const unsigned g1 = s_bits[buf][k][g + 8][nt >> 1] >> sh;
        const int j = cb + 2 * tq;
        const int k0 = (g0 & 1u) ? key(pq0 + pt0 - 2 * e0, j) : NONE;
        const int k1 = (g0 & 2u) ? key(pq0 + pt1 - 2 * e1, j + 1) : NONE;
        const int k2 = (g1 & 1u) ? key(pq1 + pt0 - 2 * e2, j) : NONE;
        const int k3 = (g1 & 2u) ? key(pq1 + pt1 - 2 * e3, j + 1) : NONE;
        merge(d0, Top2{min(k0, k1), max(k0, k1)});
        merge(d1, Top2{min(k2, k3), max(k2, k3)});
      }
    }

    // the sparse walk: each lane visits its gated columns of both rows in
    // ascending order, one of each row per step, every target read by __ldg
    while (wa | wb) {
      int ja = -1, jb = -1;
      if (wa) {
        const int b = __ffs(wa) - 1;
        wa &= wa - 1;
        ja = c0 + (b >> 4) * COLS + 16 * lane + (b & 15);
      }
      if (wb) {
        const int b = __ffs(wb) - 1;
        wb &= wb - 1;
        jb = c0 + (b >> 4) * COLS + 16 * lane + (b & 15);
      }
      if (ja >= 0) {
        const uint4* qp = reinterpret_cast<const uint4*>(q + (size_t)ra * 8);
        fold(sa, key(hamming(__ldg(qp), __ldg(qp + 1), t + (size_t)ja * 8), ja));
      }
      if (jb >= 0) {
        const uint4* qp = reinterpret_cast<const uint4*>(q + (size_t)rb * 8);
        fold(sb, key(hamming(__ldg(qp), __ldg(qp + 1), t + (size_t)jb * 8), jb));
      }
    }
  }

  warp_merge<16>(sa);
  warp_merge<16>(sb);
  if (any_dense) {  // the same on every thread of the block
    warp_merge<2>(d0);
    warp_merge<2>(d1);
    if (tq == 0) {
      s_part[warp][g] = d0;
      s_part[warp][g + 8] = d1;
    }
    __syncthreads();
    // lanes 0-7 gather row ra's partials from the 8 warps, lanes 8-15 rb's
    Top2 p{NONE, NONE};
    if (lane < 16) p = s_part[lane & 7][warp + (lane & 8)];
    warp_merge<4>(p);
    merge(sa, Top2{__shfl_sync(FULL, p.best, 0), __shfl_sync(FULL, p.second, 0)});
    merge(sb, Top2{__shfl_sync(FULL, p.best, 8), __shfl_sync(FULL, p.second, 8)});
  }
  auto store = [&](int r, const Top2& v) {
    best_out[r] = v.best == NONE ? BIG : v.best >> IDX_BITS;
    idx_out[r] = v.best == NONE ? -1 : v.best & ((1 << IDX_BITS) - 1);
    second_out[r] = v.second == NONE ? BIG : v.second >> IDX_BITS;
  };
  if (lane == 0) {
    if (ga.live) store(ra, sa);
    if (gb.live) store(rb, sb);
  }
}

}  // namespace

// q (n, 32) bytes shared by the batch (q_stride 0) or (batch, n, 32) bytes,
// one set a problem (q_stride n); t (batch, m, 32) bytes, both 16-byte
// aligned; gate (batch, n, m) bytes, any alignment, m < 2^22; outputs
// (batch, n); dense_tiles: one int that counts tensor-core tiles.
extern "C" int hamming_top2_batched_launch(const void* q, const void* t, const uint8_t* gate,
                                           int n, int m, int batch, int q_stride, int* best,
                                           int* idx, int* second, int* dense_tiles,
                                           cudaStream_t stream) {
  if (q_stride != 0 && q_stride != n) return cudaErrorInvalidValue;
  const dim3 grid((n + ROWS - 1) / ROWS, batch);
  hamming_top2_kernel<<<grid, NT, 0, stream>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(t), gate, n, m, q_stride,
      best, idx, second, dense_tiles);
  return static_cast<int>(cudaGetLastError());
}

// A 16 x 512 tile with more gated pairs than this runs on the tensor cores.
extern "C" int hamming_dense_min_pairs() { return DENSE_MIN_PAIRS; }
