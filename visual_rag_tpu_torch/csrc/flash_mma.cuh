// The warp-level tile products that the bf16 instances of K10's forward
// (flash_attention.cu) and of its backward, B4 and B5 (flash_attention_bwd.cu),
// share, over the mma.sync, ldmatrix and cp.async wrappers of mma_tiles.cuh (whose
// fragment layout the comments below use): bf16 tiles of a head's rows copied into
// shared memory, S = Q K^T (or dP = dO V^T) of one warp's 16 rows, the C-to-A
// repacking of a logit tile as a bf16 pair hi + lo, and acc += A B with A given as
// that pair.
#pragma once

#include "flash_common.cuh"
#include "mma_tiles.cuh"

namespace vrt_fa {

using bf16 = __nv_bfloat16;

template <int DH>
struct MmaTile {
  static constexpr int DHP = (DH + 15) / 16 * 16;  // head dim padded to a k-step of 16 (72 -> 80)
  // bf16 row stride of a tile in shared memory (144, 176, 176, 272 or 528 bytes): the 8
  // rows of an ldmatrix fall on distinct banks
  static constexpr int LDB = DHP + 8;
};

// Rows [row0, row0 + ROWS) of one head (DH bf16 each) into dst[r * LDB ..] by
// 16-byte cp.async from NT threads, DHP columns a row: rows at or past t_len and the
// columns DH..DHP (Dh 72: its fifth k-step and tenth n8 tile read them) are
// zero-filled, reading nothing (their source is the row's, or row 0's, first chunk).
template <int DH, int ROWS, int NT = THREADS>
__device__ __forceinline__ void cp_rows(const bf16* __restrict__ base, long long row_stride,
                                        int row0, int t_len, bf16* __restrict__ dst) {
  constexpr int LDB = MmaTile<DH>::LDB, CPR = MmaTile<DH>::DHP / 8, TOTAL = ROWS * CPR;
  for (int idx = threadIdx.x; idx < TOTAL; idx += NT) {
    const int r = idx / CPR, c = idx % CPR;
    const bool in = row0 + r < t_len, full = in && c < DH / 8;
    cp_async_16(dst + r * LDB + c * 8,
                base + (in ? row0 + r : 0) * row_stride + (full ? c * 8 : 0), full);
  }
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x0, x1) as a bf16 pair hi + lo: hi = bf16(x), lo = bf16(x - hi), so |x - hi -
// lo| <= 2^-18 |x|.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 f = __bfloat1622float2(h);
  hi = bf16_bits(h);
  lo = bf16_bits(__floats2bfloat162_rn(x0 - f.x, x1 - f.y));
}

// The f32 C fragments of two adjacent n8 tiles (c0: columns 0-7, c1: columns 8-15 of
// a warp's 16 x 16 tile) as the A fragment of one k16 step, each pair of values split
// as hi + lo. The C and A layouts of m16n8k16 give a lane the same (row, column)
// pairs (rows g and g + 8, columns 2t, 2t + 1 of each n8 tile), so a logit tile
// becomes the A operand of the next product without leaving the registers.
__device__ __forceinline__ void c_to_a_split(const float (&c0)[4], const float (&c1)[4],
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// acc[n] += the warp's 16-row x 16k A fragment (as hi and lo) times B[k0..k0+15][n0 +
// 8n ..] for N n8 tiles, B from a [k][n] bf16 tile of row stride LD by ldmatrix.trans.
template <int N, int LD>
__device__ __forceinline__ void mma_rows_split(float (&acc)[N][4], const uint32_t (&ahi)[4],
                                               const uint32_t (&alo)[4],
                                               const bf16* __restrict__ b, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  const bf16* row = b + (k0 + (lane & 15)) * LD + n0 + (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n + 1 < N; n += 2) {
    uint32_t f[4];
    ldsm_x4_trans(f, row + n * 8);
    mma_bf16_16816(acc[n], ahi, f[0], f[1]);
    mma_bf16_16816(acc[n], alo, f[0], f[1]);
    mma_bf16_16816(acc[n + 1], ahi, f[2], f[3]);
    mma_bf16_16816(acc[n + 1], alo, f[2], f[3]);
  }
  if constexpr (N % 2 == 1) {
    uint32_t f[2];
    ldsm_x2_trans(f, b + (k0 + (lane & 15)) * LD + n0 + (N - 1) * 8);
    mma_bf16_16816(acc[N - 1], ahi, f[0], f[1]);
    mma_bf16_16816(acc[N - 1], alo, f[0], f[1]);
  }
}

// acc[n] = rows r0..r0+15 of `a` . rows n0 + 8n .. of `b` over the DHP columns
// (both [row][d] bf16 tiles of row stride LD): S or dP of a warp, N n8 tiles.
template <int N, int DHP, int LD>
__device__ __forceinline__ void mma_dots(float (&acc)[N][4], const bf16* __restrict__ a, int r0,
                                         const bf16* __restrict__ b, int n0) {
  static_assert(N % 2 == 0, "n8 tiles in pairs");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* arow = a + (r0 + (lane & 15)) * LD + (lane >> 4) * 8;
  const bf16* brow = b + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k = 0; k < DHP; k += 16) {
    uint32_t fa[4];
    ldsm_x4(fa, arow + k);
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t fb[4];
      ldsm_x4(fb, brow + n * 8 * LD + k);
      mma_bf16_16816(acc[n], fa, fb[0], fb[1]);
      mma_bf16_16816(acc[n + 1], fa, fb[2], fb[3]);
    }
  }
}

// The A fragments of rows r0..r0+15 of `a` ([row][d] bf16, row stride LD), one a
// k-step of 16 columns: what mma_dots reads at each step, kept in registers.
template <int KS, int LD>
__device__ __forceinline__ void load_a_frags(uint32_t (&fa)[KS][4], const bf16* __restrict__ a,
                                             int r0) {
  const int lane = threadIdx.x & 31;
  const bf16* arow = a + (r0 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
  for (int k = 0; k < KS; ++k) ldsm_x4(fa[k], arow + 16 * k);
}

// mma_dots with the warp's A fragments already in registers (load_a_frags): acc[n] =
// A . rows n0 + 8n .. of `b` over KS k-steps, in mma_dots's order.
template <int N, int KS, int LD>
__device__ __forceinline__ void mma_dots_frags(float (&acc)[N][4], const uint32_t (&fa)[KS][4],
                                               const bf16* __restrict__ b, int n0) {
  static_assert(N % 2 == 0, "n8 tiles in pairs");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const bf16* brow = b + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
#pragma unroll
    for (int n = 0; n < N; n += 2) {
      uint32_t fb[4];
      ldsm_x4(fb, brow + n * 8 * LD + 16 * k);
      mma_bf16_16816(acc[n], fa[k], fb[0], fb[1]);
      mma_bf16_16816(acc[n + 1], fa[k], fb[2], fb[3]);
    }
  }
}

}  // namespace vrt_fa
