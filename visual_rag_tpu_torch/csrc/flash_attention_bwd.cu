// B4 and B5: the backward of K10 (flash attention with segment ids, an
// optional causal mask and grouped kv heads), at head dims 64, 72, 80, 128 and
// 256, f32 and bf16.
//
// Replace the TPU kernels that jax.grad reaches through
// visual_rag_tpu/models/attention.py::mha (:61-73): the library's
// jax/experimental/pallas/ops/tpu/flash_attention.py, B4
// _flash_attention_bwd_dkv (pallas_call :1121) and B5 _flash_attention_bwd_dq
// (pallas_call :1456), with the function of its mha_reference_bwd (:1615).
// From q, k, v, dO, the forward's lse (m + log l, f32 [B, Hq, T]) and di =
// rowsum(dO * O) (f32 [B, Hq, T], computed outside, as the library does at
// :273), for each allowed pair (i, j) of head h on kv head h / group:
//
//   P_ij = exp(sm_scale * q_i . k_j - lse_i)    dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - di_i)
//   dV_j = sum_i P_ij dO_i      dK_j = sm_scale sum_i dS_ij q_i      (B4)
//   dQ_i = sm_scale sum_j dS_ij k_j                                   (B5)
//
// summed over the group's query heads for dK and dV (the JAX package repeats
// the kv heads, so its autodiff sums them). Pairs that are not allowed add
// exactly 0: P is set to 0 there (the multiplicative mask), so a row with no
// allowed key (lse -inf) gives 0, never NaN. dQ, dK and dV are written in the
// input dtype. The f32 instances keep P and dS in f32; the bf16 instances feed
// them to the tensor cores as a bf16 pair, about 16 bits (below). The library
// rounds them to the input dtype before its products.
//
// Head dims: 64 (both towers of ColSmol-500M), 72 (ColPali's SigLIP vision
// tower, 16 heads), 80 (ColQwen2.5's vision tower, 16 heads, window segments),
// 128 (ColQwen2.5's Qwen2.5 text model, 16 heads on 2 kv heads, causal) and
// 256 (ColPali's Gemma text model, 8 heads on one kv head). Each is an
// explicit instance of the templated kernels (is_head_dim, flash_common.cuh).
//
// Both dtypes share the split (FlashAttention-2's, the library's too), the
// skips and the fixed order of every sum:
// - B4: one block per (BK-key kv tile, kv head, batch row); it walks the
//   64-row query tiles of the query heads of its kv head's group (in bf16, of
//   one slice of the group, below) and keeps dK and dV of its BK keys in
//   registers, so the group is summed with no atomics and two calls give the
//   same bits. B5: one block per (64-row query tile, head, batch row); it
//   walks the BK-key kv tiles and keeps dQ in registers. BK is 64, and 32 at
//   Dh 256.
// - K10's exact skips: a tile pair whose segment-id ranges do not meet
//   (seg_tile_range_kernel over BK-row tiles; a query tile's range is the
//   union of the BQ / BK entries that cover its rows), or that lies wholly
//   above the diagonal under causal, holds no allowed pair and is not
//   visited. At ColSmol's 17-tile vision (T 17408, a segment per 1024-patch
//   tile) 16 of 272 tiles are live per tile.
//
// The f32 instances (flash_bwd_dkv_kernel, flash_bwd_dq_kernel) run on the
// CUDA cores, bounded by f32 FMAs (67 TFLOP/s; B4 does 8 * Dh flops per
// allowed pair and head, B5 6 * Dh):
// - 256 threads as 16 x 16. Step A (S and dP of a tile pair): thread (ty, tx)
//   owns rows of the tile that stays (BK / 16 keys in B4, 4 queries in B5)
//   and columns tx + 16c of the tile that walks (4 of the 64 queries in B4,
//   BK / 16 keys in B5). Tiles sit in shared memory as f32 rows of LD = DHP +
//   4 floats (DHP: the head dim rounded up to 16): 8 consecutive threads read
//   16-byte vectors from 8 rows at distinct banks (LD is 4 or 20 mod 32), and
//   the owned rows are read by a whole half-warp at one address. The logits
//   sum over the Dh real columns only. P^T and dS^T (B4) or dS (B5) go to
//   shared memory. Step B (dV and dK, or dQ): the thread owns the same rows
//   and, of the head dim, columns 64c + 4tx..+3 of each full 64-column chunk
//   plus, where Dh is not a multiple of 64, column 64 * (Dh / 64) + tx: at Dh
//   72 that fifth column reads the zero columns 72..79 for tx >= 8 and is
//   stored only for tx < 8, as K10's forward does; at Dh 80 it is a real
//   column for every tx. Sums run head dim ascending in step A, rows
//   ascending in step B, then group heads and tiles ascending.
// - Step A computes P first and dP after it, reading P back from shared
//   memory, so that one patch of logits is live at a time beside the
//   accumulators (with S and dP live together the Dh 64 instances spilled at
//   128 registers).
// - Shared memory (f32 tiles, then lse, di and segment ids; a byte a walked
//   tile for the live flags follows, at most 16 KB at MAX_BWD_T): Dh 64 (LD
//   68) B4 105,472 bytes, B5 88,064, two blocks an SM (__launch_bounds__(256,
//   2), B4's loops not unrolled, DKV_UNROLL); Dh 72 and 80 (LD 84) B4 121,856,
//   B5 104,448, one block an SM (at most 255 registers); Dh 128 (LD 132) B4
//   171,008 with 4 keys x 8 columns of dK and of dV a thread, B5 153,600; Dh
//   256 (BK 32, LD 260) B4 217,984 with 2 keys x 16 columns, B5 209,792.
//
// The bf16 instances (flash_bwd_dkv_mma_kernel, flash_bwd_dq_mma_kernel) run
// their five products on the tensor cores: mma.sync m16n8k16 with bf16
// operands and f32 accumulation (mma_tiles.cuh, which also gives the fragment
// layout; the tile products they share with K10's forward are in flash_mma.cuh).
// What bounds them on the H100: the tensor cores' 989 TFLOP/s in
// bf16 against 67 on the CUDA cores; mma.sync reaches a part of that (wgmma,
// TMA and warp specialisation are later work), and the blocks a wave holds.
// - 256 threads, 8 warps; a warp owns 16 rows of every product. S and dP of
//   the bf16 inputs are exact products summed in f32. Before dV = P^T dO,
//   dK = dS^T Q and dQ = dS K each f32 value x of P or dS is written as hi =
//   bf16(x) and lo = bf16(x - hi) and both go through the tensor cores into
//   the same accumulator: |x - hi - lo| <= 2^-18 |x|, so one pass holds
//   BWD_TOL where one bf16 rounding (the library's) would miss its floor on
//   near-zero elements. That is 8 products where the math has 5.
// - B4: warp w owns keys 16 (w / WPG) .. +15 (WPG = 8 / (BK / 16) warps a
//   key group: 2, or 4 at Dh 256). Step A: it computes S^T = K Q^T and dP^T
//   = V dO^T for its keys and QW = 64 / WPG queries (K from ldmatrix as A,
//   Q and dO rows as B), makes P^T and dS^T = P^T (dP^T - di) in registers
//   and stores them as hi and lo bf16 tiles [BK][72] in shared memory. Step
//   B: the same warp takes P^T (dS^T) rows as A by ldmatrix and dO (Q) as B
//   by ldmatrix.trans, for its keys and NTB n8 tiles of the head dim (4 at
//   Dh 64, 5 at Dh 72 and 80, 8 at 128 and 256): 8 NTB f32 accumulators of
//   dK and dV a thread (32, 40, 40, 64, 64), never all Dh columns. At Dh 72
//   the tenth n8 tile reads the zero columns 72..79 and is not stored.
// - B5: warp w owns query rows 16 (w % 4) .. +15 and keys KW (w / 4) .. +KW-1
//   of each kv tile (KW = BK / 2). S = Q K^T and dP = dO V^T (Q, dO as A, K,
//   V rows as B) stay in registers; P and dS = P (dP - di) are made there,
//   and two adjacent 16 x 8 C tiles of dS, as hi and lo bf16 pairs, are
//   exactly one A fragment of dQ += dS K (K by ldmatrix.trans): dS never
//   goes through shared memory. A thread holds Dh / 2 dQ accumulators (32,
//   36, 40, 64, 128); at Dh 128 a warp takes its 32 keys as two passes of 16
//   (MmaCfg::CK), or S and dP beside them spill under two blocks' 128
//   registers. At the end the two key halves meet in shared memory and warps
//   0-3 write half 0 + half 1.
// - Tiles sit in shared memory in bf16, rows of LDB = DHP + 8 (144, 176, 176,
//   272 or 528 bytes: 8 rows of an ldmatrix fall on distinct banks). The
//   walked tiles (B4: Q, dO, lse, di and query segments; B5: K, V and key
//   segments) are double buffered by cp.async: tile n + 1 is copied while
//   tile n is computed. Rows at or past t_len and, at Dh 72, the columns
//   72..79 that its fifth k-step reads are zero-filled by the copies
//   themselves, so Dh 72 loads as Dh 80 does (with the pad written once at
//   the start instead, its B4 spilled under 128 registers).
// - Shared memory with the live flags at MAX_BWD_T: B4 (K, V, two buffers of
//   Q and dO, four [BK][72] P/dS tiles) Dh 64 102,144 bytes, Dh 72/80
//   114,432, both two blocks an SM (at most 128 registers); Dh 128 151,296
//   and Dh 256 197,248, one (at most 255). B5 (Q, dO, two buffers of K and
//   V) Dh 64 64,768, Dh 72/80 77,056, Dh 128 113,920, two blocks an SM; Dh
//   256 152,576, one. Every instance has 0 spill bytes (ptxas -v).
// - B4's head group split: where the grid (kv tile, kv head, batch row) has
//   fewer than two waves of blocks (2 x the SMs x the blocks an SM) and the
//   group is larger than 1, the group is cut into `splits` slices, the least
//   divisor of the group (at most MAX_SPLITS, 8) that reaches two waves. The
//   grid's y is then (kv head, slice): each block sums its slice's query
//   heads in ascending order into an f32 partial dK / dV in the scratch
//   ([splits, B, T, Hkv, Dh] each, after the range table), and
//   flash_bwd_dkv_reduce_kernel adds the slices in ascending order, scales
//   dK by sm_scale and writes bf16. No atomics: two calls give the same bits.
//   At ColQwen2.5's page text (B 4, T ~1024, 16 on 2) the 128 blocks become
//   512 (4 slices, 33.5 MB of scratch); at ColPali's (B 4, T 1088, 8 on 1)
//   136 become 272 (2 slices, 17.8 MB).
#include <math_constants.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace vrt_fa {

template <int DH>
struct BwdCfg {
  static constexpr int DHP = (DH + 15) / 16 * 16;   // head dim padded to 16 (72 -> 80)
  static constexpr int LD = DHP + 4;                // row stride of the Q, dO, K and V tiles
  static constexpr int BK = DH > 128 ? 32 : 64;     // keys a kv tile
  static constexpr int KR = BK / 16;                // keys a thread in step A
  static constexpr int QPK = BQ / BK;               // range entries (BK rows) a query tile covers
  static constexpr int FULL = DH / 64;              // 64-column chunks: 4 columns a thread each
  static constexpr int REST = DHP / 16 - 4 * FULL;  // a fifth column a thread (Dh 72, 80)
  static constexpr int NC = 4 * FULL + REST;        // head-dim columns a thread in step B
  static_assert(DH % 8 == 0 && REST <= 1, "whole 16-byte vectors, one column past the chunks");
  static constexpr int LDPT = BQ + 4;  // row stride of B4's P^T and dS^T, [BK][LDPT]
  static constexpr int LDS = BK + 4;   // row stride of B5's P / dS, [BQ][LDS]
  // the least blocks an SM: two at Dh 64 (at most 128 registers); one elsewhere
  // (B4 at Dh 72 and 80 and both kernels at 128 and 256 have the shared memory
  // for one only)
  static constexpr int MIN_BLOCKS = DH == 64 ? 2 : 1;
  // steps of the inner loops unrolled: under the 128-register cap B4's f32
  // instance spilled at 2 and not at 1; B5 spills at neither and runs
  // faster at 2
  static constexpr int DKV_UNROLL = 1, DQ_UNROLL = 2;
  static constexpr size_t ROW = sizeof(float) * LD;  // bytes of a tile row
  static constexpr size_t ROW_DATA = sizeof(float) * 2 * BQ + sizeof(int) * (BQ + BK);
  static constexpr size_t SMEM_DKV =
      ROW * (2 * BK + 2 * BQ) + sizeof(float) * 2 * BK * LDPT + ROW_DATA;
  static constexpr size_t SMEM_DQ = ROW * (2 * BQ + 2 * BK) + sizeof(float) * BQ * LDS + ROW_DATA;
  static size_t smem_bytes(size_t base, int n_flags) { return base + (n_flags + 15) / 16 * 16; }
};

// Rows [row0, row0 + ROWS) of one head, DH values each, into dst[r * LD + d]
// as f32; rows at or past t_len are zeros. Columns DH..LD are not written.
template <typename T, int DH, int LD, int ROWS>
__device__ __forceinline__ void load_rows(const T* __restrict__ base, long long row_stride,
                                          int row0, int t_len, float* __restrict__ dst) {
  constexpr int N = Vec<T>::N, PER_ROW = DH / N, TOTAL = ROWS * PER_ROW;
  static_assert(DH % N == 0, "whole 16-byte vectors a row");
#pragma unroll
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
    if (TOTAL % THREADS != 0 && idx >= TOTAL) break;  // the remainder round (Dh 72; 80 in bf16)
    const int r = idx / PER_ROW, g = idx % PER_ROW;
    float x[N];
    if (row0 + r < t_len) {
      Vec<T>::load(base + (row0 + r) * row_stride + g * N, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; e += 4)
      *reinterpret_cast<float4*>(dst + r * LD + g * N + e) =
          make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
  }
}

// Zeros in columns DH..LD of a [rows][LD] tile, which the loads never write:
// step B's fifth column reads them at Dh 72 (at Dh 80 nothing reads them).
// Nothing to do where DH % 64 == 0.
template <int DH, int LD>
__device__ __forceinline__ void zero_pad(float* __restrict__ tile, int rows) {
  if constexpr (DH % 64 != 0) {
    constexpr int W = LD - DH;
    for (int i = threadIdx.x; i < rows * W; i += THREADS) tile[(i / W) * LD + DH + i % W] = 0.f;
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(float4 a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// Step A: x[r][c] = own row RA * ty + r of a . walking row tx + 16c of b, over
// the DH real columns ascending, UNROLL steps of 4 at a time.
template <int RA, int CB, int DH, int LD, int UNROLL>
__device__ __forceinline__ void tile_dots(const float* __restrict__ a,
                                          const float* __restrict__ b, float (&x)[RA][CB]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < RA; ++r)
#pragma unroll
    for (int c = 0; c < CB; ++c) x[r][c] = 0.f;
#pragma unroll UNROLL
  for (int d = 0; d < DH; d += 4) {
    float4 w[CB];
#pragma unroll
    for (int c = 0; c < CB; ++c)
      w[c] = *reinterpret_cast<const float4*>(b + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const float4 o = *reinterpret_cast<const float4*>(a + (ty * RA + r) * LD + d);
#pragma unroll
      for (int c = 0; c < CB; ++c) x[r][c] = dot4(o, w[c], x[r][c]);
    }
  }
}

// The NC step-B columns a thread owns of one tile row: 4 of each
// full 64-column chunk, then the fifth (module comment).
template <int DH>
__device__ __forceinline__ void row_cols(const float* __restrict__ row, int tx,
                                         float (&w)[BwdCfg<DH>::NC]) {
  constexpr int FULL = BwdCfg<DH>::FULL;
#pragma unroll
  for (int cc = 0; cc < FULL; ++cc) {
    const float4 a = *reinterpret_cast<const float4*>(row + cc * 64 + tx * 4);
    w[4 * cc] = a.x; w[4 * cc + 1] = a.y; w[4 * cc + 2] = a.z; w[4 * cc + 3] = a.w;
  }
  if constexpr (BwdCfg<DH>::REST > 0) w[4 * FULL] = row[64 * FULL + tx];
}

// Writes row `dst` (DH values, contiguous) from a thread's NC columns times `s`.
template <typename T, int DH>
__device__ __forceinline__ void store_cols(T* __restrict__ dst, int tx,
                                           const float (&acc)[BwdCfg<DH>::NC], float s) {
  constexpr int FULL = BwdCfg<DH>::FULL;
#pragma unroll
  for (int cc = 0; cc < FULL; ++cc)
    Vec<T>::store4(dst + cc * 64 + tx * 4, acc[4 * cc] * s, acc[4 * cc + 1] * s,
                   acc[4 * cc + 2] * s, acc[4 * cc + 3] * s);
  if constexpr (BwdCfg<DH>::REST > 0) {
    if (64 * FULL + tx < DH) Vec<T>::store1(dst + 64 * FULL + tx, acc[4 * FULL] * s);
  }
}

// B4: dK and dV of one BK-key tile of one kv head (module comment).
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, BwdCfg<DH>::MIN_BLOCKS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const int* __restrict__ seg,
                     const int2* __restrict__ tile_range, const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                     int t_len, int n_qt, int n_kt, int hq, int hkv, int group, Strides qs,
                     Strides ks, Strides vs, Strides os, int causal, float sm_scale) {
  using C = BwdCfg<DH>;
  constexpr int LD = C::LD, BK = C::BK, KR = C::KR, QPK = C::QPK, LDPT = C::LDPT, NC = C::NC;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                 // [BK][LD]
  float* v_s = k_s + BK * LD;        // [BK][LD]
  float* q_s = v_s + BK * LD;        // [BQ][LD]
  float* do_s = q_s + BQ * LD;       // [BQ][LD]
  float* pt_s = do_s + BQ * LD;      // [BK][LDPT]: P^T
  float* dst_s = pt_s + BK * LDPT;   // [BK][LDPT]: dS^T
  float* lse_s = dst_s + BK * LDPT;  // [BQ]
  float* di_s = lse_s + BQ;          // [BQ]
  int* qseg_s = reinterpret_cast<int*>(di_s + BQ);                        // [BQ]
  int* kseg_s = qseg_s + BQ;                                              // [BK]
  unsigned char* live_s = reinterpret_cast<unsigned char*>(kseg_s + BK);  // [n_qt]

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, k0 = kt * BK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* segb = seg + static_cast<size_t>(b) * t_len;
  const int2* rb = tile_range + static_cast<size_t>(b) * n_kt;
  // a flag a query tile: does its segment range (the union of the range
  // entries of its rows) meet the kv tile's? Under causal a query tile that
  // ends before the kv tile starts has no allowed pair
  const int first = causal ? k0 / BQ : 0;
  const int2 kr = rb[kt];
  for (int j = tid; j < n_qt; j += THREADS) {
    int2 r = rb[j * QPK];
#pragma unroll
    for (int e = 1; e < QPK; ++e) {
      if (j * QPK + e < n_kt) {
        const int2 s = rb[j * QPK + e];
        r = make_int2(min(r.x, s.x), max(r.y, s.y));
      }
    }
    live_s[j] = j >= first && !(r.y < kr.x || r.x > kr.y);
  }
  zero_pad<DH, LD>(k_s, 2 * BK + 2 * BQ);  // K, V, Q and dO lie back to back
  load_rows<T, DH, LD, BK>(k + b * ks.b + kvh * ks.h, ks.t, k0, t_len, k_s);
  load_rows<T, DH, LD, BK>(v + b * vs.b + kvh * vs.h, vs.t, k0, t_len, v_s);
  if (tid < BK) kseg_s[tid] = k0 + tid < t_len ? segb[k0 + tid] : 0;
  __syncthreads();

  float dk_acc[KR][NC], dv_acc[KR][NC];
#pragma unroll
  for (int r = 0; r < KR; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dout + b * os.b + h * os.h;
    const float* lb = lse + (static_cast<size_t>(b) * hq + h) * t_len;
    const float* db = di + (static_cast<size_t>(b) * hq + h) * t_len;
    for (int qt = first; qt < n_qt; ++qt) {
      if (!live_s[qt]) continue;  // uniform over the block
      const int q0 = qt * BQ;
      load_rows<T, DH, LD, BQ>(qb, qs.t, q0, t_len, q_s);
      load_rows<T, DH, LD, BQ>(ob, os.t, q0, t_len, do_s);
      if (tid < BQ) {
        const bool in = q0 + tid < t_len;
        qseg_s[tid] = in ? segb[q0 + tid] : 0;
        lse_s[tid] = in ? lb[q0 + tid] : 0.f;
        di_s[tid] = in ? db[q0 + tid] : 0.f;
      }
      __syncthreads();

      // step A: P^T, then dS^T (reading back its own P), for keys KR ty + r
      // and queries tx + 16c; one KR x 4 patch of logits live at a time
      float x[KR][4];
      tile_dots<KR, 4, DH, LD, C::DKV_UNROLL>(k_s, q_s, x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = tx + 16 * c, qpos = q0 + i, qseg = qseg_s[i];
        const float li = lse_s[i];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          const int kp = k0 + ty * KR + r;
          const bool ok = qpos < t_len && kp < t_len && qseg == kseg_s[ty * KR + r] &&
                          (!causal || kp <= qpos);
          pt_s[(ty * KR + r) * LDPT + i] = ok ? expf(x[r][c] * sm_scale - li) : 0.f;
        }
      }
      tile_dots<KR, 4, DH, LD, C::DKV_UNROLL>(v_s, do_s, x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = tx + 16 * c;
        const float dii = di_s[i];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          const int at = (ty * KR + r) * LDPT + i;
          dst_s[at] = pt_s[at] * (x[r][c] - dii);
        }
      }
      __syncthreads();

      // step B: dV += P^T dO, dK += dS^T Q; queries ascending
#pragma unroll C::DKV_UNROLL
      for (int i = 0; i < BQ; i += 4) {
        float4 p4[KR], s4[KR];
#pragma unroll
        for (int r = 0; r < KR; ++r) {
          p4[r] = *reinterpret_cast<const float4*>(pt_s + (ty * KR + r) * LDPT + i);
          s4[r] = *reinterpret_cast<const float4*>(dst_s + (ty * KR + r) * LDPT + i);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float wo[NC], wq[NC];
          row_cols<DH>(do_s + (i + e) * LD, tx, wo);
          row_cols<DH>(q_s + (i + e) * LD, tx, wq);
#pragma unroll
          for (int r = 0; r < KR; ++r) {
            const float pe = lane(p4[r], e), se = lane(s4[r], e);
#pragma unroll
            for (int j = 0; j < NC; ++j) {
              dv_acc[r][j] = fmaf(pe, wo[j], dv_acc[r][j]);
              dk_acc[r][j] = fmaf(se, wq[j], dk_acc[r][j]);
            }
          }
        }
      }
      __syncthreads();  // the next tile overwrites Q, dO, P^T, dS^T, lse, di and segments
    }
  }

  // dk, dv are contiguous [B, T, Hkv, DH]
#pragma unroll
  for (int r = 0; r < KR; ++r) {
    const int kp = k0 + ty * KR + r;
    if (kp >= t_len) continue;
    const size_t row = ((static_cast<size_t>(b) * t_len + kp) * hkv + kvh) * DH;
    store_cols<T, DH>(dk + row, tx, dk_acc[r], sm_scale);
    store_cols<T, DH>(dv + row, tx, dv_acc[r], 1.f);
  }
}

// B5: dQ of one 64-row query tile of one head (module comment).
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, BwdCfg<DH>::MIN_BLOCKS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const int* __restrict__ seg,
                    const int2* __restrict__ tile_range, const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int t_len, int n_kt,
                    int hq, int group, Strides qs, Strides ks, Strides vs, Strides os,
                    int causal, float sm_scale) {
  using C = BwdCfg<DH>;
  constexpr int LD = C::LD, BK = C::BK, KR = C::KR, QPK = C::QPK, LDS = C::LDS, NC = C::NC;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [BQ][LD]
  float* do_s = q_s + BQ * LD;     // [BQ][LD]
  float* k_s = do_s + BQ * LD;     // [BK][LD]
  float* v_s = k_s + BK * LD;      // [BK][LD]
  float* ds_s = v_s + BK * LD;     // [BQ][LDS]: P, then dS
  float* lse_s = ds_s + BQ * LDS;  // [BQ]
  float* di_s = lse_s + BQ;        // [BQ]
  int* qseg_s = reinterpret_cast<int*>(di_s + BQ);                        // [BQ]
  int* kseg_s = qseg_s + BQ;                                              // [BK]
  unsigned char* live_s = reinterpret_cast<unsigned char*>(kseg_s + BK);  // [n_kt]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, q0 = qt * BQ;
  const int kvh = h / group;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* segb = seg + static_cast<size_t>(b) * t_len;
  const int2* rb = tile_range + static_cast<size_t>(b) * n_kt;
  // the query tile's segment range: the union of its range entries (block-uniform)
  const int q_last = min(n_kt - 1, qt * QPK + QPK - 1);
  int2 qr = rb[qt * QPK];
  for (int j = qt * QPK + 1; j <= q_last; ++j) {
    const int2 r = rb[j];
    qr = make_int2(min(qr.x, r.x), max(qr.y, r.y));
  }
  const int last = causal ? q_last + 1 : n_kt;  // kv tiles past it: above the diagonal
  for (int j = tid; j < last; j += THREADS) {
    const int2 r = rb[j];
    live_s[j] = !(r.y < qr.x || r.x > qr.y);
  }
  zero_pad<DH, LD>(q_s, 2 * BQ + 2 * BK);  // Q, dO, K and V lie back to back
  load_rows<T, DH, LD, BQ>(q + b * qs.b + h * qs.h, qs.t, q0, t_len, q_s);
  load_rows<T, DH, LD, BQ>(dout + b * os.b + h * os.h, os.t, q0, t_len, do_s);
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const float* lb = lse + (static_cast<size_t>(b) * hq + h) * t_len;
  const float* db = di + (static_cast<size_t>(b) * hq + h) * t_len;

  if (tid < BQ) {
    const bool in = q0 + tid < t_len;
    qseg_s[tid] = in ? segb[q0 + tid] : 0;
    lse_s[tid] = in ? lb[q0 + tid] : 0.f;
    di_s[tid] = in ? db[q0 + tid] : 0.f;
  }
  float dq_acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) dq_acc[r][j] = 0.f;
  __syncthreads();

  for (int jt = 0; jt < last; ++jt) {
    if (!live_s[jt]) continue;  // uniform over the block
    const int k0 = jt * BK;
    load_rows<T, DH, LD, BK>(kb, ks.t, k0, t_len, k_s);
    load_rows<T, DH, LD, BK>(vb, vs.t, k0, t_len, v_s);
    if (tid < BK) kseg_s[tid] = k0 + tid < t_len ? segb[k0 + tid] : 0;
    __syncthreads();

    // step A: P, then dS in its place, for queries 4ty + r and keys tx + 16c;
    // one 4 x KR patch of logits live at a time
    float x[4][KR];
    tile_dots<4, KR, DH, LD, C::DQ_UNROLL>(q_s, k_s, x);
#pragma unroll
    for (int c = 0; c < KR; ++c) {
      const int j = tx + 16 * c, kp = k0 + j, kseg = kseg_s[j];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r, qpos = q0 + i;
        const bool ok = qpos < t_len && kp < t_len && kseg == qseg_s[i] &&
                        (!causal || kp <= qpos);
        ds_s[i * LDS + j] = ok ? expf(x[r][c] * sm_scale - lse_s[i]) : 0.f;
      }
    }
    tile_dots<4, KR, DH, LD, C::DQ_UNROLL>(do_s, v_s, x);
#pragma unroll
    for (int c = 0; c < KR; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r, at = i * LDS + tx + 16 * c;
        ds_s[at] *= x[r][c] - di_s[i];
      }
    __syncthreads();

    // step B: dQ += dS K, keys ascending
#pragma unroll C::DQ_UNROLL
    for (int j = 0; j < BK; j += 4) {
      float4 d4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        d4[r] = *reinterpret_cast<const float4*>(ds_s + (ty * 4 + r) * LDS + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float w[NC];
        row_cols<DH>(k_s + (j + e) * LD, tx, w);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float de = lane(d4[r], e);
#pragma unroll
          for (int jj = 0; jj < NC; ++jj) dq_acc[r][jj] = fmaf(de, w[jj], dq_acc[r][jj]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites K, V, dS and the key segments
  }

  // dq is contiguous [B, T, Hq, DH]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qpos = q0 + ty * 4 + r;
    if (qpos >= t_len) continue;
    store_cols<T, DH>(dq + ((static_cast<size_t>(b) * t_len + qpos) * hq + h) * DH, tx,
                      dq_acc[r], sm_scale);
  }
}

// ---- the bf16 instances: tensor-core tiles (module comment) ----------------------

template <int DH>
struct MmaCfg {
  static constexpr int DHP = MmaTile<DH>::DHP;  // head dim padded to a k-step of 16 (72 -> 80)
  static constexpr int LDB = MmaTile<DH>::LDB;  // bf16 row stride of the Q, dO, K and V tiles
  static constexpr int BK = BwdCfg<DH>::BK;    // keys a kv tile (the range table's tile)
  static constexpr int QPK = BQ / BK;
  static constexpr int LDP = BQ + 8;           // bf16 row stride of B4's P^T and dS^T
  // B4: warp w owns keys 16 (w / WPG) .. +15; in step A queries QW (w % WPG) .. +QW-1,
  // in step B the NTB n8 tiles of the head dim from NTB (w % WPG)
  static constexpr int WPG = 8 / (BK / 16);   // warps a 16-key group: 2, or 4 at Dh 256
  static constexpr int QW = BQ / WPG;         // 32 or 16
  static constexpr int NTB = DHP / 8 / WPG;   // 4, 5 (72, 80), 8 (128, 256)
  // B5: warp w owns query rows 16 (w % 4) .. +15 and keys KW (w / 4) .. +KW-1 of each tile
  static constexpr int KW = BK / 2;           // 32, or 16 at Dh 256
  static constexpr int NTQ = DH / 8;          // n8 tiles of dQ: 8, 9, 10, 16, 32
  // keys a B5 warp takes in one pass: 16 at Dh 128, whose 64 dQ accumulators spilled
  // beside 32 keys' S and dP under the 128 registers of two blocks an SM
  static constexpr int CK = DH == 128 ? 16 : KW;
  // the least blocks an SM (shared memory below; B4 holds 8 NTB dK/dV accumulators a
  // thread, B5 DH / 2 of dQ)
  static constexpr int DKV_MIN_BLOCKS = DH <= 80 ? 2 : 1;
  static constexpr int DQ_MIN_BLOCKS = DH <= 128 ? 2 : 1;
  static constexpr size_t TILE = sizeof(bf16) * LDB;  // bytes of a tile row
  static constexpr size_t SMEM_DKV = TILE * (2 * BK + 4 * BQ) + sizeof(bf16) * 4 * BK * LDP +
                                     sizeof(float) * 4 * BQ + sizeof(int) * (2 * BQ + BK);
  static constexpr size_t SMEM_DQ =
      TILE * (2 * BQ + 4 * BK) + sizeof(float) * 2 * BQ + sizeof(int) * (BQ + 2 * BK);
  static_assert(sizeof(float) * 128 * 4 * NTQ <= TILE * 4 * BK,
                "B5's two dQ halves meet in its K and V buffers");
};

// B4 in bf16 on the tensor cores: dK and dV of one BK-key tile of one kv head,
// summed over one slice of its group's query heads (module comment). With part
// set, the unscaled f32 sums go to part (slice-major [splits, B, T, Hkv, DH],
// then dV's) for flash_bwd_dkv_reduce_kernel; else dk and dv are written.
template <int DH>
__global__ void __launch_bounds__(THREADS, MmaCfg<DH>::DKV_MIN_BLOCKS)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const int* __restrict__ seg, const int2* __restrict__ tile_range,
                         const float* __restrict__ lse, const float* __restrict__ di,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ part,
                         int t_len, int n_qt, int n_kt, int hq, int hkv, int group, int splits,
                         Strides qs, Strides ks, Strides vs, Strides os, int causal,
                         float sm_scale) {
  using C = MmaCfg<DH>;
  constexpr int LDB = C::LDB, BK = C::BK, LDP = C::LDP, QPK = C::QPK, WPG = C::WPG, QW = C::QW,
                NTB = C::NTB;
  extern __shared__ __align__(16) float smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [BK][LDB]
  bf16* v_s = k_s + BK * LDB;                 // [BK][LDB]
  bf16* q_s = v_s + BK * LDB;                 // [2][BQ][LDB]: two buffers
  bf16* do_s = q_s + 2 * BQ * LDB;            // [2][BQ][LDB]
  bf16* p_s = do_s + 2 * BQ * LDB;            // [4][BK][LDP]: P^T hi, lo; dS^T hi, lo
  float* lse_s = reinterpret_cast<float*>(p_s + 4 * BK * LDP);  // [2][BQ]
  float* di_s = lse_s + 2 * BQ;                                  // [2][BQ]
  int* qseg_s = reinterpret_cast<int*>(di_s + 2 * BQ);           // [2][BQ]
  int* kseg_s = qseg_s + 2 * BQ;                                 // [BK]
  unsigned char* live_s = reinterpret_cast<unsigned char*>(kseg_s + BK);  // [n_qt]

  const int kt = blockIdx.x, kvh = blockIdx.y / splits, slice = blockIdx.y % splits;
  const int b = blockIdx.z, k0 = kt * BK, per = group / splits;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* segb = seg + static_cast<size_t>(b) * t_len;
  const int2* rb = tile_range + static_cast<size_t>(b) * n_kt;
  // the live query tiles, as in flash_bwd_dkv_kernel
  const int first = causal ? k0 / BQ : 0;
  const int2 kr = rb[kt];
  for (int j = tid; j < n_qt; j += THREADS) {
    int2 r = rb[j * QPK];
#pragma unroll
    for (int e = 1; e < QPK; ++e) {
      if (j * QPK + e < n_kt) {
        const int2 s = rb[j * QPK + e];
        r = make_int2(min(r.x, s.x), max(r.y, s.y));
      }
    }
    live_s[j] = j >= first && !(r.y < kr.x || r.x > kr.y);
  }
  cp_rows<DH, BK>(k + b * ks.b + kvh * ks.h, ks.t, k0, t_len, k_s);
  cp_rows<DH, BK>(v + b * vs.b + kvh * vs.h, vs.t, k0, t_len, v_s);
  if (tid < BK) cp_async_4(kseg_s + tid, segb + (k0 + tid < t_len ? k0 + tid : 0), k0 + tid < t_len);
  cp_async_commit();
  __syncthreads();  // the live flags

  // the walk: (head hi of the slice, live query tile qt), heads then tiles ascending
  auto advance = [&](int& hi, int& qt) {
    for (;;) {
      if (++qt >= n_qt) {
        qt = first;
        if (++hi >= per) return;
      }
      if (live_s[qt]) return;
    }
  };
  // Q, dO, lse, di and the query segments of (hi, qt) into buffer `buf`
  auto issue = [&](int hi, int qt, int buf) {
    const int h = kvh * group + slice * per + hi, q0 = qt * BQ;
    cp_rows<DH, BQ>(q + b * qs.b + h * qs.h, qs.t, q0, t_len, q_s + buf * BQ * LDB);
    cp_rows<DH, BQ>(dout + b * os.b + h * os.h, os.t, q0, t_len, do_s + buf * BQ * LDB);
    const int i = tid & (BQ - 1), row = q0 + i < t_len ? q0 + i : 0;
    const size_t lrow = (static_cast<size_t>(b) * hq + h) * t_len + row;
    if (tid < BQ) cp_async_4(lse_s + buf * BQ + i, lse + lrow, q0 + i < t_len);
    else if (tid < 2 * BQ) cp_async_4(di_s + buf * BQ + i, di + lrow, q0 + i < t_len);
    else if (tid < 3 * BQ) cp_async_4(qseg_s + buf * BQ + i, segb + row, q0 + i < t_len);
  };

  const int kg = warp / WPG, wq = warp % WPG;
  const int g = lane >> 2, t = lane & 3, kr0 = 16 * kg + g;  // this thread's keys: kr0, kr0 + 8
  float dk_acc[NTB][4], dv_acc[NTB][4];
#pragma unroll
  for (int n = 0; n < NTB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  int hi = 0, qt = first - 1, buf = 0;
  advance(hi, qt);
  if (hi < per) issue(hi, qt, 0);
  cp_async_commit();
  while (hi < per) {
    int hn = hi, qn = qt;
    advance(hn, qn);
    if (hn < per) issue(hn, qn, buf ^ 1);  // the next tile's copies overlap this one
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = qt * BQ;
    const bf16* qb = q_s + buf * BQ * LDB;
    const bf16* ob = do_s + buf * BQ * LDB;
    const float* lb = lse_s + buf * BQ;
    const float* dib = di_s + buf * BQ;
    const int* qsb = qseg_s + buf * BQ;

    // step A: S^T = K Q^T and dP^T = V dO^T for keys 16 kg.. and queries QW wq..; P^T and
    // dS^T = P^T (dP^T - di) as bf16 pairs into shared memory
    {
      float s[QW / 8][4], dp[QW / 8][4];
      mma_dots<QW / 8, C::DHP, LDB>(s, k_s, 16 * kg, qb, QW * wq);
      mma_dots<QW / 8, C::DHP, LDB>(dp, v_s, 16 * kg, ob, QW * wq);
#pragma unroll
      for (int n = 0; n < QW / 8; ++n) {
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int key = kr0 + 8 * h2, kp = k0 + key, kseg = kseg_s[key];
          float pv[2], dsv[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int i = QW * wq + 8 * n + 2 * t + c, qpos = q0 + i;
            const bool ok = qpos < t_len && kp < t_len && qsb[i] == kseg && (!causal || kp <= qpos);
            pv[c] = ok ? expf(s[n][2 * h2 + c] * sm_scale - lb[i]) : 0.f;
            dsv[c] = pv[c] * (dp[n][2 * h2 + c] - dib[i]);
          }
          const int at = key * LDP + QW * wq + 8 * n + 2 * t;
          uint32_t hi_bits, lo_bits;
          split_bf16(pv[0], pv[1], hi_bits, lo_bits);
          *reinterpret_cast<uint32_t*>(p_s + at) = hi_bits;
          *reinterpret_cast<uint32_t*>(p_s + BK * LDP + at) = lo_bits;
          split_bf16(dsv[0], dsv[1], hi_bits, lo_bits);
          *reinterpret_cast<uint32_t*>(p_s + 2 * BK * LDP + at) = hi_bits;
          *reinterpret_cast<uint32_t*>(p_s + 3 * BK * LDP + at) = lo_bits;
        }
      }
    }
    __syncthreads();

    // step B: dV += P^T dO and dK += dS^T Q for keys 16 kg.. and the NTB n8 tiles of
    // the head dim from NTB wq; queries ascending, hi then lo
#pragma unroll
    for (int kq = 0; kq < BQ; kq += 16) {
      const bf16* arow = p_s + (16 * kg + (lane & 15)) * LDP + kq + (lane >> 4) * 8;
      uint32_t ahi[4], alo[4];
      ldsm_x4(ahi, arow);
      ldsm_x4(alo, arow + BK * LDP);
      mma_rows_split<NTB, LDB>(dv_acc, ahi, alo, ob, kq, 8 * NTB * wq);
      ldsm_x4(ahi, arow + 2 * BK * LDP);
      ldsm_x4(alo, arow + 3 * BK * LDP);
      mma_rows_split<NTB, LDB>(dk_acc, ahi, alo, qb, kq, 8 * NTB * wq);
    }
    __syncthreads();  // the next tile overwrites this buffer's neighbour and P^T, dS^T
    hi = hn;
    qt = qn;
    buf ^= 1;
  }
  cp_async_wait<0>();

  // dk, dv are contiguous [B, T, Hkv, DH]; the partial sums [splits][B, T, Hkv, DH]
  const size_t n_out = static_cast<size_t>(gridDim.z) * t_len * hkv * DH;
#pragma unroll
  for (int n = 0; n < NTB; ++n) {
    const int col = 8 * (NTB * wq + n) + 2 * t;
    if (col >= DH) continue;  // Dh 72: the zero columns 72..79
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int kp = k0 + kr0 + 8 * h2;
      if (kp >= t_len) continue;
      const size_t at = ((static_cast<size_t>(b) * t_len + kp) * hkv + kvh) * DH + col;
      const float k0v = dk_acc[n][2 * h2], k1v = dk_acc[n][2 * h2 + 1];
      const float v0v = dv_acc[n][2 * h2], v1v = dv_acc[n][2 * h2 + 1];
      if (part == nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(k0v * sm_scale, k1v * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) = __floats2bfloat162_rn(v0v, v1v);
      } else {
        float* pk = part + slice * n_out + at;
        *reinterpret_cast<float2*>(pk) = make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(pk + splits * n_out) = make_float2(v0v, v1v);
      }
    }
  }
}

// B4's second pass where the group is split: dk = sm_scale * (sum of the slices'
// dK, slices ascending), dv the same unscaled; n elements each, 4 a thread.
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_reduce_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                            bf16* __restrict__ dv, long long n, int splits, float sm_scale) {
  const long long i = (static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x) * 4;
  if (i >= n) return;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), c = a;
  for (int s = 0; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(part + s * n + i);
    const float4 y = *reinterpret_cast<const float4*>(part + (splits + s) * n + i);
    a = make_float4(a.x + x.x, a.y + x.y, a.z + x.z, a.w + x.w);
    c = make_float4(c.x + y.x, c.y + y.y, c.z + y.z, c.w + y.w);
  }
  Vec<bf16>::store4(dk + i, a.x * sm_scale, a.y * sm_scale, a.z * sm_scale, a.w * sm_scale);
  Vec<bf16>::store4(dv + i, c.x, c.y, c.z, c.w);
}

// B5 in bf16 on the tensor cores: dQ of one 64-row query tile of one head
// (module comment).
template <int DH>
__global__ void __launch_bounds__(THREADS, MmaCfg<DH>::DQ_MIN_BLOCKS)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const int* __restrict__ seg, const int2* __restrict__ tile_range,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        bf16* __restrict__ dq, int t_len, int n_kt, int hq, int group,
                        Strides qs, Strides ks, Strides vs, Strides os, int causal,
                        float sm_scale) {
  using C = MmaCfg<DH>;
  constexpr int LDB = C::LDB, BK = C::BK, QPK = C::QPK, KW = C::KW, NTQ = C::NTQ;
  extern __shared__ __align__(16) float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [BQ][LDB]
  bf16* do_s = q_s + BQ * LDB;                // [BQ][LDB]
  bf16* k_s = do_s + BQ * LDB;                // [2][BK][LDB]: two buffers
  bf16* v_s = k_s + 2 * BK * LDB;             // [2][BK][LDB]
  float* lse_s = reinterpret_cast<float*>(v_s + 2 * BK * LDB);  // [BQ]
  float* di_s = lse_s + BQ;                                      // [BQ]
  int* qseg_s = reinterpret_cast<int*>(di_s + BQ);               // [BQ]
  int* kseg_s = qseg_s + BQ;                                     // [2][BK]
  unsigned char* live_s = reinterpret_cast<unsigned char*>(kseg_s + 2 * BK);  // [n_kt]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, q0 = qt * BQ;
  const int kvh = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* segb = seg + static_cast<size_t>(b) * t_len;
  const int2* rb = tile_range + static_cast<size_t>(b) * n_kt;
  // the live kv tiles, as in flash_bwd_dq_kernel
  const int q_last = min(n_kt - 1, qt * QPK + QPK - 1);
  int2 qr = rb[qt * QPK];
  for (int j = qt * QPK + 1; j <= q_last; ++j) {
    const int2 r = rb[j];
    qr = make_int2(min(qr.x, r.x), max(qr.y, r.y));
  }
  const int last = causal ? q_last + 1 : n_kt;
  for (int j = tid; j < last; j += THREADS) {
    const int2 r = rb[j];
    live_s[j] = !(r.y < qr.x || r.x > qr.y);
  }
  cp_rows<DH, BQ>(q + b * qs.b + h * qs.h, qs.t, q0, t_len, q_s);
  cp_rows<DH, BQ>(dout + b * os.b + h * os.h, os.t, q0, t_len, do_s);
  {
    const int i = tid & (BQ - 1), row = q0 + i < t_len ? q0 + i : 0;
    const size_t lrow = (static_cast<size_t>(b) * hq + h) * t_len + row;
    if (tid < BQ) cp_async_4(lse_s + i, lse + lrow, q0 + i < t_len);
    else if (tid < 2 * BQ) cp_async_4(di_s + i, di + lrow, q0 + i < t_len);
    else if (tid < 3 * BQ) cp_async_4(qseg_s + i, segb + row, q0 + i < t_len);
  }
  cp_async_commit();
  __syncthreads();  // the live flags

  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  auto next_live = [&](int j) {
    while (++j < last && !live_s[j]) {
    }
    return j;
  };
  // K, V and the key segments of kv tile jt into buffer `buf`
  auto issue = [&](int jt, int buf) {
    const int k0 = jt * BK;
    cp_rows<DH, BK>(kb, ks.t, k0, t_len, k_s + buf * BK * LDB);
    cp_rows<DH, BK>(vb, vs.t, k0, t_len, v_s + buf * BK * LDB);
    if (tid < BK)
      cp_async_4(kseg_s + buf * BK + tid, segb + (k0 + tid < t_len ? k0 + tid : 0),
                 k0 + tid < t_len);
  };

  const int wr = warp & 3, kh = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  float dq_acc[NTQ][4];
#pragma unroll
  for (int n = 0; n < NTQ; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  int jt = next_live(-1), buf = 0;
  if (jt < last) issue(jt, 0);
  cp_async_commit();
  while (jt < last) {
    const int jn = next_live(jt);
    if (jn < last) issue(jn, buf ^ 1);  // the next tile's copies overlap this one
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int k0 = jt * BK;
    const bf16* kt_s = k_s + buf * BK * LDB;
    const bf16* vt_s = v_s + buf * BK * LDB;
    const int* ksb = kseg_s + buf * BK;

    // S = Q K^T and dP = dO V^T for rows 16 wr.. and keys KW kh.., CK at a time; then P
    // and dS = P (dP - di) in registers, which are dQ's A fragments: dQ += dS K, keys
    // ascending, hi then lo
#pragma unroll 1
    for (int c0 = KW * kh; c0 < KW * (kh + 1); c0 += C::CK) {
      float s[C::CK / 8][4], dp[C::CK / 8][4];
      mma_dots<C::CK / 8, C::DHP, LDB>(s, q_s, 16 * wr, kt_s, c0);
      mma_dots<C::CK / 8, C::DHP, LDB>(dp, do_s, 16 * wr, vt_s, c0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * wr + g + 8 * (e >> 1), qpos = q0 + i, qseg = qseg_s[i];
        const float li = lse_s[i], dii = di_s[i];
#pragma unroll
        for (int n = 0; n < C::CK / 8; ++n) {
          const int j = c0 + 8 * n + 2 * t + (e & 1), kp = k0 + j;
          const bool ok = qpos < t_len && kp < t_len && ksb[j] == qseg && (!causal || kp <= qpos);
          const float p = ok ? expf(s[n][e] * sm_scale - li) : 0.f;
          dp[n][e] = p * (dp[n][e] - dii);
        }
      }
#pragma unroll
      for (int kk = 0; kk < C::CK / 16; ++kk) {
        uint32_t ahi[4], alo[4];
        c_to_a_split(dp[2 * kk], dp[2 * kk + 1], ahi, alo);
        mma_rows_split<NTQ, LDB>(dq_acc, ahi, alo, kt_s, c0 + 16 * kk, 0);
      }
    }
    __syncthreads();  // the next tile overwrites this buffer's neighbour
    jt = jn;
    buf ^= 1;
  }
  cp_async_wait<0>();

  // the two key halves meet in the K and V buffers: warps 4..7 put their sums there,
  // warps 0..3 add them to theirs (half 0 + half 1) and write dq [B, T, Hq, DH]
  float* red = reinterpret_cast<float*>(k_s);
  if (kh == 1) {
#pragma unroll
    for (int n = 0; n < NTQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(4 * n + e) * 128 + tid - 128] = dq_acc[n][e];
  }
  __syncthreads();
  if (kh == 0) {
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int qpos = q0 + 16 * wr + g + 8 * h2;
      if (qpos >= t_len) continue;
      bf16* row = dq + ((static_cast<size_t>(b) * t_len + qpos) * hq + h) * DH;
#pragma unroll
      for (int n = 0; n < NTQ; ++n) {
        const float x = dq_acc[n][2 * h2] + red[(4 * n + 2 * h2) * 128 + tid];
        const float y = dq_acc[n][2 * h2 + 1] + red[(4 * n + 2 * h2 + 1) * 128 + tid];
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + 2 * t) =
            __floats2bfloat162_rn(x * sm_scale, y * sm_scale);
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const int* seg;
  int2* ranges;
  const float *lse, *di;
  int device, batch, t_len, hq, hkv;
  Strides qs, ks, vs, os;
  int causal;
  float sm_scale;
  cudaStream_t stream;
};

// f32 B5 when dq is set, else B4 (dk, dv), at one head dim: the range table over
// BK-row tiles first, then the kernel.
template <typename T, int DH>
cudaError_t launch_bwd(const BwdArgs& a, void* dq, void* dk, void* dv) {
  using C = BwdCfg<DH>;
  const int n_qt = (a.t_len + BQ - 1) / BQ, n_kt = (a.t_len + C::BK - 1) / C::BK;
  cudaError_t err =
      launch_seg_tile_range(a.seg, a.t_len, n_kt, C::BK, a.batch, a.ranges, a.stream);
  if (err != cudaSuccess) return err;
  const T *q = static_cast<const T*>(a.q), *k = static_cast<const T*>(a.k),
          *v = static_cast<const T*>(a.v), *dout = static_cast<const T*>(a.dout);
  const int2* ranges = a.ranges;
  if (dq != nullptr)
    return launch_kernel(flash_bwd_dq_kernel<T, DH>, C::smem_bytes(C::SMEM_DQ, n_kt),
                         dim3(n_qt, a.hq, a.batch), a.stream, q, k, v, dout, a.seg, ranges,
                         a.lse, a.di, static_cast<T*>(dq), a.t_len, n_kt, a.hq, a.hq / a.hkv,
                         a.qs, a.ks, a.vs, a.os, a.causal, a.sm_scale);
  return launch_kernel(flash_bwd_dkv_kernel<T, DH>, C::smem_bytes(C::SMEM_DKV, n_qt),
                       dim3(n_kt, a.hkv, a.batch), a.stream, q, k, v, dout, a.seg, ranges, a.lse,
                       a.di, static_cast<T*>(dk), static_cast<T*>(dv), a.t_len, n_qt, n_kt, a.hq,
                       a.hkv, a.hq / a.hkv, a.qs, a.ks, a.vs, a.os, a.causal, a.sm_scale);
}

constexpr int MAX_SPLITS = 8;  // slices of a head group in bf16 B4, at most

// The slices bf16 B4 splits each kv head's group into: the least divisor of the
// group (at most MAX_SPLITS) at which the grid has two waves of blocks on the
// card's SMs, else the largest such divisor; 1 where the group is 1.
template <int DH>
int dkv_splits(int device, int batch, int t_len, int hq, int hkv) {
  const int group = hq / hkv, bk = MmaCfg<DH>::BK;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms = 132;
  const long long blocks = static_cast<long long>((t_len + bk - 1) / bk) * hkv * batch;
  const long long want = 2LL * sms * MmaCfg<DH>::DKV_MIN_BLOCKS;
  int splits = 1;
  for (int c = 2; c <= group && c <= MAX_SPLITS && blocks * splits < want; ++c)
    if (group % c == 0) splits = c;
  return splits;
}

int dkv_splits_dh(int dh, int device, int batch, int t_len, int hq, int hkv) {
  switch (dh) {
    case 64:
      return dkv_splits<64>(device, batch, t_len, hq, hkv);
    case 72:
      return dkv_splits<72>(device, batch, t_len, hq, hkv);
    case 80:
      return dkv_splits<80>(device, batch, t_len, hq, hkv);
    case 128:
      return dkv_splits<128>(device, batch, t_len, hq, hkv);
    default:
      return dkv_splits<256>(device, batch, t_len, hq, hkv);
  }
}

// The range table's share of the scratch: batch * ceil(t_len / 32) int2, rounded
// up to 256 bytes; in bf16 B4 with a split group the f32 partial dK and dV follow,
// 2 * splits * batch * t_len * hkv * dh floats.
size_t ranges_bytes(int batch, int t_len) {
  return (sizeof(int2) * batch * ((t_len + 31) / 32) + 255) / 256 * 256;
}

size_t parts_bytes(int splits, int batch, int t_len, int hkv, int dh) {
  return splits == 1 ? 0
                     : sizeof(float) * 2 * splits * batch * static_cast<size_t>(t_len) * hkv * dh;
}

// bf16 B5 when dq is set, else B4 (with its reduction where the group is split).
template <int DH>
cudaError_t launch_bwd_mma(const BwdArgs& a, void* dq, void* dk, void* dv) {
  using C = MmaCfg<DH>;
  const int n_qt = (a.t_len + BQ - 1) / BQ, n_kt = (a.t_len + C::BK - 1) / C::BK;
  cudaError_t err =
      launch_seg_tile_range(a.seg, a.t_len, n_kt, C::BK, a.batch, a.ranges, a.stream);
  if (err != cudaSuccess) return err;
  const bf16 *q = static_cast<const bf16*>(a.q), *k = static_cast<const bf16*>(a.k),
             *v = static_cast<const bf16*>(a.v), *dout = static_cast<const bf16*>(a.dout);
  const int2* ranges = a.ranges;
  if (dq != nullptr)
    return launch_kernel(flash_bwd_dq_mma_kernel<DH>, BwdCfg<DH>::smem_bytes(C::SMEM_DQ, n_kt),
                         dim3(n_qt, a.hq, a.batch), a.stream, q, k, v, dout, a.seg, ranges,
                         a.lse, a.di, static_cast<bf16*>(dq), a.t_len, n_kt, a.hq,
                         a.hq / a.hkv, a.qs, a.ks, a.vs, a.os, a.causal, a.sm_scale);
  const int splits = dkv_splits<DH>(a.device, a.batch, a.t_len, a.hq, a.hkv);
  float* part = splits == 1 ? nullptr
                            : reinterpret_cast<float*>(reinterpret_cast<char*>(a.ranges) +
                                                       ranges_bytes(a.batch, a.t_len));
  err = launch_kernel(flash_bwd_dkv_mma_kernel<DH>, BwdCfg<DH>::smem_bytes(C::SMEM_DKV, n_qt),
                      dim3(n_kt, a.hkv * splits, a.batch), a.stream, q, k, v, dout, a.seg, ranges,
                      a.lse, a.di, static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, a.t_len,
                      n_qt, n_kt, a.hq, a.hkv, a.hq / a.hkv, splits, a.qs, a.ks, a.vs, a.os,
                      a.causal, a.sm_scale);
  if (err != cudaSuccess || splits == 1) return err;
  const long long n = static_cast<long long>(a.batch) * a.t_len * a.hkv * DH;
  return launch_kernel(flash_bwd_dkv_reduce_kernel, 0,
                       dim3(static_cast<unsigned>((n / 4 + THREADS - 1) / THREADS)), a.stream,
                       static_cast<const float*>(part), static_cast<bf16*>(dk),
                       static_cast<bf16*>(dv), n, splits, a.sm_scale);
}

// f32 on the CUDA cores, bf16 on the tensor cores, at one head dim.
template <int DH>
cudaError_t launch_bwd_at(int dtype, const BwdArgs& a, void* dq, void* dk, void* dv) {
  return dtype == 0 ? launch_bwd<float, DH>(a, dq, dk, dv) : launch_bwd_mma<DH>(a, dq, dk, dv);
}

cudaError_t launch_bwd_dh(int dh, int dtype, const BwdArgs& a, void* dq, void* dk, void* dv) {
  switch (dh) {
    case 64:
      return launch_bwd_at<64>(dtype, a, dq, dk, dv);
    case 72:
      return launch_bwd_at<72>(dtype, a, dq, dk, dv);
    case 80:
      return launch_bwd_at<80>(dtype, a, dq, dk, dv);
    case 128:
      return launch_bwd_at<128>(dtype, a, dq, dk, dv);
    case 256:
      return launch_bwd_at<256>(dtype, a, dq, dk, dv);
    default:
      return cudaErrorInvalidValue;
  }
}

// The checks and argument packing both entry points share, then the launch at
// the head dim and dtype; B5 when dq is set, else B4.
int bwd(int device, int dtype, const void* q, const void* k, const void* v, const void* dout,
        const void* seg, void* tile_range, const void* lse, const void* di, void* dq, void* dk,
        void* dv, int batch, int t_len, int hq, int hkv, int dh, const long long* strides,
        int causal, float sm_scale, void* stream) {
  if (batch == 0 || t_len == 0) return 0;
  if (!is_head_dim(dh) || hkv <= 0 || hq % hkv != 0 || t_len > MAX_BWD_T || hq > 65535 ||
      batch > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long* s = strides;
  const BwdArgs a{q, k, v, dout, static_cast<const int*>(seg), static_cast<int2*>(tile_range),
                  static_cast<const float*>(lse), static_cast<const float*>(di), device, batch,
                  t_len, hq, hkv, Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
                  Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]}, causal, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_bwd_dh(dh, dtype, a, dq, dk, dv));
}

}  // namespace vrt_fa

// device: the CUDA device of every pointer and of the stream. dtype: 0 f32,
// 1 bf16, the same for q, k, v, dout and the outputs. q, dout [batch, t_len,
// hq, dh] and k, v [batch, t_len, hkv, dh] with the given element strides
// (strides[0:12]: q, k, v, dout, each (batch, t, head); the head dim
// contiguous; rows 16-byte aligned); seg [batch, t_len] int32 contiguous;
// tile_range: scratch of batch * ceil(t_len / 32) int2; lse and di f32
// [batch, hq, t_len] contiguous. dk, dv [batch, t_len, hkv, dh] (B4) and dq
// [batch, t_len, hq, dh] (B5) contiguous, written in full. dh must be 64, 72,
// 80, 128 or 256, t_len at most MAX_BWD_T and hq a multiple of hkv. Return the
// cudaError_t of the launches. B4's tile_range must hold
// vrt_flash_attention_bwd_dkv_scratch bytes, 256-byte aligned.
extern "C" int vrt_flash_attention_bwd_dkv(int device, int dtype, const void* q, const void* k,
                                           const void* v, const void* dout, const void* seg,
                                           void* tile_range, const void* lse, const void* di,
                                           void* dk, void* dv, int batch, int t_len, int hq,
                                           int hkv, int dh, const long long* strides, int causal,
                                           float sm_scale, void* stream) {
  return vrt_fa::bwd(device, dtype, q, k, v, dout, seg, tile_range, lse, di, nullptr, dk, dv,
                     batch, t_len, hq, hkv, dh, strides, causal, sm_scale, stream);
}

// The scratch bytes vrt_flash_attention_bwd_dkv needs at these arguments: the
// range table, and in bf16 the f32 partial sums of a split head group.
extern "C" long long vrt_flash_attention_bwd_dkv_scratch(int device, int dtype, int batch,
                                                         int t_len, int hq, int hkv, int dh) {
  const size_t ranges = vrt_fa::ranges_bytes(batch, t_len);
  if (dtype != 1 || !vrt_fa::is_head_dim(dh) || hkv <= 0 || hq % hkv != 0 || batch <= 0 ||
      t_len <= 0)
    return static_cast<long long>(ranges);  // f32, or arguments the launch refuses
  const int splits = vrt_fa::dkv_splits_dh(dh, device, batch, t_len, hq, hkv);
  return static_cast<long long>(ranges + vrt_fa::parts_bytes(splits, batch, t_len, hkv, dh));
}

extern "C" int vrt_flash_attention_bwd_dq(int device, int dtype, const void* q, const void* k,
                                          const void* v, const void* dout, const void* seg,
                                          void* tile_range, const void* lse, const void* di,
                                          void* dq, int batch, int t_len, int hq, int hkv, int dh,
                                          const long long* strides, int causal, float sm_scale,
                                          void* stream) {
  return vrt_fa::bwd(device, dtype, q, k, v, dout, seg, tile_range, lse, di, dq, nullptr, nullptr,
                     batch, t_len, hq, hkv, dh, strides, causal, sm_scale, stream);
}
