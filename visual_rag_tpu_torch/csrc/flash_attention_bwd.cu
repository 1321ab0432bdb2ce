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
// allowed key (lse -inf) gives 0, never NaN. P and dS stay f32 (the library
// rounds them to the input dtype before its products); dQ, dK and dV are
// written in the input dtype.
//
// Head dims: 64 (both towers of ColSmol-500M), 72 (ColPali's SigLIP vision
// tower, 16 heads), 80 (ColQwen2.5's vision tower, 16 heads, window segments),
// 128 (ColQwen2.5's Qwen2.5 text model, 16 heads on 2 kv heads, causal) and
// 256 (ColPali's Gemma text model, 8 heads on one kv head). Each is an
// explicit instance of the templated kernels (is_head_dim, flash_common.cuh).
//
// What bounds them on the H100: arithmetic. B4 does 8 * Dh flops per allowed
// pair and head (S, dP, dV, dK), B5 6 * Dh (S, dP, dQ), as f32 FMAs on the
// CUDA cores (67 TFLOP/s), not the bf16 tensor cores; mma / wgmma tiles are
// later work, as for K10's forward.
//
// Design (FlashAttention-2's split, the library's too):
// - B4: one block per (BK-key kv tile, kv head, batch row). K and V stay in
//   shared memory; the block walks the 64-row query tiles of every query head
//   of its kv head's group and keeps dK and dV of its BK keys in registers,
//   so the group is summed with no atomics and two calls give the same bits.
// - B5: one block per (64-row query tile, head, batch row). Q and dO stay in
//   shared memory; the block walks the BK-key kv tiles and keeps dQ in
//   registers.
// - Both keep K10's exact skips: a tile pair whose segment-id ranges do not
//   meet (seg_tile_range_kernel over BK-row tiles; a query tile's range is
//   the union of the BQ / BK entries that cover its rows), or that lies
//   wholly above the diagonal under causal, holds no allowed pair and is not
//   visited. At ColSmol's 17-tile vision (T 17408, a segment per 1024-patch
//   tile) 16 of 272 tiles are live per tile.
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
//   column for every tx. Every sum runs in a fixed
//   order (head dim ascending in step A, rows ascending in step B, then group
//   heads and tiles ascending), so a call's result does not depend on
//   scheduling.
// - Step A computes P first and dP after it, reading P back from shared
//   memory, so that one patch of logits is live at a time beside the
//   accumulators (with S and dP live together the Dh 64 instances spilled at
//   128 registers).
//
// Shared memory (f32 tiles, then lse, di and segment ids; a byte a walked tile
// for the live flags follows, at most 16 KB at MAX_BWD_T):
//   Dh  64 (BK 64, LD 68): B4 K, V, Q, dO [64][68] and P^T, dS^T [64][68]:
//     105,472 bytes; B5 Q, dO, K, V [64][68] and dS [64][68]: 88,064 bytes.
//     Two blocks an SM (__launch_bounds__(256, 2): at most 128 registers;
//     B4's loops are not unrolled, DKV_UNROLL, or its f32 instance spills).
//   Dh  72 and 80 (DHP 80, BK 64, LD 84): B4 121,856 bytes, one block an SM;
//     B5 104,448 bytes. Both ask for one block an SM (at most 255
//     registers): the fifth column adds 8 (B4) or 4 (B5) accumulators a
//     thread to the Dh 64 instances' 126-128 registers. Dh 80 is Dh 72's
//     body with no padded column: the fifth column is stored by every thread.
//   Dh 128 (BK 64, LD 132, 8 columns a thread in step B): B4 K, V, Q, dO
//     [64][132] and P^T, dS^T [64][68]: 171,008 bytes, each thread 4 keys x 8
//     columns of dK and of dV (64 accumulators, as at Dh 256); B5 153,600
//     bytes. One block an SM each. At ColQwen2.5's page text (B 4, T ~1024,
//     2 kv heads) B4's grid is 16 x 2 x 4 = 128 blocks on 132 SMs, each
//     walking its group's 8 query heads.
//   Dh 256 (BK 32, LD 260): at the 64-key tiles of Dh 64 B4's four row tiles
//     alone would take 266,240 bytes of the 232,448 a block may have, and its
//     dK and dV 128 f32 registers a thread. So the kv tile is 32 keys, as in
//     K10's forward at Dh 256: B4 K, V [32][260], Q, dO [64][260] and P^T,
//     dS^T [32][68]: 217,984 bytes, each thread 2 keys x 16 columns of dK and
//     of dV (64 accumulators); B5 Q, dO [64][260], K, V [32][260] and dS
//     [64][36]: 209,792 bytes. One block an SM each. At ColPali's page text
//     (B 4, T 1088, one kv head) B4's grid is 34 x 1 x 4 = 136 blocks on 132
//     SMs.
#include <math_constants.h>

#include "flash_common.cuh"

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

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const int* seg;
  int2* ranges;
  const float *lse, *di;
  int batch, t_len, hq, hkv;
  Strides qs, ks, vs, os;
  int causal;
  float sm_scale;
  cudaStream_t stream;
};

// B5 when dq is set, else B4 (dk, dv), at one head dim: the range table over
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

template <typename T>
cudaError_t launch_bwd_dh(int dh, const BwdArgs& a, void* dq, void* dk, void* dv) {
  switch (dh) {
    case 64:
      return launch_bwd<T, 64>(a, dq, dk, dv);
    case 72:
      return launch_bwd<T, 72>(a, dq, dk, dv);
    case 80:
      return launch_bwd<T, 80>(a, dq, dk, dv);
    case 128:
      return launch_bwd<T, 128>(a, dq, dk, dv);
    case 256:
      return launch_bwd<T, 256>(a, dq, dk, dv);
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
                  static_cast<const float*>(lse), static_cast<const float*>(di), batch, t_len,
                  hq, hkv, Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
                  Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]}, causal, sm_scale,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dtype == 0 ? launch_bwd_dh<float>(dh, a, dq, dk, dv)
                                     : launch_bwd_dh<__nv_bfloat16>(dh, a, dq, dk, dv));
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
// cudaError_t of the launches.
extern "C" int vrt_flash_attention_bwd_dkv(int device, int dtype, const void* q, const void* k,
                                           const void* v, const void* dout, const void* seg,
                                           void* tile_range, const void* lse, const void* di,
                                           void* dk, void* dv, int batch, int t_len, int hq,
                                           int hkv, int dh, const long long* strides, int causal,
                                           float sm_scale, void* stream) {
  return vrt_fa::bwd(device, dtype, q, k, v, dout, seg, tile_range, lse, di, nullptr, dk, dv,
                     batch, t_len, hq, hkv, dh, strides, causal, sm_scale, stream);
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
