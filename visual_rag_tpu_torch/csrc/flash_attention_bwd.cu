// B4 and B5: the backward of K10 (flash attention with segment ids, an
// optional causal mask and grouped kv heads), at head dim 64, f32 and bf16.
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
// What bounds them on the H100: arithmetic. B4 does 8 * Dh flops per allowed
// pair and head (S, dP, dV, dK), B5 6 * Dh (S, dP, dQ), as f32 FMAs on the
// CUDA cores (67 TFLOP/s), not the bf16 tensor cores; mma / wgmma tiles are
// later work, as for K10's forward.
//
// Design (FlashAttention-2's split, the library's too):
// - B4: one block per (64-key kv tile, kv head, batch row). K and V stay in
//   shared memory; the block walks the query tiles of every query head of its
//   kv head's group and keeps dK and dV of its 64 keys in registers, so the
//   group is summed with no atomics and two calls give the same bits.
// - B5: one block per (64-row query tile, head, batch row). Q and dO stay in
//   shared memory; the block walks the kv tiles and keeps dQ in registers.
// - Both keep K10's exact skips: a tile pair whose segment-id ranges do not
//   meet (seg_tile_range_kernel, 64-row tiles), or that lies wholly above the
//   diagonal under causal, holds no allowed pair and is not visited. At
//   ColSmol's 17-tile vision (T 17408, a segment per 1024-patch tile) 16 of
//   272 tiles are live per tile.
// - 256 threads as 16 x 16. Step A (S and dP of a 64 x 64 tile pair): thread
//   (ty, tx) owns rows 4ty..4ty+3 of the tile that stays (keys in B4, queries
//   in B5) and columns tx + 16c (c < 4) of the tile that walks. Tiles sit in
//   shared memory as f32 rows of LD = Dh + 4 floats: 16 consecutive threads
//   read 16-byte vectors from 16 rows 4 banks apart (no conflict), and the
//   owned rows are read by a whole half-warp at one address. P^T and dS^T (B4)
//   or dS (B5) go to shared memory. Step B (dV and dK, or dQ): thread owns the
//   same 4 rows and columns 64c + 4tx..+3 of the head dim. Every sum runs in
//   a fixed order (head dim ascending in step A, rows ascending in step B,
//   then group heads and tiles ascending), so a call's result does not depend
//   on scheduling.
// - Shared memory, Dh 64: B4 K, V, Q, dO [64][68] and P^T, dS^T [64][68], f32,
//   plus lse, di and segment ids: 105,472 bytes + a byte a query tile; B5 Q,
//   dO, K, V [64][68] and P / dS [64][68], plus the same row data: 88,064
//   bytes + a byte a kv tile. Both take two blocks an SM
//   (__launch_bounds__(256, 2): at most 128 registers). Step A computes P
//   first and dP after it, reading P back from shared memory, so that one
//   4 x 4 patch of logits is live at a time beside the accumulators: with S
//   and dP live together both kernels spilled at 128 registers.
#include <math_constants.h>

#include "flash_common.cuh"

namespace vrt_fa {

constexpr int BK = 64;      // keys a kv tile (= BQ: one tile-range table serves both)
constexpr int LDP = BK + 4;  // row stride of the P^T, dS^T and dS tiles

template <int DH>
struct BwdCfg {
  static_assert(DH % 64 == 0, "the head dim is whole 64-column chunks");
  static constexpr int LD = DH + 4;     // row stride of the Q, dO, K and V tiles
  static constexpr int FULL = DH / 64;  // 64-column chunks: 4 columns a thread each
  static constexpr int NC = 4 * FULL;   // head-dim columns a thread in step B
  // steps of the inner loops unrolled: under the 128-register cap B4's f32
  // instance spilled at 2 and not at 1; B5 spills at neither and runs
  // faster at 2
  static constexpr int DKV_UNROLL = 1, DQ_UNROLL = 2;
  static constexpr size_t TILE = sizeof(float) * BQ * LD;
  static constexpr size_t SMEM_DKV = 4 * TILE + 2 * sizeof(float) * BK * LDP +
                                     sizeof(float) * 2 * BQ + sizeof(int) * (BQ + BK);
  static constexpr size_t SMEM_DQ = 4 * TILE + sizeof(float) * BQ * LDP +
                                    sizeof(float) * 2 * BQ + sizeof(int) * (BQ + BK);
  static size_t smem_bytes(size_t base, int n_t) { return base + (n_t + 15) / 16 * 16; }
};

// Rows [row0, row0 + 64) of one head, DH values each, into dst[r * LD + d]
// as f32; rows at or past t_len are zeros.
template <typename T, int DH, int LD>
__device__ __forceinline__ void load_rows(const T* __restrict__ base, long long row_stride,
                                          int row0, int t_len, float* __restrict__ dst) {
  constexpr int N = Vec<T>::N, PER_ROW = DH / N, TOTAL = BQ * PER_ROW;
  static_assert(TOTAL % THREADS == 0, "whole rounds of 16-byte vectors");
#pragma unroll
  for (int it = 0; it < TOTAL / THREADS; ++it) {
    const int idx = threadIdx.x + it * THREADS;
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(float4 a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// Step A: x[r][c] = own row 4ty + r of a . walking row tx + 16c of b, head
// dim ascending, UNROLL steps of 4 at a time.
template <int DH, int LD, int UNROLL>
__device__ __forceinline__ void tile_dots(const float* __restrict__ a,
                                          const float* __restrict__ b, float (&x)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[r][c] = 0.f;
#pragma unroll UNROLL
  for (int d = 0; d < DH; d += 4) {
    float4 w[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) w[c] = *reinterpret_cast<const float4*>(b + (tx + 16 * c) * LD + d);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 o = *reinterpret_cast<const float4*>(a + (ty * 4 + r) * LD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) x[r][c] = dot4(o, w[c], x[r][c]);
    }
  }
}

// B4: dK and dV of one 64-key tile of one kv head (module comment).
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const int* __restrict__ seg,
                     const int2* __restrict__ tile_range, const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                     int t_len, int n_t, int hq, int hkv, int group, Strides qs, Strides ks,
                     Strides vs, Strides os, int causal, float sm_scale) {
  using C = BwdCfg<DH>;
  constexpr int LD = C::LD, FULL = C::FULL, NC = C::NC;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                // [BK][LD]
  float* v_s = k_s + BK * LD;       // [BK][LD]
  float* q_s = v_s + BK * LD;       // [BQ][LD]
  float* do_s = q_s + BQ * LD;      // [BQ][LD]
  float* pt_s = do_s + BQ * LD;     // [BK][LDP]: P^T
  float* dst_s = pt_s + BK * LDP;   // [BK][LDP]: dS^T
  float* lse_s = dst_s + BK * LDP;  // [BQ]
  float* di_s = lse_s + BQ;         // [BQ]
  int* qseg_s = reinterpret_cast<int*>(di_s + BQ);                        // [BQ]
  int* kseg_s = qseg_s + BQ;                                              // [BK]
  unsigned char* live_s = reinterpret_cast<unsigned char*>(kseg_s + BK);  // [n_t]

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z, k0 = kt * BK;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* segb = seg + static_cast<size_t>(b) * t_len;
  const int2* rb = tile_range + static_cast<size_t>(b) * n_t;
  // a flag a query tile: do the segment ranges meet? Under causal a query tile
  // before the kv tile (BQ == BK: tile index below kt) has no allowed pair
  const int first = causal ? kt : 0;
  const int2 kr = rb[kt];
  for (int j = tid; j < n_t; j += THREADS) {
    const int2 r = rb[j];
    live_s[j] = j >= first && !(r.y < kr.x || r.x > kr.y);
  }
  load_rows<T, DH, LD>(k + b * ks.b + kvh * ks.h, ks.t, k0, t_len, k_s);
  load_rows<T, DH, LD>(v + b * vs.b + kvh * vs.h, vs.t, k0, t_len, v_s);
  if (tid < BK) kseg_s[tid] = k0 + tid < t_len ? segb[k0 + tid] : 0;
  __syncthreads();

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* ob = dout + b * os.b + h * os.h;
    const float* lb = lse + (static_cast<size_t>(b) * hq + h) * t_len;
    const float* db = di + (static_cast<size_t>(b) * hq + h) * t_len;
    for (int qt = first; qt < n_t; ++qt) {
      if (!live_s[qt]) continue;  // uniform over the block
      const int q0 = qt * BQ;
      load_rows<T, DH, LD>(qb, qs.t, q0, t_len, q_s);
      load_rows<T, DH, LD>(ob, os.t, q0, t_len, do_s);
      if (tid < BQ) {
        const bool in = q0 + tid < t_len;
        qseg_s[tid] = in ? segb[q0 + tid] : 0;
        lse_s[tid] = in ? lb[q0 + tid] : 0.f;
        di_s[tid] = in ? db[q0 + tid] : 0.f;
      }
      __syncthreads();

      // step A: P^T, then dS^T (reading back its own P), for keys 4ty + r and
      // queries tx + 16c; one 4 x 4 patch of logits live at a time
      float x[4][4];
      tile_dots<DH, LD, C::DKV_UNROLL>(k_s, q_s, x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = tx + 16 * c, qpos = q0 + i, qseg = qseg_s[i];
        const float li = lse_s[i];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kp = k0 + ty * 4 + r;
          const bool ok = qpos < t_len && kp < t_len && qseg == kseg_s[ty * 4 + r] &&
                          (!causal || kp <= qpos);
          pt_s[(ty * 4 + r) * LDP + i] = ok ? expf(x[r][c] * sm_scale - li) : 0.f;
        }
      }
      tile_dots<DH, LD, C::DKV_UNROLL>(v_s, do_s, x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = tx + 16 * c;
        const float dii = di_s[i];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int at = (ty * 4 + r) * LDP + i;
          dst_s[at] = pt_s[at] * (x[r][c] - dii);
        }
      }
      __syncthreads();

      // step B: dV += P^T dO, dK += dS^T Q; queries ascending
#pragma unroll C::DKV_UNROLL
      for (int i = 0; i < BQ; i += 4) {
        float4 p4[4], s4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          p4[r] = *reinterpret_cast<const float4*>(pt_s + (ty * 4 + r) * LDP + i);
          s4[r] = *reinterpret_cast<const float4*>(dst_s + (ty * 4 + r) * LDP + i);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float wo[NC], wq[NC];
#pragma unroll
          for (int cc = 0; cc < FULL; ++cc) {
            const float4 a = *reinterpret_cast<const float4*>(do_s + (i + e) * LD + cc * 64 + tx * 4);
            const float4 x = *reinterpret_cast<const float4*>(q_s + (i + e) * LD + cc * 64 + tx * 4);
            wo[4 * cc] = a.x; wo[4 * cc + 1] = a.y; wo[4 * cc + 2] = a.z; wo[4 * cc + 3] = a.w;
            wq[4 * cc] = x.x; wq[4 * cc + 1] = x.y; wq[4 * cc + 2] = x.z; wq[4 * cc + 3] = x.w;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r) {
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
  for (int r = 0; r < 4; ++r) {
    const int kp = k0 + ty * 4 + r;
    if (kp >= t_len) continue;
    const size_t row = ((static_cast<size_t>(b) * t_len + kp) * hkv + kvh) * DH;
#pragma unroll
    for (int cc = 0; cc < FULL; ++cc) {
      const int col = cc * 64 + tx * 4;
      Vec<T>::store4(dk + row + col, dk_acc[r][4 * cc] * sm_scale,
                     dk_acc[r][4 * cc + 1] * sm_scale, dk_acc[r][4 * cc + 2] * sm_scale,
                     dk_acc[r][4 * cc + 3] * sm_scale);
      Vec<T>::store4(dv + row + col, dv_acc[r][4 * cc], dv_acc[r][4 * cc + 1],
                     dv_acc[r][4 * cc + 2], dv_acc[r][4 * cc + 3]);
    }
  }
}

// B5: dQ of one 64-row query tile of one head (module comment).
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const int* __restrict__ seg,
                    const int2* __restrict__ tile_range, const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int t_len, int n_t, int hq,
                    int group, Strides qs, Strides ks, Strides vs, Strides os, int causal,
                    float sm_scale) {
  using C = BwdCfg<DH>;
  constexpr int LD = C::LD, FULL = C::FULL, NC = C::NC;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;               // [BQ][LD]
  float* do_s = q_s + BQ * LD;     // [BQ][LD]
  float* k_s = do_s + BQ * LD;     // [BK][LD]
  float* v_s = k_s + BK * LD;      // [BK][LD]
  float* ds_s = v_s + BK * LD;     // [BQ][LDP]: P, then dS
  float* lse_s = ds_s + BQ * LDP;  // [BQ]
  float* di_s = lse_s + BQ;        // [BQ]
  int* qseg_s = reinterpret_cast<int*>(di_s + BQ);                        // [BQ]
  int* kseg_s = qseg_s + BQ;                                              // [BK]
  unsigned char* live_s = reinterpret_cast<unsigned char*>(kseg_s + BK);  // [n_t]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, q0 = qt * BQ;
  const int kvh = h / group;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* segb = seg + static_cast<size_t>(b) * t_len;
  const int2* rb = tile_range + static_cast<size_t>(b) * n_t;
  const int last = causal ? qt + 1 : n_t;  // kv tiles past it: above the diagonal
  const int2 qr = rb[qt];
  for (int j = tid; j < last; j += THREADS) {
    const int2 r = rb[j];
    live_s[j] = !(r.y < qr.x || r.x > qr.y);
  }
  load_rows<T, DH, LD>(q + b * qs.b + h * qs.h, qs.t, q0, t_len, q_s);
  load_rows<T, DH, LD>(dout + b * os.b + h * os.h, os.t, q0, t_len, do_s);
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
    load_rows<T, DH, LD>(kb, ks.t, k0, t_len, k_s);
    load_rows<T, DH, LD>(vb, vs.t, k0, t_len, v_s);
    if (tid < BK) kseg_s[tid] = k0 + tid < t_len ? segb[k0 + tid] : 0;
    __syncthreads();

    // step A: P, then dS in its place, for queries 4ty + r and keys tx + 16c;
    // one 4 x 4 patch of logits live at a time
    float x[4][4];
    tile_dots<DH, LD, C::DQ_UNROLL>(q_s, k_s, x);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx + 16 * c, kp = k0 + j, kseg = kseg_s[j];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r, qpos = q0 + i;
        const bool ok = qpos < t_len && kp < t_len && kseg == qseg_s[i] &&
                        (!causal || kp <= qpos);
        ds_s[i * LDP + j] = ok ? expf(x[r][c] * sm_scale - lse_s[i]) : 0.f;
      }
    }
    tile_dots<DH, LD, C::DQ_UNROLL>(do_s, v_s, x);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r, at = i * LDP + tx + 16 * c;
        ds_s[at] *= x[r][c] - di_s[i];
      }
    __syncthreads();

    // step B: dQ += dS K, keys ascending
#pragma unroll C::DQ_UNROLL
    for (int j = 0; j < BK; j += 4) {
      float4 d4[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        d4[r] = *reinterpret_cast<const float4*>(ds_s + (ty * 4 + r) * LDP + j);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float w[NC];
#pragma unroll
        for (int cc = 0; cc < FULL; ++cc) {
          const float4 x = *reinterpret_cast<const float4*>(k_s + (j + e) * LD + cc * 64 + tx * 4);
          w[4 * cc] = x.x; w[4 * cc + 1] = x.y; w[4 * cc + 2] = x.z; w[4 * cc + 3] = x.w;
        }
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
    T* dst = dq + ((static_cast<size_t>(b) * t_len + qpos) * hq + h) * DH;
#pragma unroll
    for (int cc = 0; cc < FULL; ++cc)
      Vec<T>::store4(dst + cc * 64 + tx * 4, dq_acc[r][4 * cc] * sm_scale,
                     dq_acc[r][4 * cc + 1] * sm_scale, dq_acc[r][4 * cc + 2] * sm_scale,
                     dq_acc[r][4 * cc + 3] * sm_scale);
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

template <typename T>
cudaError_t launch_dkv(const BwdArgs& a, void* dk, void* dv) {
  using C = BwdCfg<BWD_DH>;
  const int n_t = (a.t_len + BQ - 1) / BQ;
  cudaError_t err = launch_seg_tile_range(a.seg, a.t_len, n_t, BQ, a.batch, a.ranges, a.stream);
  if (err != cudaSuccess) return err;
  return launch_kernel(flash_bwd_dkv_kernel<T, BWD_DH>, C::smem_bytes(C::SMEM_DKV, n_t),
                       dim3(n_t, a.hkv, a.batch), a.stream, static_cast<const T*>(a.q),
                       static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                       static_cast<const T*>(a.dout), a.seg, static_cast<const int2*>(a.ranges),
                       a.lse, a.di, static_cast<T*>(dk), static_cast<T*>(dv), a.t_len, n_t, a.hq,
                       a.hkv, a.hq / a.hkv, a.qs, a.ks, a.vs, a.os, a.causal, a.sm_scale);
}

template <typename T>
cudaError_t launch_dq(const BwdArgs& a, void* dq) {
  using C = BwdCfg<BWD_DH>;
  const int n_t = (a.t_len + BQ - 1) / BQ;
  cudaError_t err = launch_seg_tile_range(a.seg, a.t_len, n_t, BQ, a.batch, a.ranges, a.stream);
  if (err != cudaSuccess) return err;
  return launch_kernel(flash_bwd_dq_kernel<T, BWD_DH>, C::smem_bytes(C::SMEM_DQ, n_t),
                       dim3(n_t, a.hq, a.batch), a.stream, static_cast<const T*>(a.q),
                       static_cast<const T*>(a.k), static_cast<const T*>(a.v),
                       static_cast<const T*>(a.dout), a.seg, static_cast<const int2*>(a.ranges),
                       a.lse, a.di, static_cast<T*>(dq), a.t_len, n_t, a.hq, a.hq / a.hkv, a.qs,
                       a.ks, a.vs, a.os, a.causal, a.sm_scale);
}

// The checks and argument packing both entry points share; 0 when the call
// may go ahead, else the error to return.
int bwd_args(int device, int dtype, const void* q, const void* k, const void* v,
             const void* dout, const void* seg, void* tile_range, const void* lse,
             const void* di, int batch, int t_len, int hq, int hkv, int dh,
             const long long* strides, int causal, float sm_scale, void* stream, BwdArgs* out) {
  if (dh != BWD_DH || hkv <= 0 || hq % hkv != 0 || (t_len + BQ - 1) / BQ > MAX_TILES ||
      hq > 65535 || batch > 65535 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long* s = strides;
  *out = BwdArgs{q, k, v, dout, static_cast<const int*>(seg), static_cast<int2*>(tile_range),
                 static_cast<const float*>(lse), static_cast<const float*>(di), batch, t_len, hq,
                 hkv, Strides{s[0], s[1], s[2]}, Strides{s[3], s[4], s[5]},
                 Strides{s[6], s[7], s[8]}, Strides{s[9], s[10], s[11]}, causal, sm_scale,
                 static_cast<cudaStream_t>(stream)};
  return 0;
}

}  // namespace vrt_fa

// device: the CUDA device of every pointer and of the stream. dtype: 0 f32,
// 1 bf16, the same for q, k, v, dout and the outputs. q, dout [batch, t_len,
// hq, dh] and k, v [batch, t_len, hkv, dh] with the given element strides
// (strides[0:12]: q, k, v, dout, each (batch, t, head); the head dim
// contiguous; rows 16-byte aligned); seg [batch, t_len] int32 contiguous;
// tile_range: scratch of batch * ceil(t_len / 64) int2; lse and di f32
// [batch, hq, t_len] contiguous. dk, dv [batch, t_len, hkv, dh] (B4) and dq
// [batch, t_len, hq, dh] (B5) contiguous, written in full. dh must be 64 and
// hq a multiple of hkv. Return the cudaError_t of the launches.
extern "C" int vrt_flash_attention_bwd_dkv(int device, int dtype, const void* q, const void* k,
                                           const void* v, const void* dout, const void* seg,
                                           void* tile_range, const void* lse, const void* di,
                                           void* dk, void* dv, int batch, int t_len, int hq,
                                           int hkv, int dh, const long long* strides, int causal,
                                           float sm_scale, void* stream) {
  using namespace vrt_fa;
  if (batch == 0 || t_len == 0) return 0;
  BwdArgs a;
  const int bad = bwd_args(device, dtype, q, k, v, dout, seg, tile_range, lse, di, batch, t_len,
                           hq, hkv, dh, strides, causal, sm_scale, stream, &a);
  if (bad) return bad;
  return static_cast<int>(dtype == 0 ? launch_dkv<float>(a, dk, dv)
                                     : launch_dkv<__nv_bfloat16>(a, dk, dv));
}

extern "C" int vrt_flash_attention_bwd_dq(int device, int dtype, const void* q, const void* k,
                                          const void* v, const void* dout, const void* seg,
                                          void* tile_range, const void* lse, const void* di,
                                          void* dq, int batch, int t_len, int hq, int hkv, int dh,
                                          const long long* strides, int causal, float sm_scale,
                                          void* stream) {
  using namespace vrt_fa;
  if (batch == 0 || t_len == 0) return 0;
  BwdArgs a;
  const int bad = bwd_args(device, dtype, q, k, v, dout, seg, tile_range, lse, di, batch, t_len,
                           hq, hkv, dh, strides, causal, sm_scale, stream, &a);
  if (bad) return bad;
  return static_cast<int>(dtype == 0 ? launch_dq<float>(a, dq)
                                     : launch_dq<__nv_bfloat16>(a, dq));
}
