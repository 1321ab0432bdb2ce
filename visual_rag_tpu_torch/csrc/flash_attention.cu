// K10: flash-attention forward with segment ids, an optional causal mask and
// grouped kv heads, at head dims 64, 72, 80, 128 and 256.
//
// Replaces the TPU kernel that visual_rag_tpu/models/attention.py::mha calls
// (:61-73): the library's jax/experimental/pallas/ops/tpu/flash_attention.py,
// forward _flash_attention_impl (pallas_call :758). Its function (the
// library's mha_reference, :1530): for each (b, h, i),
//
//   o[b, i, h, :] = sum_j softmax_j(sm_scale * q[b, i, h] . k[b, j, h / group])
//                   * v[b, j, h / group]
//
// over the keys j allowed for row i: seg[b, j] == seg[b, i] and, if causal,
// j <= i. Every row allows itself, so a row's sum is never empty; a row with
// no allowed key would write zeros. Logits, maxima and sums are f32; the
// output is in the input dtype (f32 or bf16). For training, a second
// __global__ over the same body also writes each row's logsumexp lse = m +
// log(l) in f32, the residual that the backward kernels B4 and B5
// (flash_attention_bwd.cu) read; the serving kernel does not store it. So the
// serving output equals the training forward's bit for bit.
//
// Head dims: 64 (both towers of ColSmol-500M), 72 (ColPali's SigLIP vision
// tower, 1152 / 16), 80 (ColQwen2.5's vision tower, 1280 / 16, window
// segments), 128 (ColQwen2.5's Qwen2.5 text model, 2048 / 16 on 2 kv heads,
// causal) and 256 (ColPali's Gemma text model, 2048 / 8, one kv head). Each
// is an explicit instance of the templated kernels.
//
// What bounds it on the H100: arithmetic. A page's attention does 4 * Dh
// flops per allowed pair and head over ~1e6-1e7 pairs a head, against
// ~1e7-1e8 bytes of q, k, v and o. The f32 instances (flash_fwd_kernel,
// flash_fwd_lse_kernel) do their products as f32 FMAs on the CUDA cores, against
// the 67 TFLOP/s f32 rate (TF32 would change their results). The bf16 instances
// (flash_fwd_mma_kernel, flash_fwd_lse_mma_kernel) run them on the tensor cores
// with mma.sync, against the 989 TFLOP/s of bf16, of which mma.sync reaches a
// part; wgmma, TMA and warp specialisation are later work.
//
// Design, both dtypes: one block per (64-row query tile, head, batch row) walks
// the kv tiles (BK keys each) with an online softmax (running max m, sum l and
// output accumulator in registers), as the TPU kernel walks its kv blocks. A
// kv tile is skipped, exactly, when it lies wholly above the diagonal under
// causal (the TPU kernel's below_or_on_diag, :325) or when its segment-id
// range does not meet the query tile's (then no pair in it is allowed). The
// ranges of every BK-key tile come from seg_tile_range_kernel, launched
// first; a query tile's range is the union of the ranges of the kv tiles
// that cover its rows. Both skips drop only tiles whose every logit is
// masked, which add exactly 0 once a row has seen one allowed key (as
// DEFAULT_MASK_VALUE does in the TPU kernel). The walk over the kv tiles reads
// one byte a tile from shared memory (the block sets those flags together from
// the ranges first): at T 17408 a query tile skips 256 of 272 tiles, and a
// serial walk over the ranges in device memory cost 11% of the call at Dh 64
// (measured against this walk).
//
// The f32 instances: 256 threads as 16 x 16. Thread (ty, tx) owns rows
// 4ty..4ty+3 of the query tile; of the 64 x BK logit tile it owns columns
// tx*SC..tx*SC+SC-1 (SC = BK / 16), and of the 64 x Dh output tile the columns
// c*64 + 4tx..+3 for each full 64-column chunk c, plus column 64*(Dh/64) + tx
// where Dh is not a multiple of 64 (Dh 72: 4 + 1 columns a thread, the fifth
// stored only for tx < 8; Dh 80: 4 + 1, the fifth stored by every thread; Dh
// 128: 8). Q, K^T, V and P sit in shared memory as f32, the head dim
// zero-padded to DHP (a multiple of 16): the padded columns of Q and rows of
// K^T are zeros, so they add exactly 0 to each logit, and the padded output
// columns are never stored. Each dot product is one fmaf chain in a fixed
// order (head dim ascending for a logit, keys ascending for an output), so a
// call's result does not depend on scheduling. Shared memory, f32 (Q
// [64][DHP], K^T [DHP][BK], V [BK][DHP], P [64][BK]), plus a byte a kv tile
// (at most 32 KB, at T 1,048,576 and BK 32):
//   Dh  64: DHP  64, BK 64:  64 KB (three blocks an SM);
//   Dh  72: DHP  80, BK 64:  76 KB (two blocks an SM);
//   Dh  80: DHP  80, BK 64:  76 KB (two blocks an SM; no padded column);
//   Dh 128: DHP 128, BK 64: 113 KB (one block an SM: two would need 230 KB
//     of the SM's 228);
//   Dh 256: DHP 256, BK 32: 136 KB (one block an SM). At BK 64 it would be
//     208 KB, within 4% of the 227 KB a block may have, so the kv tile is
//     halved instead: the logit tile, its softmax and P shrink with it, and
//     the 64 x 256 output accumulator (64 f32 registers a thread) is not
//     touched.
//
// The bf16 instances are FlashAttention-2's forward on the tensor cores, over
// the tile products of flash_mma.cuh (shared with B4 and B5):
// - 128 threads, 4 warps: warp w owns query rows 16w..16w+15 of the tile (the
//   m16 of mma.sync) and every key of each kv tile, so a row's max, sum and
//   output never leave its warp and every sum runs in one fixed order. (B5's 8
//   warps, two of them on a row's two key halves, would need the halves' m, l and
//   O merged in shared memory at the end; 4 warps of 128 threads let more blocks
//   share an SM instead.)
// - Q, K and V sit in shared memory in bf16, rows of LDB = DHP + 8 (8 rows of an
//   ldmatrix on distinct banks). K, V and the key segments of the next live kv
//   tile are copied by cp.async into the other stage of a two-stage ring while
//   the warps compute the current one; dead tiles are never copied; one barrier
//   a tile. The copies zero-fill rows past t_len and Dh 72's pad columns
//   72..79, which then add exactly 0.
// - S = Q K^T by mma.sync m16n8k16 (K's rows as the B operand by ldmatrix):
//   exact products of bf16 summed in f32. Q's A fragments stay in registers over
//   the walk at Dh 72-128 (DHP / 4 a thread). At Dh 256 the warp's 16 x 256 f32
//   output accumulator alone takes 128 registers a thread, and at Dh 64 four
//   blocks an SM leave 128 registers; there Q's fragments are read from shared
//   memory at each tile.
// - Mask and online softmax on the accumulator fragments: a lane holds rows g
//   and g + 8 of its warp's 16, a row lives in a quad of lanes (its max over
//   the quad by two shuffles; each lane keeps its share of the row's sum, which
//   the quad adds up once, at the end). The rules are the f32 instances'; a kv
//   tile whose every pair is allowed (its keys and the query tile in one
//   segment, before t_len, and under causal before the tile's first row) is
//   flagged 2 beside the live flags and skips the per-pair mask. The softmax
//   runs in log2 units, P = 2^(sm_scale * log2(e) * q . k - m) with m the row's
//   largest such value, on the MUFU's ex2.approx (relative error about 2^-22,
//   within the 2^-18 of P's hi + lo), and lse = m * ln(2) + log(l).
// - O += P V with P in registers: the C fragments of S's n8 tiles 2j and 2j+1
//   are the A fragment of k-step j (c_to_a_split), and V is the B operand by
//   ldmatrix.trans. Each P goes in as the bf16 pair hi + lo, |P - hi - lo| <=
//   2^-18 P: one bf16 rounding (the TPU kernel's, flash_attention.py:471)
//   misses K10_TOL's 1e-5 floor on outputs near 0, as it missed BWD_TOL's in B4
//   and B5. The products then take 6 * Dh flops per pair and head where the
//   function has 4 * Dh.
// - Epilogue: O / l in f32, rounded to bf16 and stored from the fragments (4
//   bytes a lane, a row's 16 bytes by a quad); lse = m + log(l) once a row.
// - Shared memory (Q, two stages of K and V, segment ids, then a byte a kv tile)
//   and the blocks an SM that __launch_bounds__ asks registers for (MIN_BLOCKS):
//   Dh 64 46,848 bytes, four (at most 128 registers); Dh 72 and 80 57,088, three
//   (168); Dh 128 87,808, two (255); Dh 256 on 32-key tiles 101,888, two. At Dh
//   256 a 64-key ring fits too (169,728 bytes), but leaves one block of four
//   warps an SM; 32-key tiles give two.
#include <math_constants.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace vrt_fa {

template <int DH>
struct Cfg {
  static constexpr int DHP = (DH + 15) / 16 * 16;  // padded head dim
  static constexpr int BK = DH > 128 ? 32 : 64;    // keys a kv tile
  static constexpr int SC = BK / 16;               // logit columns a thread
  static constexpr int FULL = DH / 64;             // full 64-column output chunks (float4 a thread)
  static constexpr int REST = DHP / 16 - 4 * FULL; // further output columns a thread, 16 apart
  static constexpr int NC = 4 * FULL + REST;       // output columns a thread
  static_assert(DH % 8 == 0, "a bf16 row is whole 16-byte vectors");
  static_assert(REST <= 1, "one column a thread past the full chunks");
  static constexpr int PV_UNROLL = NC > 8 ? 2 : 4;  // kk steps unrolled in O += P V
  // the least blocks an SM that __launch_bounds__ asks registers for (0: no
  // minimum). Dh 128 alone asks for one: its shared memory allows one block an
  // SM anyway, and without it ptxas held bf16 to 128 registers and spilled.
  // Asked of Dh 256, it moved bf16 from 205 to 167 registers and cost 4%
  static constexpr int MIN_BLOCKS = DH == 128 ? 1 : 0;
  // f32 tiles and segment ids; the live-tile flags (a byte a kv tile) follow
  static constexpr size_t SMEM =
      sizeof(float) * (BQ * DHP + DHP * BK + BK * DHP + BQ * BK) + sizeof(int) * (BQ + BK);
  static size_t smem_bytes(int n_kt) { return SMEM + (n_kt + 15) / 16 * 16; }
};

// SC consecutive floats of shared memory (SC 2 or 4, 8- or 16-byte aligned)
template <int SC>
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  if constexpr (SC == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  } else {
    static_assert(SC == 2, "two or four logit columns a thread");
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  }
}

template <int SC>
__device__ __forceinline__ void store_cols(float* p, const float* x) {
  if constexpr (SC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// [min, max] of the segment ids of each tile of `tile` rows: one thread a (b, tile).
__global__ void seg_tile_range_kernel(const int* __restrict__ seg, int t_len, int n_tiles,
                                      int tile, int batch, int2* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * n_tiles) return;
  const int b = i / n_tiles, j = i - b * n_tiles;
  const int* s = seg + static_cast<size_t>(b) * t_len + j * tile;
  const int n = min(tile, t_len - j * tile);
  int lo = s[0], hi = s[0];
  for (int e = 1; e < n; ++e) {
    lo = min(lo, s[e]);
    hi = max(hi, s[e]);
  }
  out[i] = make_int2(lo, hi);
}

cudaError_t launch_seg_tile_range(const int* seg, int t_len, int n_tiles, int tile, int batch,
                                  int2* out, cudaStream_t stream) {
  const int cells = batch * n_tiles;
  seg_tile_range_kernel<<<(cells + 127) / 128, 128, 0, stream>>>(seg, t_len, n_tiles, tile, batch,
                                                                 out);
  return cudaGetLastError();
}

// Rows [row0, row0 + ROWS) of one head, DH values each, into dst as f32:
// row-major dst[r * DHP + d] (TRANSPOSE false) or dst[d * ROWS + r] (true).
// Rows at or past t_len are zeros; the padded columns DH..DHP are not
// written (zero_pad sets them once).
template <typename T, bool TRANSPOSE, int ROWS, int DH, int DHP>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, Strides st, int row0,
                                          int t_len, float* __restrict__ dst) {
  constexpr int N = Vec<T>::N, PER_ROW = DH / N, TOTAL = ROWS * PER_ROW;
#pragma unroll
  for (int it = 0; it < (TOTAL + THREADS - 1) / THREADS; ++it) {
    const int v = threadIdx.x + it * THREADS;
    if (TOTAL % THREADS != 0 && v >= TOTAL) break;
    // TRANSPOSE: a warp takes 32 consecutive rows of one column group, so its
    // scalar stores into a column of dst hit 32 banks
    const int r = TRANSPOSE ? v % ROWS : v / PER_ROW;
    const int g = TRANSPOSE ? v / ROWS : v % PER_ROW;
    float x[N];
    if (row0 + r < t_len) {
      Vec<T>::load(base + (row0 + r) * st.t + g * N, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
    if (TRANSPOSE) {
#pragma unroll
      for (int e = 0; e < N; ++e) dst[(g * N + e) * ROWS + r] = x[e];
    } else {
#pragma unroll
      for (int e = 0; e < N; e += 4)
        *reinterpret_cast<float4*>(dst + r * DHP + g * N + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
}

// Zeros in the padded head-dim columns DH..DHP of Q [BQ][DHP], K^T [DHP][BK]
// and V [BK][DHP]; the tile loads never write them.
template <int DH, int DHP, int BK>
__device__ __forceinline__ void zero_pad(float* q_s, float* kt_s, float* v_s) {
  constexpr int W = DHP - DH;
  if constexpr (W > 0) {
    for (int i = threadIdx.x; i < BQ * W; i += THREADS) q_s[(i / W) * DHP + DH + i % W] = 0.f;
    for (int i = threadIdx.x; i < W * BK; i += THREADS) kt_s[DH * BK + i] = 0.f;
    for (int i = threadIdx.x; i < BK * W; i += THREADS) v_s[(i / W) * DHP + DH + i % W] = 0.f;
  }
}

// The block's work, shared by the serving kernel and the one that also writes
// each row's logsumexp for the backward (SAVE_LSE): the flag adds only the
// lse store at the end, so the serving kernel compiles as it did without it.
template <typename T, int DH, bool SAVE_LSE>
__device__ __forceinline__ void flash_fwd_body(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ seg, const int2* __restrict__ tile_range, T* __restrict__ o,
    float* __restrict__ lse, int t_len, int n_kt, int hq, int group, Strides qs_, Strides ks_,
    Strides vs_, int causal, float sm_scale) {
  using C = Cfg<DH>;
  constexpr int DHP = C::DHP, BK = C::BK, SC = C::SC, FULL = C::FULL, NC = C::NC;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;             // [BQ][DHP]
  float* kt_s = q_s + BQ * DHP;  // [DHP][BK]: K transposed
  float* v_s = kt_s + DHP * BK;  // [BK][DHP]
  float* p_s = v_s + BK * DHP;   // [BQ][BK]
  int* qseg_s = reinterpret_cast<int*>(p_s + BQ * BK);  // [BQ]
  int* kseg_s = qseg_s + BQ;                             // [BK]
  unsigned char* live_s = reinterpret_cast<unsigned char*>(kseg_s + BK);  // [n_kt]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group, q0 = qt * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + kvh * ks_.h;
  const T* vb = v + b * vs_.b + kvh * vs_.h;
  const int* segb = seg + static_cast<size_t>(b) * t_len;
  const int2* rb = tile_range + static_cast<size_t>(b) * n_kt;

  // the query tile's segment range: the union of its kv tiles' (block-uniform)
  const int q_last = min(n_kt - 1, (q0 + BQ - 1) / BK);
  int2 qr = rb[q0 / BK];
  for (int j = q0 / BK + 1; j <= q_last; ++j) {
    const int2 r = rb[j];
    qr = make_int2(min(qr.x, r.x), max(qr.y, r.y));
  }
  // a flag a kv tile: does its segment range meet the query tile's? Set by
  // the whole block at once, so that the walk below reads shared memory
  const int last = causal ? q_last + 1 : n_kt;  // tiles past it: above the diagonal
  for (int j = tid; j < last; j += THREADS) {
    const int2 r = rb[j];
    live_s[j] = !(r.y < qr.x || r.x > qr.y);
  }
  zero_pad<DH, DHP, BK>(q_s, kt_s, v_s);
  if (tid < BQ) qseg_s[tid] = q0 + tid < t_len ? segb[q0 + tid] : 0;
  load_tile<T, false, BQ, DH, DHP>(qb, qs_, q0, t_len, q_s);
  __syncthreads();

  int my_seg[4], my_pos[4];
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    my_seg[i] = qseg_s[ty * 4 + i];
    my_pos[i] = q0 + ty * 4 + i;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }

  for (int jt = 0; jt < last; ++jt) {
    if (!live_s[jt]) continue;  // no segment id in common (uniform over the block)
    const int k0 = jt * BK;
    load_tile<T, true, BK, DH, DHP>(kb, ks_, k0, t_len, kt_s);
    load_tile<T, false, BK, DH, DHP>(vb, vs_, k0, t_len, v_s);
    if (tid < BK) kseg_s[tid] = k0 + tid < t_len ? segb[k0 + tid] : 0;
    __syncthreads();

    // S = Q K^T for this thread's 4 x SC patch, head dim ascending
    float s[4][SC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DHP; d += 4) {
      float4 a[4];
      float c[4][SC];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * DHP + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) load_cols<SC>(kt_s + (d + e) * BK + tx * SC, c[e]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[i][j] = fmaf(a[i].x, c[0][j], s[i][j]);
          s[i][j] = fmaf(a[i].y, c[1][j], s[i][j]);
          s[i][j] = fmaf(a[i].z, c[2][j], s[i][j]);
          s[i][j] = fmaf(a[i].w, c[3][j], s[i][j]);
        }
    }

    // mask, online softmax; the 16 threads of a row are lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = tx * SC + j, kp = k0 + c;
        const bool ok = kp < t_len && kseg_s[c] == my_seg[i] && (!causal || kp <= my_pos[i]);
        s[i][j] = ok ? s[i][j] * sm_scale : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;  // no allowed key yet
      const float alpha = expf(m[i] - m_use);                     // 0 while m[i] is -inf
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[i][j] = expf(s[i][j] - m_use);  // masked: exp(-inf) = 0
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
      store_cols<SC>(p_s + (ty * 4 + i) * BK + tx * SC, s[i]);
    }
    __syncthreads();

    // O += P V, keys ascending
#pragma unroll C::PV_UNROLL
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * BK + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = v_s + (kk + e) * DHP;
        float w[NC];
#pragma unroll
        for (int c = 0; c < FULL; ++c) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + c * 64 + tx * 4);
          w[4 * c] = x.x; w[4 * c + 1] = x.y; w[4 * c + 2] = x.z; w[4 * c + 3] = x.w;
        }
#pragma unroll
        for (int j = 4 * FULL; j < NC; ++j) w[j] = vrow[64 * FULL + (j - 4 * FULL) * 16 + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pe = e == 0 ? p[i].x : e == 1 ? p[i].y : e == 2 ? p[i].z : p[i].w;
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pe, w[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites K^T, V, P and the key segments
  }

  // o is contiguous [B, T, Hq, DH]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (my_pos[i] >= t_len) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* dst = o + ((static_cast<size_t>(b) * t_len + my_pos[i]) * hq + h) * DH;
#pragma unroll
    for (int c = 0; c < FULL; ++c)
      Vec<T>::store4(dst + c * 64 + tx * 4, acc[i][4 * c] * inv, acc[i][4 * c + 1] * inv,
                     acc[i][4 * c + 2] * inv, acc[i][4 * c + 3] * inv);
#pragma unroll
    for (int j = 4 * FULL; j < NC; ++j) {
      const int col = 64 * FULL + (j - 4 * FULL) * 16 + tx;
      if (col < DH) Vec<T>::store1(dst + col, acc[i][j] * inv);
    }
  }
  if constexpr (SAVE_LSE) {  // lse is contiguous [B, Hq, T]; one thread a row
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (tx == 0 && my_pos[i] < t_len)
        lse[(static_cast<size_t>(b) * hq + h) * t_len + my_pos[i]] =
            l[i] > 0.f ? m[i] + logf(l[i]) : -CUDART_INF_F;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, Cfg<DH>::MIN_BLOCKS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, const int2* __restrict__ tile_range,
                 T* __restrict__ o, int t_len, int n_kt, int hq, int group, Strides qs_,
                 Strides ks_, Strides vs_, int causal, float sm_scale) {
  flash_fwd_body<T, DH, false>(q, k, v, seg, tile_range, o, nullptr, t_len, n_kt, hq, group, qs_,
                               ks_, vs_, causal, sm_scale);
}

// the forward of training: also lse[b, h, i] = m + log(l) of each row (-inf
// for a row with no allowed key), the residual B4 and B5 read
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS, Cfg<DH>::MIN_BLOCKS)
flash_fwd_lse_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ seg, const int2* __restrict__ tile_range,
                     T* __restrict__ o, float* __restrict__ lse, int t_len, int n_kt, int hq,
                     int group, Strides qs_, Strides ks_, Strides vs_, int causal,
                     float sm_scale) {
  flash_fwd_body<T, DH, true>(q, k, v, seg, tile_range, o, lse, t_len, n_kt, hq, group, qs_, ks_,
                              vs_, causal, sm_scale);
}

// ---- the bf16 instances: tensor-core tiles (module comment) ----------------------

constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

template <int DH>
struct MmaFwdCfg {
  static constexpr int DHP = MmaTile<DH>::DHP, LDB = MmaTile<DH>::LDB;
  static constexpr int BK = Cfg<DH>::BK;  // keys a kv tile, the range table's tile: 64, 32 at Dh 256
  static constexpr int NT = 128;          // 4 warps of 16 query rows
  static constexpr int KS = DHP / 16;     // k-steps of a logit
  static constexpr int NS = BK / 8;       // n8 tiles of a warp's logits
  static constexpr int NO = DHP / 8;      // n8 tiles of a warp's output: 8, 10, 10, 16, 32
  // the least blocks an SM that __launch_bounds__ asks registers for; the shared
  // memory below allows as many (Dh 72 and 80 spilled at four)
  static constexpr int MIN_BLOCKS = DH == 64 ? 4 : DH <= 80 ? 3 : 2;
  // Q's A fragments in registers over the walk (KS * 4 a thread), where the registers
  // allow them beside the output accumulators (NO * 4): not at Dh 256, nor at Dh 64,
  // whose four blocks an SM leave 128 registers a thread (with Q in registers it spilled
  // there, and at three blocks ran 8% slower at ColSmol's 17-tile vision on an H100)
  static constexpr bool Q_IN_REGS = DH > 64 && DH <= 128;
  static_assert(NT == 2 * BQ && BK <= BQ, "a thread copies a query and a key segment id");
  // bf16 Q and two stages of K and V, then the query and the two stages' key segment
  // ids; the live-tile flags (a byte a kv tile) follow
  static constexpr size_t SMEM =
      sizeof(bf16) * LDB * (BQ + 4 * BK) + sizeof(int) * (BQ + 2 * BK);
  static size_t smem_bytes(int n_kt) { return SMEM + (n_kt + 15) / 16 * 16; }
};

// The bf16 block's work, shared by the serving kernel and the one that also writes
// each row's logsumexp for the backward (SAVE_LSE).
template <int DH, bool SAVE_LSE>
__device__ __forceinline__ void flash_fwd_mma_body(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ seg, const int2* __restrict__ tile_range, bf16* __restrict__ o,
    float* __restrict__ lse, int t_len, int n_kt, int hq, int group, Strides qs_, Strides ks_,
    Strides vs_, int causal, float sm_scale) {
  using C = MmaFwdCfg<DH>;
  constexpr int LDB = C::LDB, BK = C::BK, NT = C::NT, KS = C::KS, NS = C::NS, NO = C::NO;
  extern __shared__ __align__(16) float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // [BQ][LDB]
  bf16* k_s = q_s + BQ * LDB;                 // [2][BK][LDB]: the ring's two stages
  bf16* v_s = k_s + 2 * BK * LDB;             // [2][BK][LDB]
  int* qseg_s = reinterpret_cast<int*>(v_s + 2 * BK * LDB);  // [BQ]
  int* kseg_s = qseg_s + BQ;                                  // [2][BK]
  unsigned char* live_s = reinterpret_cast<unsigned char*>(kseg_s + 2 * BK);  // [n_kt]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, q0 = qt * BQ;
  const int kvh = h / group;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* segb = seg + static_cast<size_t>(b) * t_len;
  const int2* rb = tile_range + static_cast<size_t>(b) * n_kt;
  // the live kv tiles, as in flash_fwd_body
  const int q_last = min(n_kt - 1, (q0 + BQ - 1) / BK);
  int2 qr = rb[q0 / BK];
  for (int j = q0 / BK + 1; j <= q_last; ++j) {
    const int2 r = rb[j];
    qr = make_int2(min(qr.x, r.x), max(qr.y, r.y));
  }
  const int last = causal ? q_last + 1 : n_kt;  // tiles past it: above the diagonal
  // a flag a kv tile: 0 dead, 1 live, 2 live with every pair allowed (the query tile and
  // the kv tile in one segment, every key before t_len and, under causal, before q0)
  for (int j = tid; j < last; j += NT) {
    const int2 r = rb[j];
    const bool full = qr.x == qr.y && r.x == qr.x && r.y == qr.x && (j + 1) * BK <= t_len &&
                      (!causal || (j + 1) * BK - 1 <= q0);
    live_s[j] = full ? 2 : !(r.y < qr.x || r.x > qr.y);
  }
  cp_rows<DH, BQ, NT>(q + b * qs_.b + h * qs_.h, qs_.t, q0, t_len, q_s);
  if (tid < BQ)
    cp_async_4(qseg_s + tid, segb + (q0 + tid < t_len ? q0 + tid : 0), q0 + tid < t_len);
  cp_async_commit();
  __syncthreads();  // the live flags

  const bf16* kb = k + b * ks_.b + kvh * ks_.h;
  const bf16* vb = v + b * vs_.b + kvh * vs_.h;
  auto next_live = [&](int j) {
    while (++j < last && !live_s[j]) {
    }
    return j;
  };
  // K, V and the key segments of kv tile jt into stage `buf` of the ring
  auto issue = [&](int jt, int buf) {
    const int k0 = jt * BK;
    cp_rows<DH, BK, NT>(kb, ks_.t, k0, t_len, k_s + buf * BK * LDB);
    cp_rows<DH, BK, NT>(vb, vs_.t, k0, t_len, v_s + buf * BK * LDB);
    if (tid < BK)
      cp_async_4(kseg_s + buf * BK + tid, segb + (k0 + tid < t_len ? k0 + tid : 0),
                 k0 + tid < t_len);
  };
  int jt = next_live(-1), buf = 0;
  if (jt < last) issue(jt, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();  // Q, the query segments and the first live tile

  // this lane's rows of the warp's 16: g and g + 8. The softmax runs in log2 units: m
  // is the row's largest sm_scale * log2(e) * q . k, and P = 2^(that - m)
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp;
  const float scale2 = sm_scale * LOG2E;
  int my_seg[2], my_pos[2];
  float m[2], l[2], acc[NO][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    my_seg[i] = qseg_s[r0 + g + 8 * i];
    my_pos[i] = q0 + r0 + g + 8 * i;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;  // this lane's share of the row's sum
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  [[maybe_unused]] uint32_t qf[C::Q_IN_REGS ? KS : 1][4];  // Q's A fragments
  if constexpr (C::Q_IN_REGS) load_a_frags<KS, LDB>(qf, q_s, r0);

  while (jt < last) {
    const int jn = next_live(jt);
    if (jn < last) issue(jn, buf ^ 1);  // the next live tile's copies overlap this one
    cp_async_commit();
    const int k0 = jt * BK;
    const bf16* kt_s = k_s + buf * BK * LDB;
    const bf16* vt_s = v_s + buf * BK * LDB;
    const int* ksb = kseg_s + buf * BK;

    // S = Q K^T for the warp's 16 rows and the tile's BK keys
    float s[NS][4];
    if constexpr (C::Q_IN_REGS) {
      mma_dots_frags<NS, KS, LDB>(s, qf, kt_s, 0);
    } else {
      mma_dots<NS, C::DHP, LDB>(s, q_s, r0, kt_s, 0);
    }

    // the logits in log2 units, masked (kp < t_len, the same segment, kp <= pos under
    // causal) unless every pair of the tile is allowed; row maxima
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (live_s[jt] == 2) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] *= scale2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
        }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int j = 8 * n + 2 * t;
        const int2 kseg = *reinterpret_cast<const int2*>(ksb + j);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, kp = k0 + j + (e & 1);
          const bool ok = kp < t_len && ((e & 1) ? kseg.y : kseg.x) == my_seg[i] &&
                          (!causal || kp <= my_pos[i]);
          s[n][e] = ok ? s[n][e] * scale2 : -CUDART_INF_F;
          mx[i] = fmaxf(mx[i], s[n][e]);
        }
      }
    }
    // online softmax: a row's maximum over its quad, then P = 2^(S - m) in place
    float m_use[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      m_use[i] = m_new == -CUDART_INF_F ? 0.f : m_new;  // no allowed key yet
      alpha[i] = ex2_approx(m[i] - m_use[i]);           // 0 while m[i] is -inf
      m[i] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] *= alpha[i];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex2_approx(s[n][e] - m_use[e >> 1]);  // masked: 2^-inf = 0
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V, keys ascending: P's n8 tiles 2kk and 2kk + 1 are the A fragment of
    // k-step kk, as hi and lo
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t phi[4], plo[4];
      c_to_a_split(s[2 * kk], s[2 * kk + 1], phi, plo);
      mma_rows_split<NO, LDB>(acc, phi, plo, vt_s, 16 * kk, 0);
    }
    cp_async_wait<0>();
    __syncthreads();  // the next tile has landed; no warp reads this stage any more
    jt = jn;
    buf ^= 1;
  }

  // each row's sum over its quad; o is contiguous [B, T, Hq, DH]
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (my_pos[i] >= t_len) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* row = o + ((static_cast<size_t>(b) * t_len + my_pos[i]) * hq + h) * DH;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < DH)  // Dh 72: not the zero columns 72..79
        *reinterpret_cast<__nv_bfloat162*>(row + col) =
            __floats2bfloat162_rn(acc[n][2 * i] * inv, acc[n][2 * i + 1] * inv);
    }
    if constexpr (SAVE_LSE) {  // lse is contiguous [B, Hq, T]; one lane a row
      if (t == 0)
        lse[(static_cast<size_t>(b) * hq + h) * t_len + my_pos[i]] =
            l[i] > 0.f ? m[i] * LN2 + logf(l[i]) : -CUDART_INF_F;
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(MmaFwdCfg<DH>::NT, MmaFwdCfg<DH>::MIN_BLOCKS)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const int* __restrict__ seg,
                     const int2* __restrict__ tile_range, bf16* __restrict__ o, int t_len,
                     int n_kt, int hq, int group, Strides qs_, Strides ks_, Strides vs_,
                     int causal, float sm_scale) {
  flash_fwd_mma_body<DH, false>(q, k, v, seg, tile_range, o, nullptr, t_len, n_kt, hq, group,
                                qs_, ks_, vs_, causal, sm_scale);
}

// the forward of training in bf16: also lse, as flash_fwd_lse_kernel
template <int DH>
__global__ void __launch_bounds__(MmaFwdCfg<DH>::NT, MmaFwdCfg<DH>::MIN_BLOCKS)
flash_fwd_lse_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int* __restrict__ seg,
                         const int2* __restrict__ tile_range, bf16* __restrict__ o,
                         float* __restrict__ lse, int t_len, int n_kt, int hq, int group,
                         Strides qs_, Strides ks_, Strides vs_, int causal, float sm_scale) {
  flash_fwd_mma_body<DH, true>(q, k, v, seg, tile_range, o, lse, t_len, n_kt, hq, group, qs_,
                               ks_, vs_, causal, sm_scale);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, int2* ranges,
                   void* o, float* lse, int batch, int t_len, int hq, int group, Strides qs,
                   Strides ks, Strides vs, int causal, float sm_scale, cudaStream_t stream) {
  using C = Cfg<DH>;
  const int n_kt = (t_len + C::BK - 1) / C::BK;
  cudaError_t err = launch_seg_tile_range(seg, t_len, n_kt, C::BK, batch, ranges, stream);
  if (err != cudaSuccess) return err;
  const dim3 grid((t_len + BQ - 1) / BQ, hq, batch);
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v);
  const int2* rt = ranges;
  if constexpr (std::is_same<T, bf16>::value) {  // the tensor-core body
    using M = MmaFwdCfg<DH>;
    const size_t smem = M::smem_bytes(n_kt);
    if (lse == nullptr)
      return launch_kernel<M::NT>(flash_fwd_mma_kernel<DH>, smem, grid, stream, qt, kt, vt, seg,
                                  rt, static_cast<T*>(o), t_len, n_kt, hq, group, qs, ks, vs,
                                  causal, sm_scale);
    return launch_kernel<M::NT>(flash_fwd_lse_mma_kernel<DH>, smem, grid, stream, qt, kt, vt,
                                seg, rt, static_cast<T*>(o), lse, t_len, n_kt, hq, group, qs, ks,
                                vs, causal, sm_scale);
  } else {
    const size_t smem = C::smem_bytes(n_kt);
    if (lse == nullptr)
      return launch_kernel(flash_fwd_kernel<T, DH>, smem, grid, stream, qt, kt, vt, seg, rt,
                           static_cast<T*>(o), t_len, n_kt, hq, group, qs, ks, vs, causal,
                           sm_scale);
    return launch_kernel(flash_fwd_lse_kernel<T, DH>, smem, grid, stream, qt, kt, vt, seg, rt,
                         static_cast<T*>(o), lse, t_len, n_kt, hq, group, qs, ks, vs, causal,
                         sm_scale);
  }
}

template <typename T>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v, const int* seg,
                      int2* ranges, void* o, float* lse, int batch, int t_len, int hq, int group,
                      Strides qs, Strides ks, Strides vs, int causal, float sm_scale,
                      cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, seg, ranges, o, lse, batch, t_len, hq, group, qs, ks, vs,
                           causal, sm_scale, stream);
    case 72:
      return launch<T, 72>(q, k, v, seg, ranges, o, lse, batch, t_len, hq, group, qs, ks, vs,
                           causal, sm_scale, stream);
    case 80:
      return launch<T, 80>(q, k, v, seg, ranges, o, lse, batch, t_len, hq, group, qs, ks, vs,
                           causal, sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, seg, ranges, o, lse, batch, t_len, hq, group, qs, ks, vs,
                            causal, sm_scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, seg, ranges, o, lse, batch, t_len, hq, group, qs, ks, vs,
                            causal, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace vrt_fa

// device: the CUDA device of every pointer and of the stream. dtype: 0 f32,
// 1 bf16, the same for q, k, v and o. q [batch, t_len, hq, dh] and k, v
// [batch, t_len, hkv, dh] with the given element strides (the head dim
// contiguous; rows 16-byte aligned); seg [batch, t_len] int32 contiguous;
// tile_range: scratch of batch * ceil(t_len / 32) int2; o [batch, t_len, hq,
// dh] contiguous, written in full. dh must be 64, 72, 80, 128 or 256 and hq a
// multiple of hkv. lse: null (serving), or f32 [batch, hq, t_len] contiguous,
// written in full. Returns the cudaError_t of the launches.
extern "C" int vrt_flash_attention(int device, int dtype, const void* q, const void* k,
                                   const void* v, const void* seg, void* tile_range, void* o,
                                   void* lse, int batch, int t_len, int hq, int hkv, int dh,
                                   long long q_sb, long long q_st, long long q_sh,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh, int causal,
                                   float sm_scale, void* stream) {
  using namespace vrt_fa;
  if (batch == 0 || t_len == 0) return 0;
  if (!is_head_dim(dh) || hkv <= 0 || hq % hkv != 0 ||
      (t_len + BQ - 1) / BQ > MAX_TILES || hq > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  const int* s = static_cast<const int*>(seg);
  int2* r = static_cast<int2*>(tile_range);
  float* l = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = hq / hkv;
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_dh<float>(dh, q, k, v, s, r, o, l, batch, t_len, hq, group,
                                               qs, ks, vs, causal, sm_scale, st));
    case 1:
      return static_cast<int>(launch_dh<__nv_bfloat16>(dh, q, k, v, s, r, o, l, batch, t_len,
                                                       hq, group, qs, ks, vs, causal, sm_scale,
                                                       st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
