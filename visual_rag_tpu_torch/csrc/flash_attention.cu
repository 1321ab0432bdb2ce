// K10: flash-attention forward with segment ids, an optional causal mask and
// grouped kv heads.
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
// output is in the input dtype (f32 or bf16).
//
// What bounds it on the H100: arithmetic. A page's vision attention does 4 *
// Dh flops per allowed pair and head over ~1e7 pairs a head, against ~1e8
// bytes of q, k, v and o. This kernel does its products as f32 FMAs on the
// CUDA cores (inputs widened to f32 in shared memory), so it runs against the
// 67 TFLOP/s f32 rate, not the 989 TFLOP/s of the bf16 tensor cores; mma /
// wgmma tiles are later work.
//
// Design: one block per (64-row query tile, head, batch row) walks the 64-key
// kv tiles with an online softmax (running max m, sum l and output
// accumulator in registers), as the TPU kernel walks its kv blocks. A tile
// is skipped, exactly, when it lies wholly above the diagonal under causal
// (the TPU kernel's below_or_on_diag, :325) or when the segment-id ranges of
// the query tile and the kv tile do not meet (then no pair in it is
// allowed). The ranges come from seg_tile_range_kernel, launched first. Both
// skips drop only tiles whose every logit is masked, which add exactly 0 once
// a row has seen one allowed key (as DEFAULT_MASK_VALUE does in the TPU
// kernel). With per-tile segments of a 17-tile page, a query tile visits 16
// of its 272 kv tiles.
//
// 256 threads as 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3 and columns
// 4tx..4tx+3 of the 64 x 64 logit tile and of the 64 x 64 output tile. Q, K^T,
// V and P sit in shared memory as f32 (64 KB in all); every inner-loop read
// is a 16-byte load that is either a broadcast (Q, P) or 8 consecutive
// float4s (K^T, V). Each dot product is one fmaf chain in a fixed order, so a
// call's result does not depend on scheduling.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace vrt_fa {

constexpr int DH = 64;        // head dim: both towers of ColSmol-500M
constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a kv tile (== BQ: q tile i and kv tile i share ranges)
constexpr int THREADS = 256;  // 16 x 16, a 4 x 4 patch each
constexpr int MAX_TILES = 16384;  // T <= 1,048,576: the tile ranges fit shared memory

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements in 16 bytes
  __device__ static void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
  __device__ static void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

// [min, max] of the segment ids of each 64-row tile: one thread a (b, tile).
__global__ void seg_tile_range_kernel(const int* __restrict__ seg, int t_len, int n_tiles,
                                      int batch, int2* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * n_tiles) return;
  const int b = i / n_tiles, j = i - b * n_tiles;
  const int* s = seg + static_cast<size_t>(b) * t_len + j * BK;
  const int n = min(BK, t_len - j * BK);
  int lo = s[0], hi = s[0];
  for (int e = 1; e < n; ++e) {
    lo = min(lo, s[e]);
    hi = max(hi, s[e]);
  }
  out[i] = make_int2(lo, hi);
}

struct Strides {
  long long b, t, h;  // in elements; the head dim is contiguous
};

// Rows [row0, row0 + 64) of one head, 64 values each, into dst as f32:
// row-major dst[r * DH + d] (TRANSPOSE false) or dst[d * 64 + r] (true).
// Rows at or past t_len are zeros.
template <typename T, bool TRANSPOSE>
__device__ __forceinline__ void load_tile(const T* __restrict__ base, Strides st, int row0,
                                          int t_len, float* __restrict__ dst) {
  constexpr int N = Vec<T>::N, PER_ROW = DH / N;
#pragma unroll
  for (int it = 0; it < 64 * PER_ROW / THREADS; ++it) {
    const int v = threadIdx.x + it * THREADS;
    // TRANSPOSE: a warp takes 32 consecutive rows of one column group, so its
    // scalar stores into a column of dst hit 32 banks
    const int r = TRANSPOSE ? v % 64 : v / PER_ROW;
    const int g = TRANSPOSE ? v / 64 : v % PER_ROW;
    float x[N];
    if (row0 + r < t_len) {
      Vec<T>::load(base + (row0 + r) * st.t + g * N, x);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) x[e] = 0.f;
    }
    if (TRANSPOSE) {
#pragma unroll
      for (int e = 0; e < N; ++e) dst[(g * N + e) * 64 + r] = x[e];
    } else {
#pragma unroll
      for (int e = 0; e < N; e += 4)
        *reinterpret_cast<float4*>(dst + r * DH + g * N + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ seg, const int2* __restrict__ tile_range,
                 T* __restrict__ o, int t_len, int n_tiles, int hq, int group, Strides qs_,
                 Strides ks_, Strides vs_, int causal, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;             // [BQ][DH]
  float* kt_s = q_s + BQ * DH;   // [DH][BK]: K transposed
  float* v_s = kt_s + DH * BK;   // [BK][DH]
  float* p_s = v_s + BK * DH;    // [BQ][BK]
  int* qseg_s = reinterpret_cast<int*>(p_s + BQ * BK);  // [BQ]
  int* kseg_s = qseg_s + BQ;                             // [BK]
  int2* range_s = reinterpret_cast<int2*>(kseg_s + BK);  // [n_tiles]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / group, q0 = qt * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const T* qb = q + b * qs_.b + h * qs_.h;
  const T* kb = k + b * ks_.b + kvh * ks_.h;
  const T* vb = v + b * vs_.b + kvh * vs_.h;
  const int* segb = seg + static_cast<size_t>(b) * t_len;
  const int2* rb = tile_range + static_cast<size_t>(b) * n_tiles;

  for (int i = tid; i < n_tiles; i += THREADS) range_s[i] = rb[i];
  if (tid < BQ) qseg_s[tid] = q0 + tid < t_len ? segb[q0 + tid] : 0;
  load_tile<T, false>(qb, qs_, q0, t_len, q_s);
  __syncthreads();

  const int2 qr = range_s[qt];
  int my_seg[4], my_pos[4];
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    my_seg[i] = qseg_s[ty * 4 + i];
    my_pos[i] = q0 + ty * 4 + i;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  const int last = causal ? min(n_tiles, qt + 1) : n_tiles;  // tiles past qt: above the diagonal
  for (int jt = 0; jt < last; ++jt) {
    const int2 kr = range_s[jt];
    if (kr.y < qr.x || kr.x > qr.y) continue;  // no segment id in common (uniform over the block)
    const int k0 = jt * BK;
    load_tile<T, true>(kb, ks_, k0, t_len, kt_s);
    load_tile<T, false>(vb, vs_, k0, t_len, v_s);
    if (tid < BK) kseg_s[tid] = k0 + tid < t_len ? segb[k0 + tid] : 0;
    __syncthreads();

    // S = Q K^T for this thread's 4 x 4 patch
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(q_s + (ty * 4 + i) * DH + d);
#pragma unroll
      for (int e = 0; e < 4; ++e) c[e] = *reinterpret_cast<const float4*>(kt_s + (d + e) * BK + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(a[i].x, c[0].x, s[i][0]); s[i][0] = fmaf(a[i].y, c[1].x, s[i][0]);
        s[i][0] = fmaf(a[i].z, c[2].x, s[i][0]); s[i][0] = fmaf(a[i].w, c[3].x, s[i][0]);
        s[i][1] = fmaf(a[i].x, c[0].y, s[i][1]); s[i][1] = fmaf(a[i].y, c[1].y, s[i][1]);
        s[i][1] = fmaf(a[i].z, c[2].y, s[i][1]); s[i][1] = fmaf(a[i].w, c[3].y, s[i][1]);
        s[i][2] = fmaf(a[i].x, c[0].z, s[i][2]); s[i][2] = fmaf(a[i].y, c[1].z, s[i][2]);
        s[i][2] = fmaf(a[i].z, c[2].z, s[i][2]); s[i][2] = fmaf(a[i].w, c[3].z, s[i][2]);
        s[i][3] = fmaf(a[i].x, c[0].w, s[i][3]); s[i][3] = fmaf(a[i].y, c[1].w, s[i][3]);
        s[i][3] = fmaf(a[i].z, c[2].w, s[i][3]); s[i][3] = fmaf(a[i].w, c[3].w, s[i][3]);
      }
    }

    // mask, online softmax; the 16 threads of a row are lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx * 4 + j, kp = k0 + c;
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
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_use);  // masked: exp(-inf) = 0
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= alpha;
      *reinterpret_cast<float4*>(p_s + (ty * 4 + i) * BK + tx * 4) =
          make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    __syncthreads();

    // O += P V
#pragma unroll 4
    for (int kk = 0; kk < BK; kk += 4) {
      float4 p[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(p_s + (ty * 4 + i) * BK + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) w[e] = *reinterpret_cast<const float4*>(v_s + (kk + e) * DH + tx * 4);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(p[i].x, w[0].x, acc[i][0]); acc[i][0] = fmaf(p[i].y, w[1].x, acc[i][0]);
        acc[i][0] = fmaf(p[i].z, w[2].x, acc[i][0]); acc[i][0] = fmaf(p[i].w, w[3].x, acc[i][0]);
        acc[i][1] = fmaf(p[i].x, w[0].y, acc[i][1]); acc[i][1] = fmaf(p[i].y, w[1].y, acc[i][1]);
        acc[i][1] = fmaf(p[i].z, w[2].y, acc[i][1]); acc[i][1] = fmaf(p[i].w, w[3].y, acc[i][1]);
        acc[i][2] = fmaf(p[i].x, w[0].z, acc[i][2]); acc[i][2] = fmaf(p[i].y, w[1].z, acc[i][2]);
        acc[i][2] = fmaf(p[i].z, w[2].z, acc[i][2]); acc[i][2] = fmaf(p[i].w, w[3].z, acc[i][2]);
        acc[i][3] = fmaf(p[i].x, w[0].w, acc[i][3]); acc[i][3] = fmaf(p[i].y, w[1].w, acc[i][3]);
        acc[i][3] = fmaf(p[i].z, w[2].w, acc[i][3]); acc[i][3] = fmaf(p[i].w, w[3].w, acc[i][3]);
      }
    }
    __syncthreads();  // the next tile overwrites K^T, V, P and the key segments
  }

  // o is contiguous [B, T, Hq, DH]
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (my_pos[i] >= t_len) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* dst = o + ((static_cast<size_t>(b) * t_len + my_pos[i]) * hq + h) * DH + tx * 4;
    Vec<T>::store4(dst, acc[i][0] * inv, acc[i][1] * inv, acc[i][2] * inv, acc[i][3] * inv);
  }
}

inline size_t smem_bytes(int n_tiles) {
  return sizeof(float) * (BQ * DH + DH * BK + BK * DH + BQ * BK) + sizeof(int) * (BQ + BK) +
         sizeof(int2) * n_tiles;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* seg, int2* ranges,
                   void* o, int batch, int t_len, int hq, int group, Strides qs, Strides ks,
                   Strides vs, int causal, float sm_scale, cudaStream_t stream) {
  const int n_tiles = (t_len + BQ - 1) / BQ;
  const int cells = batch * n_tiles;
  seg_tile_range_kernel<<<(cells + 127) / 128, 128, 0, stream>>>(seg, t_len, n_tiles, batch,
                                                                 ranges);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(n_tiles);
  auto kernel = flash_fwd_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, hq, batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg, ranges,
      static_cast<T*>(o), t_len, n_tiles, hq, group, qs, ks, vs, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace vrt_fa

// device: the CUDA device of every pointer and of the stream. dtype: 0 f32,
// 1 bf16, the same for q, k, v and o. q [batch, t_len, hq, dh] and k, v
// [batch, t_len, hkv, dh] with the given element strides (the head dim
// contiguous; rows 16-byte aligned); seg [batch, t_len] int32 contiguous;
// tile_range: scratch of batch * ceil(t_len / 64) int2; o [batch, t_len, hq,
// dh] contiguous, written in full. dh must be 64 and hq a multiple of hkv.
// Returns the cudaError_t of the launches.
extern "C" int vrt_flash_attention(int device, int dtype, const void* q, const void* k,
                                   const void* v, const void* seg, void* tile_range, void* o,
                                   int batch, int t_len, int hq, int hkv, int dh,
                                   long long q_sb, long long q_st, long long q_sh,
                                   long long k_sb, long long k_st, long long k_sh,
                                   long long v_sb, long long v_st, long long v_sh, int causal,
                                   float sm_scale, void* stream) {
  using namespace vrt_fa;
  if (batch == 0 || t_len == 0) return 0;
  if (dh != DH || hkv <= 0 || hq % hkv != 0 || (t_len + BQ - 1) / BQ > MAX_TILES ||
      hq > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Strides qs{q_sb, q_st, q_sh}, ks{k_sb, k_st, k_sh}, vs{v_sb, v_st, v_sh};
  const int* s = static_cast<const int*>(seg);
  int2* r = static_cast<int2*>(tile_range);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int group = hq / hkv;
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(q, k, v, s, r, o, batch, t_len, hq, group, qs, ks,
                                            vs, causal, sm_scale, st));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(q, k, v, s, r, o, batch, t_len, hq, group,
                                                    qs, ks, vs, causal, sm_scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
