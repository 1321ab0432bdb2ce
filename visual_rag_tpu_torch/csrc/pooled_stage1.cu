// The pooled stage-1 on the tensor cores: one pooled query vector against
// every doc's pooled rows, the max over the rows.
//
// Replaces no TPU kernel. The JAX package leaves this stage-1 to XLA
// (visual_rag_tpu/parallel/sharded.py:341-351, _local_pooled_padded): an
// einsum with preferred_element_type=f32, a where and a max, which XLA fuses
// on the TPU. On the H100 the same plain ops run as separate passes through
// device memory (an f32 [B, D] score matrix written, masked and folded once
// for each pooled row); this kernel is that fusion, written by hand.
//
// Semantics (the plain version: ops/kernels/prefetch_topk.py::
// pooled_stage1_scores_ref). vals is P-leading [P, D, dim] (bf16, f16 or int8
// codes), mask [P, D] bool, scales [P, D] f32 or null, q [B, dim] the pooled
// queries rounded to the store's compute dtype (bf16 for int8 codes):
//   out[b, d] = max over p with mask[p, d] of scales[p, d] * (q[b] . vals[p, d]),
//               and 0 where doc d has no valid pooled row.
// Products are exact (bf16 x bf16 and f16 x f16 in the tensor cores' f32
// accumulator; int8 codes widen to bf16 exactly), sums are f32, the scale is
// applied in f32 before the mask and the max, and the output is f32, written
// once. No TF32, and no dot or output is rounded to 16 bits.
//
// What bounds it on the H100: operations. At the benchmark's shape (1024
// queries, 200k docs, 32 pooled rows of 128) a call is 1.68 TFLOP against a
// 1.64 GB store, about 1000 operations a byte, so the tensor cores bound it
// (1.70 ms at 989 TFLOP/s) if the store comes from device memory about once.
//
// Design. A block owns a tile of BQ = 256 queries (8 warps of 32 rows, two
// m16 tiles each) and walks a contiguous range of 32-doc tiles; for each doc
// tile it walks p over the P pooled rows. Each warp loads its query rows'
// A fragments (mma.sync m16n8k16, all 128 of k) once and keeps them in
// registers for the whole block: only the doc rows move. The stream of
// (doc tile, p) slabs -- [32, 128] contiguous rows of vals, with the 32 mask
// bytes and scales beside them -- runs through a ring of cp.async stages in
// shared memory; a thread's copies are the same in every slab, and a cursor
// steps from slab to slab, so no address is divided out. Each slab is a
// fresh f32 product of 32 x 32 per warp, 128 deep; the epilogue works on the
// accumulator fragments: times the scale, NEG_INF where the row is masked,
// then a running fmax kept in registers, with a bit per column for "some row
// valid". The loop is software-pipelined by one slab: slab s's product and
// slab s - 1's epilogue are one run of straight-line code, so the FP32 units
// work while the tensor cores do. After a doc tile's last p the block stores
// its [256, 32] tile once (0 where no row is valid), with streaming stores
// that keep the output out of the L2, and goes on to the next doc tile.
// The grid is (query tiles, doc ranges) with the query tile on the fast axis,
// about one block an SM: the blocks that share a doc range run together and
// walk it in step, so each slab comes from device memory once and from the
// 50 MB L2 for the other query tiles. Every doc tile yields its output in a
// fixed order of operations, so two calls give bit-equal scores.
// int8 codes land in the ring as they are and are widened to bf16 in shared
// memory before the product (exact). Doc rows past D are zero-filled and
// their columns never stored; query rows past B are zero and never stored.
// The mask is read in whole words from a 4-byte boundary, the last word cut
// at the mask's end (cp.async's source size), so any D and P are taken.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_tiles.cuh"

namespace vrt {

constexpr float PS_NEG_INF = -1e30f;  // a masked row's score before the max
constexpr int PS_WARPS = 8;
constexpr int PS_THREADS = 32 * PS_WARPS;
constexpr int PS_BQ = 32 * PS_WARPS;  // queries a block: two m16 tiles a warp
constexpr int PS_BD = 32;             // docs a tile
constexpr int PS_NT = PS_BD / 8;      // its n8 tiles
constexpr int PS_DIM = 128;           // eight 16-deep steps
constexpr int PS_KS = PS_DIM / 16;
constexpr int PS_ROW_BYTES = (PS_DIM + 8) * 2;  // a staged 16-bit row: 272 bytes, no bank conflicts
constexpr int PS_STAGES = 6;
constexpr int PS_TILE_BYTES = PS_BD * PS_ROW_BYTES;        // one staged [BD, dim] slab
constexpr int PS_MASK_BYTES = (PS_BD + 3 + 15) / 16 * 16;  // its mask bytes, from a 4-byte boundary
constexpr int PS_SLOT_BYTES = PS_TILE_BYTES + PS_MASK_BYTES + PS_BD * 4;  // then its scales

// Shared memory of one block: the query tile, the ring, and for int8 codes
// the slab widened to bf16.
__host__ inline size_t pooled_stage1_smem(bool int8) {
  return static_cast<size_t>(PS_BQ) * PS_ROW_BYTES + PS_STAGES * PS_SLOT_BYTES +
         (int8 ? PS_TILE_BYTES : 0);
}

template <typename T>
__device__ __forceinline__ void ps_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    mma_f16_16816(d, a, b0, b1);
  } else {
    mma_bf16_16816(d, a, b0, b1);
  }
}

// Where a block is in its stream of slabs: pooled row p of the doc tile that
// starts at d0, and at = p * n_docs + d0, its first entry in mask and scales.
struct SlabCursor {
  int p, d0;
  size_t at;
  __device__ __forceinline__ void next(int p_rows, int n_docs) {
    if (++p == p_rows) {
      p = 0;
      d0 += PS_BD;
      at = d0;
    } else {
      at += n_docs;
    }
  }
};

// T: the store's element type (int8_t: codes against bf16 queries).
// SCALED: each similarity times scales[p, d].
template <typename T, bool SCALED>
__global__ void __launch_bounds__(PS_THREADS, 1)
pooled_stage1_kernel(const T* __restrict__ vals, const unsigned char* __restrict__ mask,
                     const float* __restrict__ scales, int p_rows, int n_docs,
                     const uint16_t* __restrict__ q, int n_q, float* __restrict__ out) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  constexpr int ROW_VECS = PS_DIM * static_cast<int>(sizeof(T)) / 16;  // 16-byte copies a row
  constexpr int COPIES = PS_BD * ROW_VECS / PS_THREADS;               // a thread's, a slab
  static_assert(PS_BD * ROW_VECS % PS_THREADS == 0, "whole copies a thread");
  extern __shared__ __align__(16) float smem[];
  unsigned char* q_s = reinterpret_cast<unsigned char*>(smem);  // [BQ, dim + 8] 16-bit
  unsigned char* ring = q_s + PS_BQ * PS_ROW_BYTES;            // PS_STAGES slots
  unsigned char* wide = ring + PS_STAGES * PS_SLOT_BYTES;       // [BD, dim + 8] bf16 (int8)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * PS_BQ;
  const int n_tiles = (n_docs + PS_BD - 1) / PS_BD;
  const int per = (n_tiles + gridDim.y - 1) / gridDim.y;
  const int tile0 = blockIdx.y * per;
  const int n_slabs = (min(n_tiles, tile0 + per) - tile0) * p_rows;
  if (n_slabs <= 0) return;
  const size_t mask_bytes = static_cast<size_t>(p_rows) * n_docs;
  const size_t p_stride = static_cast<size_t>(n_docs) * PS_DIM;  // elements of one pooled row

  // The query tile: 16-byte copies, rows past n_q zero.
  for (int i = tid; i < PS_BQ * PS_DIM / 8; i += PS_THREADS) {
    const int r = i / (PS_DIM / 8), c = i % (PS_DIM / 8);
    const bool ok = q0 + r < n_q;
    cp_async_16(q_s + r * PS_ROW_BYTES + c * 16,
                ok ? q + static_cast<size_t>(q0 + r) * PS_DIM + c * 8 : q, ok);
  }
  cp_async_commit();

  // This thread's copies of a slab, the same in every slab: the slab is
  // contiguous in vals, so copy i reads its bytes [16 i, 16 i + 16), row
  // i / ROW_VECS; int8 codes land packed and are widened later.
  int row[COPIES], dst_off[COPIES];
#pragma unroll
  for (int k = 0; k < COPIES; ++k) {
    const int i = tid + k * PS_THREADS;
    row[k] = i / ROW_VECS;
    dst_off[k] = INT8 ? i * 16 : row[k] * PS_ROW_BYTES + (i % ROW_VECS) * 16;
  }
  SlabCursor in{0, tile0 * PS_BD, static_cast<size_t>(tile0) * PS_BD};  // the next slab to copy
  int requested = 0;
  auto copy_next = [&]() {  // the next slab into its ring slot
    if (requested < n_slabs) {
      unsigned char* slot = ring + (requested % PS_STAGES) * PS_SLOT_BYTES;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          vals + in.p * p_stride + static_cast<size_t>(in.d0) * PS_DIM);
#pragma unroll
      for (int k = 0; k < COPIES; ++k) {
        const bool ok = in.d0 + row[k] < n_docs;
        cp_async_16(slot + dst_off[k], ok ? src + (tid + k * PS_THREADS) * 16 : src, ok);
      }
      if (tid >= PS_BD && tid < PS_BD + PS_MASK_BYTES / 4) {  // words from a 4-byte boundary
        const size_t w = (in.at & ~static_cast<size_t>(3)) + 4 * (tid - PS_BD);
        const int n = w >= mask_bytes ? 0 : mask_bytes - w >= 4 ? 4 : int(mask_bytes - w);
        cp_async_4_partial(slot + PS_TILE_BYTES + 4 * (tid - PS_BD), n > 0 ? mask + w : mask, n);
      }
      if (SCALED && tid < PS_BD) {
        const bool ok = in.d0 + tid < n_docs;
        cp_async_4(slot + PS_TILE_BYTES + PS_MASK_BYTES + 4 * tid,
                   ok ? scales + in.at + tid : scales, ok);
      }
      in.next(p_rows, n_docs);
    }
    ++requested;
    cp_async_commit();
  };
#pragma unroll 1
  for (int s = 0; s < PS_STAGES - 1; ++s) copy_next();

  // This warp's 32 query rows as A fragments, every k.
  uint32_t a[2][PS_KS][4];
  cp_async_wait<PS_STAGES - 1>();
  __syncthreads();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < PS_KS; ++ks) {
      const int r = warp * 32 + mt * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
      ldsm_x4(a[mt][ks], q_s + r * PS_ROW_BYTES + (ks * 16 + (lane / 16) * 8) * 2);
    }

  float run[2][PS_NT][4];
  unsigned has = 0;  // bit 2 nt + e: column nt * 8 + 2t + e has a valid row
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < PS_NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) run[mt][nt][i] = PS_NEG_INF;

  // Slab s: wait for it, refill the ring, widen int8 codes, and read this
  // thread's mask bits (bit 2 nt + e as in `has`) and scales into registers.
  // Returns its doc rows in shared memory.
  SlabCursor rd{0, tile0 * PS_BD, static_cast<size_t>(tile0) * PS_BD};
  auto prelude = [&](int s, unsigned& valid, float (&sc)[PS_NT][2]) {
    cp_async_wait<PS_STAGES - 2>();
    __syncthreads();  // slab s is in; every warp is done with slab s - 1 and its slot
    copy_next();
    const unsigned char* slot = ring + (s % PS_STAGES) * PS_SLOT_BYTES;
    const unsigned char* m_s = slot + PS_TILE_BYTES + (rd.at & 3);
    const float* sc_s = reinterpret_cast<const float*>(slot + PS_TILE_BYTES + PS_MASK_BYTES);
    valid = 0;
#pragma unroll
    for (int nt = 0; nt < PS_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = nt * 8 + 2 * t + e;
        valid |= static_cast<unsigned>(m_s[c] != 0) << (2 * nt + e);
        if constexpr (SCALED) sc[nt][e] = sc_s[c];
      }
    rd.next(p_rows, n_docs);
    if constexpr (INT8) {
      for (int i = tid; i < PS_BD * PS_DIM / 16; i += PS_THREADS) {
        const int r = i / (PS_DIM / 16), c = (i % (PS_DIM / 16)) * 16;
        const uint4 u = *reinterpret_cast<const uint4*>(slot + r * PS_DIM + c);
        const int8_t* x = reinterpret_cast<const int8_t*>(&u);
        __nv_bfloat162 h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = __floats2bfloat162_rn(static_cast<float>(x[2 * e]),
                                       static_cast<float>(x[2 * e + 1]));
        uint4* dst = reinterpret_cast<uint4*>(wide + r * PS_ROW_BYTES + c * 2);
        dst[0] = *reinterpret_cast<const uint4*>(&h[0]);
        dst[1] = *reinterpret_cast<const uint4*>(&h[4]);
      }
      __syncthreads();
      return static_cast<const unsigned char*>(wide);
    } else {
      return slot;
    }
  };

  // A fresh f32 product of this warp's 32 queries with the slab's docs.
  auto product = [&](float (&acc)[2][PS_NT][4], const unsigned char* b_s) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < PS_NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < PS_KS; ++ks) {
      uint32_t b[PS_NT / 2][4];  // n tiles 2j, 2j + 1: b0, b1 of each
#pragma unroll
      for (int j = 0; j < PS_NT / 2; ++j) {
        const int i = lane / 8;
        const int r = (2 * j + i / 2) * 8 + lane % 8;
        ldsm_x4(b[j], b_s + r * PS_ROW_BYTES + (ks * 16 + (i % 2) * 8) * 2);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < PS_NT; ++nt)
          ps_mma<T>(acc[mt][nt], a[mt][ks], b[nt / 2][(nt % 2) * 2],
                    b[nt / 2][(nt % 2) * 2 + 1]);
    }
  };

  // The epilogue on the fragments: scale, mask, running max.
  auto fold = [&](const float (&acc)[2][PS_NT][4], unsigned valid,
                  const float (&sc)[PS_NT][2]) {
    has |= valid;
#pragma unroll
    for (int nt = 0; nt < PS_NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float bias = (valid >> (2 * nt + e)) & 1 ? 0.f : PS_NEG_INF;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float v = acc[mt][nt][2 * h + e];
            run[mt][nt][2 * h + e] = fmaxf(run[mt][nt][2 * h + e],
                                           SCALED ? fmaf(v, sc[nt][e], bias) : v + bias);
          }
      }
  };

  // After the slab `at` is folded: if it was its doc tile's last pooled row,
  // store the tile and start the next.
  SlabCursor at{0, tile0 * PS_BD, static_cast<size_t>(tile0) * PS_BD};
  auto finish = [&]() {
    if (at.p == p_rows - 1) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = q0 + warp * 32 + mt * 16 + h * 8 + g;
          if (r >= n_q) continue;
          float* o = out + static_cast<size_t>(r) * n_docs;
#pragma unroll
          for (int nt = 0; nt < PS_NT; ++nt) {
            const int d = at.d0 + nt * 8 + 2 * t;
            const float x0 = (has >> (2 * nt)) & 1 ? run[mt][nt][2 * h] : 0.f;
            const float x1 = (has >> (2 * nt + 1)) & 1 ? run[mt][nt][2 * h + 1] : 0.f;
            if (d + 1 < n_docs && (n_docs % 2) == 0) {
              __stcs(reinterpret_cast<float2*>(o + d), make_float2(x0, x1));
            } else {
              if (d < n_docs) __stcs(o + d, x0);
              if (d + 1 < n_docs) __stcs(o + d + 1, x1);
            }
          }
        }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < PS_NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) run[mt][nt][i] = PS_NEG_INF;
      has = 0;
    }
    at.next(p_rows, n_docs);
  };

  // Software-pipelined by one slab: the product of slab s runs in the same
  // straight-line code as the epilogue of slab s - 1, so the FP32 units work
  // while the tensor cores do. Two sets of accumulators take turns.
  float acc0[2][PS_NT][4], acc1[2][PS_NT][4], sc0[PS_NT][2], sc1[PS_NT][2];
  unsigned valid0, valid1;
  product(acc0, prelude(0, valid0, sc0));
  int s = 1;
#pragma unroll 1
  for (; s + 1 < n_slabs; s += 2) {
    product(acc1, prelude(s, valid1, sc1));
    fold(acc0, valid0, sc0);
    finish();
    product(acc0, prelude(s + 1, valid0, sc0));
    fold(acc1, valid1, sc1);
    finish();
  }
  if (s < n_slabs) {
    product(acc1, prelude(s, valid1, sc1));
    fold(acc0, valid0, sc0);
    finish();
    fold(acc1, valid1, sc1);
  } else {
    fold(acc0, valid0, sc0);
  }
  finish();
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T, bool SCALED>
cudaError_t launch_pooled_stage1(int device, const void* vals, const unsigned char* mask,
                                 const float* scales, int p_rows, int n_docs, const void* q,
                                 int n_q, float* out, cudaStream_t stream) {
  const size_t smem = pooled_stage1_smem(std::is_same<T, int8_t>::value);
  auto kernel = pooled_stage1_kernel<T, SCALED>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms = 132;
  // one block an SM: the query tiles side by side, the docs cut into that many ranges
  const int q_tiles = (n_q + PS_BQ - 1) / PS_BQ, n_tiles = (n_docs + PS_BD - 1) / PS_BD;
  const int ranges = std::min(n_tiles, std::min(65535, std::max(1, sms / q_tiles)));
  const dim3 grid(q_tiles, ranges);
  kernel<<<grid, PS_THREADS, smem, stream>>>(static_cast<const T*>(vals), mask, scales,
                                             p_rows, n_docs, static_cast<const uint16_t*>(q),
                                             n_q, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_pooled_stage1(int device, const void* vals, const unsigned char* mask,
                                   const float* scales, int p_rows, int n_docs, const void* q,
                                   int n_q, float* out, cudaStream_t s) {
  if (scales)
    return launch_pooled_stage1<T, true>(device, vals, mask, scales, p_rows, n_docs, q, n_q,
                                         out, s);
  return launch_pooled_stage1<T, false>(device, vals, mask, scales, p_rows, n_docs, q, n_q,
                                        out, s);
}

}  // namespace vrt

// device: the CUDA device of every pointer and of the stream.
// dtype: the store's dtype code (1 bfloat16, 2 float16, 3 int8 codes); q is
// [n_q, dim] in the store's dtype (bf16 for int8 codes); dim is 128. vals and
// q 16-byte aligned, mask 4-byte aligned. mask is [p_rows, n_docs] bool (one
// byte each); scales [p_rows, n_docs] f32 or null. out is [n_q, n_docs] f32.
// Returns the cudaError_t of the launch.
extern "C" int vrt_pooled_stage1_scores(int device, const void* vals, int dtype,
                                        const void* mask, const void* scales, int p_rows,
                                        int n_docs, int dim, const void* q, int n_q,
                                        void* out, void* stream) {
  if (n_docs == 0 || n_q == 0) return 0;
  if (p_rows <= 0 || dim != vrt::PS_DIM) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const unsigned char*>(mask);
  auto sc = static_cast<const float*>(scales);
  auto o = static_cast<float*>(out);
  switch (dtype) {
    case 1: return vrt::dispatch_pooled_stage1<__nv_bfloat16>(device, vals, m, sc, p_rows, n_docs, q, n_q, o, s);
    case 2: return vrt::dispatch_pooled_stage1<__half>(device, vals, m, sc, p_rows, n_docs, q, n_q, o, s);
    case 3: return vrt::dispatch_pooled_stage1<int8_t>(device, vals, m, sc, p_rows, n_docs, q, n_q, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
