// Shared device code of the MaxSim kernels (maxsim_rerank.cu, maxsim_scan.cu,
// and through maxsim_pairs.cuh maxsim_dedup.cu and maxsim_sweep.cu).
//
// They reduce to one step: for a tile of TQ query rows held in shared
// memory (f32) and ONE doc's token rows [0, len), compute rowmax[t] =
// max_r dot(q[t], doc[r]). tile_rowmax() does that step over rows in device
// memory; the pair kernels run row_dots() over rows staged in shared memory.
//
// Numerics: store values (f32, bf16, f16 or int8 codes) and queries (cast
// by the wrapper to the store dtype, or to bf16 for int8 codes) are widened
// to f32, so every product is exact (at most 8-bit x 8-bit significands
// for int8) and products accumulate in f32 -- the TPU kernels' bf16 x bf16
// -> f32 MXU semantics. The qdot form (tile_rowmax_qdot) takes int8 query
// codes and int8 store codes and sums their products in int32 with __dp4a:
// exact integer dots, as the TPU's int8 x int8 -> int32 MXU dot. Each dot
// product is summed by one thread in a fixed order and max is exact, so a
// kernel's result does not depend on scheduling.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace vrt {

constexpr float NEG_INF = -1e30f;  // score of padding and empty docs
constexpr int THREADS = 128;       // doc rows in flight per block
constexpr int NWARPS = THREADS / 32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

// dtype codes of the C interface: 0 float32, 1 bfloat16, 2 float16, 3 int8.
// The (store, query) pairs the kernels take: a float store with queries of
// its own dtype; int8 codes with bf16 queries; int8 codes with int8 query
// codes (qdot: the scan and the tokens stage-1 only).
enum Pair { kF32, kBF16, kF16, kInt8Bf16, kInt8Qdot, kBadPair };

__host__ inline Pair dtype_pair(int dtype, int qdtype) {
  if (dtype == qdtype && dtype >= 0 && dtype <= 2) return static_cast<Pair>(dtype);
  if (dtype == 3 && qdtype == 1) return kInt8Bf16;
  if (dtype == 3 && qdtype == 3) return kInt8Qdot;
  return kBadPair;
}

// 8 consecutive elements -> f32. The source is 16-byte aligned (the wrapper
// requires dim % 8 == 0 and 16-byte-aligned base pointers).
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const __half* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const int8_t* p, float v[8]) {
  const int2 u = *reinterpret_cast<const int2*>(p);  // 8-byte aligned: dim % 8 == 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = static_cast<float>(static_cast<int8_t>(u.x >> (8 * i)));
    v[4 + i] = static_cast<float>(static_cast<int8_t>(u.y >> (8 * i)));
  }
}

// Reduce each thread's running maxima m[t] over the block: rowmax_s[t] =
// max over threads, for t < TQ (RUNNING: rowmax_s[t] = max(rowmax_s[t],
// that), a running max across calls). Every thread of the block must call
// this; it ends with __syncthreads(), after which rowmax_s is valid.
template <int TQ, bool RUNNING = false>
__device__ __forceinline__ void block_rowmax(const float (&m)[TQ], float* red_s,
                                             float* rowmax_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int t = 0; t < TQ; ++t) {
    float x = m[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) red_s[warp * TQ + t] = x;
  }
  __syncthreads();
  if (threadIdx.x < TQ) {
    float x = red_s[threadIdx.x];
#pragma unroll
    for (int w = 1; w < NWARPS; ++w) x = fmaxf(x, red_s[w * TQ + threadIdx.x]);
    rowmax_s[threadIdx.x] = RUNNING ? fmaxf(rowmax_s[threadIdx.x], x) : x;
  }
  __syncthreads();
}

// acc[t] = dot(q_s[t, :], row[:]) for t < TQ: the store row (device or
// shared memory, 16-byte aligned) read 8 elements at a time, the query
// values from shared memory (f32), each dot one fmaf chain in dim order.
// Every MaxSim kernel over float or bf16-query rows scores through this, so
// two kernels that see the same row and query give the same bits.
template <typename T, int TQ>
__device__ __forceinline__ void row_dots(const float* __restrict__ q_s, int dim,
                                         const T* __restrict__ row, float (&acc)[TQ]) {
#pragma unroll
  for (int t = 0; t < TQ; ++t) acc[t] = 0.f;
  for (int c = 0; c < dim; c += 8) {
    float v[8];
    load8(row + c, v);
#pragma unroll
    for (int t = 0; t < TQ; ++t) {
      const float4 qa = *reinterpret_cast<const float4*>(q_s + t * dim + c);
      const float4 qb = *reinterpret_cast<const float4*>(q_s + t * dim + c + 4);
      float a = acc[t];
      a = fmaf(qa.x, v[0], a); a = fmaf(qa.y, v[1], a);
      a = fmaf(qa.z, v[2], a); a = fmaf(qa.w, v[3], a);
      a = fmaf(qb.x, v[4], a); a = fmaf(qb.y, v[5], a);
      a = fmaf(qb.z, v[6], a); a = fmaf(qb.w, v[7], a);
      acc[t] = a;
    }
  }
}

// rowmax_s[t] = max over r < len of dot(q_s[t, :], doc[r, :]) for t < TQ.
//
// Thread i takes doc rows i, i + THREADS, ...: it reads each of its rows
// straight from device memory once, 16 bytes at a time, and dots it with
// all TQ query rows, whose values every lane of a warp reads at the same
// shared-memory address (a broadcast, no bank conflicts). It keeps a running
// max per query row in registers; warp shuffles and one pass over shared
// memory then reduce the maxima across threads. Every thread of the block
// must call this; it ends with __syncthreads(), after which rowmax_s is
// valid. With len == 0 the result is -inf.
template <typename T, int TQ>
__device__ __forceinline__ void tile_rowmax(const float* __restrict__ q_s, int dim,
                                            const T* __restrict__ doc, int len,
                                            float* red_s, float* rowmax_s) {
  float m[TQ];
#pragma unroll
  for (int t = 0; t < TQ; ++t) m[t] = -CUDART_INF_F;
  for (int r = threadIdx.x; r < len; r += THREADS) {
    float acc[TQ];
    row_dots<T, TQ>(q_s, dim, doc + static_cast<size_t>(r) * dim, acc);
#pragma unroll
    for (int t = 0; t < TQ; ++t) m[t] = fmaxf(m[t], acc[t]);
  }
  block_rowmax<TQ>(m, red_s, rowmax_s);
}

// tile_rowmax for int8 query codes against int8 store codes: q_w holds the
// TQ query rows as int32 words of 4 codes each ([TQ, dim / 4], shared
// memory); each dot is an int32 sum of __dp4a steps over 16-byte loads
// (dim % 16 == 0), exact, and converted to f32 once (|dot| < 2^24 for
// dim <= 1024, so exactly).
template <int TQ>
__device__ __forceinline__ void tile_rowmax_qdot(const int* __restrict__ q_w, int dim,
                                                 const int8_t* __restrict__ doc, int len,
                                                 float* red_s, float* rowmax_s) {
  const int dw = dim / 4;
  float m[TQ];
#pragma unroll
  for (int t = 0; t < TQ; ++t) m[t] = -CUDART_INF_F;
  for (int r = threadIdx.x; r < len; r += THREADS) {
    const int4* row = reinterpret_cast<const int4*>(doc + static_cast<size_t>(r) * dim);
    int acc[TQ];
#pragma unroll
    for (int t = 0; t < TQ; ++t) acc[t] = 0;
    for (int c = 0; c < dw; c += 4) {
      const int4 v = row[c / 4];
#pragma unroll
      for (int t = 0; t < TQ; ++t) {
        const int4 qa = *reinterpret_cast<const int4*>(q_w + t * dw + c);
        int a = acc[t];
        a = __dp4a(qa.x, v.x, a);
        a = __dp4a(qa.y, v.y, a);
        a = __dp4a(qa.z, v.z, a);
        a = __dp4a(qa.w, v.w, a);
        acc[t] = a;
      }
    }
#pragma unroll
    for (int t = 0; t < TQ; ++t) m[t] = fmaxf(m[t], static_cast<float>(acc[t]));
  }
  block_rowmax<TQ>(m, red_s, rowmax_s);
}

// Dynamic shared memory above the default 48 KB must be opted into.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Query rows per tile: the group (or query) height rounded up to 8, at most 32.
__host__ inline int tile_rows(int rows) {
  if (rows <= 8) return 8;
  if (rows <= 16) return 16;
  if (rows <= 24) return 24;
  return 32;
}

}  // namespace vrt
