// Shared device code of the pair-sorted rerank kernels, K3 (maxsim_dedup.cu)
// and K4 (maxsim_sweep.cu).
//
// Both score (query, candidate) pairs that the wrapper sorted so that pairs
// reading the same stretch of the store sit together: K3 by doc id, K4 by
// row range. A block takes a group of at most GROUP such pairs, each a query
// and a window [lo, hi) of rows counted from one base row, and streams the
// union of their windows through shared memory ONCE, TILE_ROWS rows a tile;
// every pair of the group scores its own query against the rows of each tile
// that fall in its window. That is what the TPU kernels bought with one DMA
// per unique doc (K3) or per row range (K4): a store row read from device
// memory once serves every pair of the group that needs it.
//
// Scores are bit-equal to K2's (maxsim_rerank.cu): the same row_dots (one
// fmaf chain per dot, in dim order), exact maxima (a running max across
// tiles), and the same fold, score = fmaf(qmask[t], rowmax[t], score) over
// the query rows in order, times the per-pair scale.
#pragma once

#include <climits>

#include "maxsim_common.cuh"

namespace vrt {

constexpr int TILE_ROWS = THREADS;  // store rows staged per tile: one a thread
constexpr int GROUP = 16;           // pairs scored per pass over a window

// Bytes of one staged row: the row and one load unit of padding, so that the
// threads of a warp, each reading its own row at the same column, hit
// distinct shared-memory banks (16-byte loads for 2- and 4-byte types,
// 8-byte loads for int8 codes).
template <typename T>
__host__ __device__ constexpr int staged_row_bytes(int dim) {
  return dim * static_cast<int>(sizeof(T)) + (sizeof(T) == 1 ? 8 : 16);
}

// The block's shared memory, carved from the dynamic buffer in this order.
struct PairSmem {
  unsigned char* tile;  // [TILE_ROWS, staged_row_bytes]: the staged rows
  float* q;             // [nq_pad, dim] f32: the query being scored
  float* red;           // [NWARPS, TQ]: block_rowmax scratch
  float* run;           // [GROUP, nq_pad]: running max per (pair, query row)
  float* scale;         // [GROUP] per-pair scale
  int* qid;             // [GROUP] query of each pair
  int* lo;              // [GROUP] first window row, from the base row
  int* hi;              // [GROUP] one past the last window row
  int* out;             // [GROUP] flat index of the pair's score in out
};

template <typename T, int TQ>
__host__ size_t pair_smem_bytes(int dim, int nq_pad) {
  return static_cast<size_t>(TILE_ROWS) * staged_row_bytes<T>(dim) +
         sizeof(float) * (static_cast<size_t>(nq_pad) * dim + NWARPS * TQ +
                          GROUP * nq_pad + GROUP) +
         sizeof(int) * 4 * GROUP;
}

template <typename T, int TQ>
__device__ __forceinline__ PairSmem carve_pair_smem(unsigned char* base, int dim, int nq_pad) {
  PairSmem s;
  s.tile = base;  // TILE_ROWS * staged_row_bytes is a multiple of 16
  s.q = reinterpret_cast<float*>(base + TILE_ROWS * staged_row_bytes<T>(dim));
  s.red = s.q + nq_pad * dim;
  s.run = s.red + NWARPS * TQ;
  s.scale = s.run + GROUP * nq_pad;
  s.qid = reinterpret_cast<int*>(s.scale + GROUP);
  s.lo = s.qid + GROUP;
  s.hi = s.lo + GROUP;
  s.out = s.hi + GROUP;
  return s;
}

// Copies rows [0, rows) of src (contiguous rows of dim elements) into the
// padded tile. dim % 8 == 0 and a 16-byte-aligned store make every row start
// on a load unit.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src, int rows, int dim,
                                           unsigned char* tile) {
  using U = typename std::conditional<sizeof(T) == 1, uint2, uint4>::type;
  const int stride = staged_row_bytes<T>(dim);
  const int units = dim * static_cast<int>(sizeof(T)) / static_cast<int>(sizeof(U));
  const U* s = reinterpret_cast<const U*>(src);
  for (int i = threadIdx.x; i < rows * units; i += THREADS) {
    const int r = i / units;
    *reinterpret_cast<U*>(tile + r * stride + (i - r * units) * sizeof(U)) = s[i];
  }
}

// One query [nq, dim] into q_s as f32, rows nq..nq_pad-1 zero (as K2).
template <typename Q>
__device__ __forceinline__ void stage_query(const Q* __restrict__ qb, int nq, int nq_pad,
                                            int dim, float* q_s) {
  for (int i = threadIdx.x; i < nq_pad * dim; i += THREADS)
    q_s[i] = (i / dim < nq) ? to_float(qb[i]) : 0.f;
}

// Scores the n (<= GROUP) pairs that sm.qid/lo/hi/out/scale describe: pair
// j is query sm.qid[j] against rows [lo, hi) of win, and its score goes to
// out[sm.out[j]]. Every window must be non-empty (hi > lo). `loaded` is the
// query now in sm.q (-1: none); it is restaged only when a pair's query
// differs, which the sort makes rare within a group. Every thread must call
// this, after a __syncthreads() that publishes the metadata; `loaded` is
// block-uniform and so is every branch around a barrier.
template <typename T, typename Q, int TQ>
__device__ void score_pair_group(const T* __restrict__ win, int dim, int n,
                                 const Q* __restrict__ queries,
                                 const float* __restrict__ qmask, int nq, int nq_pad,
                                 const PairSmem& sm, int& loaded, float* __restrict__ out) {
  int glo = INT_MAX, ghi = 0;  // the union of the group's windows
  for (int j = 0; j < n; ++j) {
    glo = min(glo, sm.lo[j]);
    ghi = max(ghi, sm.hi[j]);
  }
  for (int i = threadIdx.x; i < n * nq_pad; i += THREADS) sm.run[i] = -CUDART_INF_F;
  const T* row = reinterpret_cast<const T*>(sm.tile + threadIdx.x * staged_row_bytes<T>(dim));
  for (int t0 = glo; t0 < ghi; t0 += TILE_ROWS) {
    const int rows = min(TILE_ROWS, ghi - t0);
    __syncthreads();  // the last tile's readers are done; sm.run is initialised
    stage_rows<T>(win + static_cast<size_t>(t0) * dim, rows, dim, sm.tile);
    __syncthreads();
    const int r = t0 + threadIdx.x;  // this thread's row, counted from win
    for (int j = 0; j < n; ++j) {
      const int lo = sm.lo[j], hi = sm.hi[j];
      if (hi <= t0 || lo >= t0 + rows) continue;  // the window misses this tile
      if (sm.qid[j] != loaded) {
        __syncthreads();  // every reader of the last query is done
        loaded = sm.qid[j];
        stage_query<Q>(queries + static_cast<size_t>(loaded) * nq * dim, nq, nq_pad, dim,
                       sm.q);
        __syncthreads();
      }
      const bool mine = threadIdx.x < rows && r >= lo && r < hi;
      for (int q0 = 0; q0 < nq_pad; q0 += TQ) {
        float m[TQ];
        if (mine) {
          row_dots<T, TQ>(sm.q + q0 * dim, dim, row, m);
        } else {
#pragma unroll
          for (int t = 0; t < TQ; ++t) m[t] = -CUDART_INF_F;
        }
        block_rowmax<TQ, true>(m, sm.red, sm.run + j * nq_pad + q0);
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const float* qm = qmask + static_cast<size_t>(sm.qid[j]) * nq;
    const float* mx = sm.run + j * nq_pad;
    float score = 0.f;
    for (int t = 0; t < nq; ++t) score = fmaf(qm[t], mx[t], score);
    out[sm.out[j]] = score * sm.scale[j];
  }
}

// Calls f.template run<T, Q, TQ>() for the (store, query) dtype pair of the
// C interface (no qdot body: neither TPU kernel has one) and the query tile
// height tq (tile_rows).
template <typename T, typename Q, typename F>
cudaError_t dispatch_tq(int tq, const F& f) {
  switch (tq) {
    case 8: return f.template run<T, Q, 8>();
    case 16: return f.template run<T, Q, 16>();
    case 24: return f.template run<T, Q, 24>();
    default: return f.template run<T, Q, 32>();
  }
}

template <typename F>
cudaError_t dispatch_pair_kernel(int dtype, int qdtype, int tq, const F& f) {
  switch (dtype_pair(dtype, qdtype)) {
    case kF32: return dispatch_tq<float, float>(tq, f);
    case kBF16: return dispatch_tq<__nv_bfloat16, __nv_bfloat16>(tq, f);
    case kF16: return dispatch_tq<__half, __half>(tq, f);
    case kInt8Bf16: return dispatch_tq<int8_t, __nv_bfloat16>(tq, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vrt
