// K3 on the tensor cores: the dedup rerank for bf16, f16 and int8-code stores
// at dim 128. f32 stores and other widths keep maxsim_dedup.cu's body.
//
// Replaces the TPU kernel visual_rag_tpu/ops/kernels/maxsim_rerank.py::
// rerank_candidates_dedup (_make_dedup_kernel :192, pallas_call :355). Its
// function is K2's: out[b, k] = scale[c] * sum_t qmask[b, t] * max_{r <
// len[c]} q[b, t] . flat[off[c] + r] for c = candidates[b, k]; where c is -1,
// out of range or len[c] == 0 the wrapper's NEG_INF stays. The wrapper
// (ops/kernels/maxsim_rerank.py::dedup_layout) sorts the flattened pairs by
// doc id, stably, and cuts each doc's pairs into runs of at most
// `run_pairs`, chosen so that a run holds at most DM_QTILES query tiles of 16
// rows; `starts` holds the first sorted position of each run, then `total`.
//
// Numerics: products are exact (bf16 x bf16 and f16 x f16 in the tensor
// cores' f32 accumulator; int8 codes widen to bf16 exactly, against
// bf16-rounded queries), each 128-term dot is an f32 sum in the tensor cores'
// order, the max over doc rows is exact, and the fold is score =
// fmaf(qmask[t], rowmax[t], score) over the query rows in token order, times
// the doc's scale. So only the order of the dot's sums differs from K2's
// fmaf chain in dim order, and the scores are not bit-equal to K2's. Every
// pair is scored by one block in a fixed order of operations, with no
// atomics: two calls give equal bits.
//
// What bounds it on the H100: bytes. At the search cell's shape (1024 queries
// of 32 rows x 200 candidates over 200k docs of ~1,008 rows) a call reads
// about 128k distinct docs, 33 GB, about 10 ms at 3.35 TB/s, against ~1.7
// TFLOP of products, under 2 ms on the tensor cores.
//
// Design. A persistent grid, one block of 8 warps an SM. Each block takes a
// contiguous share of the runs (the runs are counted on the device, by a
// binary search of `starts`), loads its share's table (first pair, doc
// offset, length, scale) into shared memory once, and walks it in doc order,
// so that the memory sees long sequential streams. The doc rows of its runs
// are one stream of 128-row slabs through a ring of cp.async stages; the ring
// runs across doc boundaries, so the next doc's first slabs load while this
// doc's last products and its fold run. Rows at or past a doc's end are
// zero-filled (nothing is read). int8 codes land in the ring as they are and
// are widened to bf16 in shared memory before the product.
// A run's queries are T = pairs x ceil(nq / 16) tiles of 16 rows, T <=
// DM_QTILES. The warps split the run as a grid of WN column parts (doc rows of
// each slab) by WM = 8 / WN tile groups, WN the largest of 8, 4, 2, 1 with
// 3 WM >= T: each warp holds the A fragments (mma.sync m16n8k16) of up to
// three query tiles in registers, loaded from the queries once a run, and
// meets each slab's rows of its part as B fragments through ldmatrix. The max
// over doc rows stays on the accumulator fragments: columns at or past the
// doc's rows are -inf before a running fmaxf in registers. Once a run, the
// lanes of a quad and then the parts meet in shared memory, and one thread a
// pair folds the row maxima in token order (its qmask row staged in shared
// memory) and stores the score at out[order[j]]. The next run's A fragments
// and qmask rows are requested right after this run's last product, when the
// registers are free, so that they land while this run's maxima meet and fold.
// A run of n > 1 pairs reads each slab from device memory once and applies
// every pair's query to it.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_tiles.cuh"

namespace vrt {

constexpr int DM_WARPS = 8;
constexpr int DM_THREADS = 32 * DM_WARPS;
constexpr int DM_DIM = 128;
constexpr int DM_KS = DM_DIM / 16;              // 16-deep k-steps of a dot
constexpr int DM_SLAB = 128;                    // doc rows a slab
constexpr int DM_NT = DM_SLAB / 8;              // its n8 tiles
constexpr int DM_ROW_BYTES = (DM_DIM + 8) * 2;  // a staged 16-bit row: 272 bytes, no bank conflicts
constexpr int DM_STAGES = 4;
constexpr int DM_SLOTS = 3;                     // query tiles a warp holds
constexpr int DM_QTILES = DM_WARPS * DM_SLOTS;  // query tiles a run may have
constexpr int DM_RUN_PAIRS = 16;                // pairs a run may have (dedup_layout)
constexpr int DM_RUNS = 2048;                   // runs a block's table holds

template <typename T>
__host__ __device__ constexpr int dm_slot_bytes() {
  return sizeof(T) == 1 ? DM_SLAB * DM_DIM : DM_SLAB * DM_ROW_BYTES;
}

// Shared memory of one block: the ring, the widened slab (int8 codes), the
// run table, the row maxima of a run (by part, then over the parts), two
// runs' qmask rows and pairs.
template <typename T>
__host__ __device__ constexpr size_t dedup_mma_smem() {
  return static_cast<size_t>(DM_STAGES) * dm_slot_bytes<T>() +
         (sizeof(T) == 1 ? DM_SLAB * DM_ROW_BYTES : 0) + 4 * (DM_RUNS + 1) + 12 * DM_RUNS +
         4 * 4 * DM_QTILES * 16 + 4 * 2 * DM_RUN_PAIRS;
}

template <typename T>
__device__ __forceinline__ void dm_mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value) {
    mma_f16_16816(d, a, b0, b1);
  } else {
    mma_bf16_16816(d, a, b0, b1);
  }
}

// One slab against a warp's NK query tiles: its part's n8 tiles [nt0, nt0 +
// 2 steps) of the staged rows b_s, two a step, every k; then the running max
// over the slab's first `rows` rows (the doc's), on the fragments.
template <typename T, int NK>
__device__ __forceinline__ void dm_slab(const uint32_t (&a)[DM_SLOTS][DM_KS][4],
                                        const unsigned char* b_s, int nt0, int steps, int rows,
                                        float (&mx)[DM_SLOTS][2], int lane) {
  const int t = lane % 4, i = lane / 8;
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    const int nt = nt0 + 2 * s;
    float acc[NK][2][4];
#pragma unroll
    for (int kk = 0; kk < NK; ++kk)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[kk][j][e] = 0.f;
    // matrices 0, 1: rows of n tile nt, k 0-7 and 8-15 of the step; 2, 3: n tile nt + 1
    const unsigned char* b_row = b_s + ((nt + i / 2) * 8 + lane % 8) * DM_ROW_BYTES + (i % 2) * 16;
#pragma unroll
    for (int ks = 0; ks < DM_KS; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, b_row + ks * 32);
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        dm_mma<T>(acc[kk][0], a[kk][ks], b[0], b[1]);
        dm_mma<T>(acc[kk][1], a[kk][ks], b[2], b[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = (nt + j) * 8 + 2 * t + e < rows;  // zero-filled rows never win
#pragma unroll
        for (int kk = 0; kk < NK; ++kk)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            mx[kk][h] = fmaxf(mx[kk][h], live ? acc[kk][j][2 * h + e] : -CUDART_INF_F);
      }
  }
}

// T: the store's element type (int8_t: codes against bf16 queries). queries
// [B, nq, 128] in the store's compute dtype (bf16 for int8 codes), qmask [B,
// nq] f32; sorted_ids, order [B * k] and starts [n_bound + 1] are dedup_layout's.
template <typename T>
__global__ void __launch_bounds__(DM_THREADS, 1)
dedup_kernel_mma(const T* __restrict__ flat, const int* __restrict__ offsets,
                 const int* __restrict__ lengths, const float* __restrict__ doc_scales,
                 const uint16_t* __restrict__ queries, const float* __restrict__ qmask, int nq,
                 int k, const int* __restrict__ sorted_ids, const int* __restrict__ order,
                 const int* __restrict__ starts, int n_bound, int total,
                 float* __restrict__ out) {
  constexpr bool INT8 = std::is_same<T, int8_t>::value;
  constexpr int SLOT = dm_slot_bytes<T>();
  constexpr int ROW_VECS = DM_DIM * static_cast<int>(sizeof(T)) / 16;  // 16-byte copies a row
  constexpr int COPIES = DM_SLAB * ROW_VECS / DM_THREADS;              // a thread's, a slab
  static_assert(DM_SLAB * ROW_VECS % DM_THREADS == 0, "whole copies a thread");
  extern __shared__ __align__(16) float smem[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(smem);  // DM_STAGES slots
  unsigned char* wide = ring + DM_STAGES * SLOT;                 // [SLAB, dim + 8] bf16 (int8)
  int* t_start = reinterpret_cast<int*>(wide + (INT8 ? DM_SLAB * DM_ROW_BYTES : 0));
  int* t_off = t_start + DM_RUNS + 1;
  int* t_len = t_off + DM_RUNS;
  float* t_scale = reinterpret_cast<float*>(t_len + DM_RUNS);
  float* red = t_scale + DM_RUNS;        // [WN, T, 16]: a run's row maxima by part
  float* rowmax = red + DM_QTILES * 16;  // [T, 16]: over the parts
  float* qm_s = rowmax + DM_QTILES * 16;  // [2, pairs, nq]: two runs' qmask rows
  int* pairs = reinterpret_cast<int*>(qm_s + 2 * DM_QTILES * 16);  // [2, RUN_PAIRS]: order[j]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;

  // This block's runs: an even share of the n_runs runs, whose starts are < total.
  int lo = 0, hi = n_bound;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (starts[mid] < total) lo = mid + 1;
    else hi = mid;
  }
  const int r0 = static_cast<int>(static_cast<int64_t>(lo) * blockIdx.x / gridDim.x);
  const int nr = static_cast<int>(static_cast<int64_t>(lo) * (blockIdx.x + 1) / gridDim.x) - r0;
  if (nr <= 0) return;
  for (int i = tid; i <= nr; i += DM_THREADS) t_start[i] = starts[r0 + i];
  __syncthreads();
  for (int i = tid; i < nr; i += DM_THREADS) {
    const int c = sorted_ids[t_start[i]];  // a run's doc is valid (dedup_layout)
    t_off[i] = offsets[c];
    t_len[i] = lengths[c];
    t_scale[i] = doc_scales ? doc_scales[c] : 1.f;
  }
  __syncthreads();
  auto n_slabs = [&](int i) { return (t_len[i] + DM_SLAB - 1) / DM_SLAB; };
  auto next_live = [&](int i) {  // the first run at or after i with rows (the others score NEG_INF)
    while (i < nr && t_len[i] <= 0) ++i;
    return i;
  };
  int run = next_live(0);
  if (run >= nr) return;
  const int mt_n = (nq + 15) / 16;  // query tiles a pair

  // This thread's copies of a slab, the same in every slab: copy i reads the
  // slab's bytes [16 i, 16 i + 16), row i / ROW_VECS; int8 codes land packed.
  int row[COPIES], dst_off[COPIES];
#pragma unroll
  for (int c = 0; c < COPIES; ++c) {
    const int i = tid + c * DM_THREADS;
    row[c] = i / ROW_VECS;
    dst_off[c] = INT8 ? i * 16 : row[c] * DM_ROW_BYTES + (i % ROW_VECS) * 16;
  }
  int cp_run = run, cp_slab = 0, requested = 0;
  auto copy_next = [&]() {  // the next slab of the stream into its ring slot
    if (cp_run < nr) {
      unsigned char* slot = ring + (requested % DM_STAGES) * SLOT;
      const int row0 = cp_slab * DM_SLAB, rows = min(DM_SLAB, t_len[cp_run] - row0);
      const unsigned char* src = reinterpret_cast<const unsigned char*>(
          flat + (static_cast<size_t>(t_off[cp_run]) + row0) * DM_DIM);
#pragma unroll
      for (int c = 0; c < COPIES; ++c) {
        const bool ok = row[c] < rows;
        cp_async_16(slot + dst_off[c], ok ? src + (tid + c * DM_THREADS) * 16 : src, ok);
      }
      if (++cp_slab == n_slabs(cp_run)) {
        cp_slab = 0;
        cp_run = next_live(cp_run + 1);
      }
    }
    ++requested;
    cp_async_commit();
  };

  for (int j = tid; j < t_start[run + 1] - t_start[run]; j += DM_THREADS)
    pairs[j] = order[t_start[run] + j];
#pragma unroll 1
  for (int s = 0; s < DM_STAGES - 1; ++s) copy_next();

  uint32_t a[DM_SLOTS][DM_KS][4];
  float mx[DM_SLOTS][2], qv[2];
  int slab = 0, par = 0, o_next = 0;
  int n_pairs = 0, n_t = 0, wn = 1, wm = 1, nk = 1, part = 0, grp = 0;
  // Run r begins, its pairs in pairs[p]: its warp grid, then loads left in
  // flight: the A fragments of this warp's tiles, this thread's share of the
  // run's qmask rows (into qv, for keep_qmask), the next run's pairs (o_next).
  auto begin = [&](int r, int p) {
    n_pairs = t_start[r + 1] - t_start[r];
    n_t = n_pairs * mt_n;
    wn = n_t <= DM_SLOTS ? 8 : n_t <= 2 * DM_SLOTS ? 4 : n_t <= 4 * DM_SLOTS ? 2 : 1;
    wm = DM_WARPS / wn;
    nk = (n_t + wm - 1) / wm;
    part = warp % wn;
    grp = warp / wn;
#pragma unroll
    for (int kk = 0; kk < DM_SLOTS; ++kk) {
      const int tile = grp + kk * wm;
      const bool live = kk < nk && tile < n_t;
      const int j = live ? tile / mt_n : 0;
      const int r_lo = (live ? tile % mt_n : 0) * 16 + g, r_hi = r_lo + 8;
      const size_t q0 = static_cast<size_t>(pairs[p * DM_RUN_PAIRS + j] / k) * nq;
      const uint32_t* q_lo = reinterpret_cast<const uint32_t*>(queries + (q0 + r_lo) * DM_DIM);
      const uint32_t* q_hi = reinterpret_cast<const uint32_t*>(queries + (q0 + r_hi) * DM_DIM);
      const bool ok_lo = live && r_lo < nq, ok_hi = live && r_hi < nq;
#pragma unroll
      for (int ks = 0; ks < DM_KS; ++ks) {
        a[kk][ks][0] = ok_lo ? q_lo[ks * 8 + t] : 0u;
        a[kk][ks][1] = ok_hi ? q_hi[ks * 8 + t] : 0u;
        a[kk][ks][2] = ok_lo ? q_lo[ks * 8 + 4 + t] : 0u;
        a[kk][ks][3] = ok_hi ? q_hi[ks * 8 + 4 + t] : 0u;
      }
      mx[kk][0] = mx[kk][1] = -CUDART_INF_F;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {  // pairs x nq <= DM_QTILES x 16 = 384 < 2 x DM_THREADS
      const int e = tid + c * DM_THREADS, j = e / nq;
      if (e < n_pairs * nq)
        qv[c] = qmask[static_cast<size_t>(pairs[p * DM_RUN_PAIRS + j] / k) * nq + e - j * nq];
    }
    const int nx = next_live(r + 1);
    if (nx < nr && tid < t_start[nx + 1] - t_start[nx]) o_next = order[t_start[nx] + tid];
  };
  auto keep_qmask = [&](int p) {  // the begun run's qmask rows, for its fold
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int e = tid + c * DM_THREADS;
      if (e < n_pairs * nq) qm_s[p * DM_QTILES * 16 + e] = qv[c];
    }
  };
  __syncthreads();  // the first run's pairs
  begin(run, 0);
  keep_qmask(0);

#pragma unroll 1
  for (int item = 0; run < nr; ++item) {
    cp_async_wait<DM_STAGES - 2>();
    __syncthreads();  // slab `item` is in; every warp is done with the last slab and its slot
    copy_next();
    const unsigned char* b_s = ring + (item % DM_STAGES) * SLOT;
    if constexpr (INT8) {
      for (int i = tid; i < DM_SLAB * DM_DIM / 16; i += DM_THREADS) {
        const int r = i / (DM_DIM / 16), c = (i % (DM_DIM / 16)) * 16;
        const uint4 u = *reinterpret_cast<const uint4*>(b_s + r * DM_DIM + c);
        const int8_t* x = reinterpret_cast<const int8_t*>(&u);
        __nv_bfloat162 h[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          h[e] = __floats2bfloat162_rn(static_cast<float>(x[2 * e]),
                                       static_cast<float>(x[2 * e + 1]));
        uint4* dst = reinterpret_cast<uint4*>(wide + r * DM_ROW_BYTES + c * 2);
        dst[0] = *reinterpret_cast<const uint4*>(&h[0]);
        dst[1] = *reinterpret_cast<const uint4*>(&h[4]);
      }
      __syncthreads();
      b_s = wide;
    }

    const int rows = min(DM_SLAB, t_len[run] - slab * DM_SLAB);
    const int nt0 = part * (DM_NT / wn), steps = DM_NT / wn / 2;
    if (nk == 1) dm_slab<T, 1>(a, b_s, nt0, steps, rows, mx, lane);
    else if (nk == 2) dm_slab<T, 2>(a, b_s, nt0, steps, rows, mx, lane);
    else dm_slab<T, 3>(a, b_s, nt0, steps, rows, mx, lane);

    if (++slab == n_slabs(run)) {  // the run's last slab: the maxima meet, then the fold
#pragma unroll
      for (int kk = 0; kk < DM_SLOTS; ++kk) {
        if (kk >= nk) break;  // nk is the block's: every thread reaches each shuffle
        const int tile = grp + kk * wm;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = mx[kk][h];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          if (t == 0 && tile < n_t) red[(part * n_t + tile) * 16 + h * 8 + g] = v;
        }
      }
      const int nx = next_live(run + 1);
      if (nx < nr && tid < t_start[nx + 1] - t_start[nx])
        pairs[(par ^ 1) * DM_RUN_PAIRS + tid] = o_next;
      __syncthreads();
      // the next run's loads go out now, and land during this run's fold
      const int done_pairs = n_pairs, done_t = n_t, done_wn = wn;
      if (nx < nr) begin(nx, par ^ 1);
      for (int e = tid; e < done_t * 16; e += DM_THREADS) {
        float v = red[e];
        for (int p = 1; p < done_wn; ++p) v = fmaxf(v, red[p * done_t * 16 + e]);
        rowmax[e] = v;
      }
      __syncthreads();
      if (tid < done_pairs) {
        const float* qm = qm_s + par * DM_QTILES * 16 + tid * nq;
        const float* rm = rowmax + tid * mt_n * 16;
        float score = 0.f;
#pragma unroll 8
        for (int tq = 0; tq < nq; ++tq) score = fmaf(qm[tq], rm[tq], score);
        out[pairs[par * DM_RUN_PAIRS + tid]] = score * t_scale[run];
      }
      if (nx < nr) keep_qmask(par ^ 1);
      slab = 0;
      par ^= 1;
      run = nx;
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
}

template <typename T>
cudaError_t launch_dedup_mma(int device, const void* flat, const int* offsets,
                             const int* lengths, const float* doc_scales, const void* queries,
                             const float* qmask, int nq, int k, const int* sorted_ids,
                             const int* order, const int* starts, int n_bound, int total,
                             float* out, cudaStream_t stream) {
  const size_t smem = dedup_mma_smem<T>();
  auto kernel = dedup_kernel_mma<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
    sms = 132;
  // one block an SM, and no more runs a block than its table holds
  const int grid = std::max(std::min(sms, n_bound), (n_bound + DM_RUNS - 1) / DM_RUNS);
  kernel<<<grid, DM_THREADS, smem, stream>>>(
      static_cast<const T*>(flat), offsets, lengths, doc_scales,
      static_cast<const uint16_t*>(queries), qmask, nq, k, sorted_ids, order, starts, n_bound,
      total, out);
  return cudaGetLastError();
}

}  // namespace vrt

// device: the CUDA device of every pointer and of the stream. dtype: the
// store's dtype code (1 bfloat16, 2 float16, 3 int8 codes); queries [b, nq,
// 128] in the store's dtype (bf16 for int8 codes), qmask [b, nq] f32, dim
// 128. doc_scales may be null (scale 1). sorted_ids, order [b * k] and
// starts [n_bound + 1] are dedup_layout's, cut into runs of at most
// run_pairs pairs; the shared arrays hold a run of at most DM_RUN_PAIRS pairs
// and DM_QTILES query tiles, so a larger run_pairs is refused before the
// launch. out [b * k] f32 holds NEG_INF on entry, and the kernel writes every
// pair of a doc with rows. Returns the cudaError_t of the launch.
extern "C" int vrt_rerank_candidates_dedup_mma(int device, const void* flat, int dtype,
                                               const void* offsets, const void* lengths,
                                               const void* doc_scales, const void* queries,
                                               const void* qmask, int b, int nq, int k,
                                               const void* sorted_ids, const void* order,
                                               const void* starts, int n_bound, int run_pairs,
                                               void* out, void* stream) {
  if (b == 0 || k == 0 || n_bound == 0) return 0;
  if (nq <= 0 || run_pairs <= 0 || run_pairs > vrt::DM_RUN_PAIRS ||
      run_pairs * ((nq + 15) / 16) > vrt::DM_QTILES)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto o = static_cast<const int*>(offsets);
  auto l = static_cast<const int*>(lengths);
  auto sc = static_cast<const float*>(doc_scales);
  auto qm = static_cast<const float*>(qmask);
  auto ids = static_cast<const int*>(sorted_ids);
  auto ord = static_cast<const int*>(order);
  auto st = static_cast<const int*>(starts);
  auto res = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return vrt::launch_dedup_mma<__nv_bfloat16>(device, flat, o, l, sc, queries, qm, nq, k, ids, ord, st, n_bound, b * k, res, s);
    case 2: return vrt::launch_dedup_mma<__half>(device, flat, o, l, sc, queries, qm, nq, k, ids, ord, st, n_bound, b * k, res, s);
    case 3: return vrt::launch_dedup_mma<int8_t>(device, flat, o, l, sc, queries, qm, nq, k, ids, ord, st, n_bound, b * k, res, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
