// K4: exact MaxSim rerank by a sweep over row ranges of the store.
//
// Replaces the TPU kernel visual_rag_tpu/ops/kernels/maxsim_sweep.py::
// rerank_candidates_sweep (_make_kernel :63, pallas_call :343). Its function
// is K2's (maxsim_rerank.cu), with qmask applied in the fold as K2 applies it
// (the TPU kernel zeroes masked query rows instead: the same scores for 0/1
// masks). The wrapper (ops/kernels/maxsim_sweep.py::sweep_layout) cuts the
// store into ranges of r_step rows, sorts the flattened pairs by (range of
// the doc's first row, query), stably, with -1, out-of-range and 0-token
// pairs past every range, and gives each pair its query, its window [off,
// off + len) counted from its range's first row, its scale and its flat
// output index; pair_start[r] is the first sorted pair of range r.
//
// What bounds it on the H100: arithmetic, as K2. What the sweep buys is
// traffic: pairs whose docs start in one range share one pass over the
// range's rows, whether or not they hold the same doc, so dense candidate
// sets (coverage B * K * ceil32(max_len) / rows of 6 and more, the engine's
// policy) read the store about once.
//
// Design: one block per range; it takes the range's pairs GROUP at a time
// and streams the union of the group's windows through shared memory once,
// a tile at a time, each pair scoring its own query against the tile rows
// inside its own window (maxsim_pairs.cuh). That is the TPU kernel's idea --
// one load of a range serves every pair in it, queries share one pass -- not
// its blocks: no 128-row M-packing of queries, no n_bufs DMA ring, no
// bit-packed scalar metadata, and no 256-query limit.
#include "maxsim_pairs.cuh"

namespace vrt {

template <typename T, typename Q, int TQ>
__global__ void __launch_bounds__(THREADS)
sweep_kernel(const T* __restrict__ flat, int dim, const Q* __restrict__ queries,
             const float* __restrict__ qmask, int nq, int nq_pad,
             const int* __restrict__ range_start, const int* __restrict__ pair_start,
             const int* __restrict__ pair_q, const int* __restrict__ pair_off,
             const int* __restrict__ pair_len, const int* __restrict__ order,
             const float* __restrict__ pair_scale, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p0 = pair_start[blockIdx.x], p1 = pair_start[blockIdx.x + 1];
  if (p0 >= p1) return;  // no candidate starts in this range
  const PairSmem sm = carve_pair_smem<T, TQ>(smem, dim, nq_pad);
  const T* win = flat + static_cast<size_t>(range_start[blockIdx.x]) * dim;
  int loaded = -1;
  for (int g0 = p0; g0 < p1; g0 += GROUP) {
    const int n = min(GROUP, p1 - g0);
    __syncthreads();  // the last group's fold is done with the metadata
    if (threadIdx.x < n) {
      const int p = g0 + threadIdx.x;
      sm.qid[threadIdx.x] = pair_q[p];
      sm.lo[threadIdx.x] = pair_off[p];
      sm.hi[threadIdx.x] = pair_off[p] + pair_len[p];
      sm.out[threadIdx.x] = order[p];
      sm.scale[threadIdx.x] = pair_scale ? pair_scale[p] : 1.f;
    }
    __syncthreads();
    score_pair_group<T, Q, TQ>(win, dim, n, queries, qmask, nq, nq_pad, sm, loaded, out);
  }
}

struct SweepLaunch {
  const void* flat;
  int dim;
  const void* queries;
  const float* qmask;
  int nq, n_ranges;
  const int* range_start;
  const int* pair_start;
  const int* pair_q;
  const int* pair_off;
  const int* pair_len;
  const int* order;
  const float* pair_scale;
  float* out;
  cudaStream_t stream;

  template <typename T, typename Q, int TQ>
  cudaError_t run() const {
    const int nq_pad = (nq + TQ - 1) / TQ * TQ;
    const size_t smem = pair_smem_bytes<T, TQ>(dim, nq_pad);
    auto kernel = sweep_kernel<T, Q, TQ>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<n_ranges, THREADS, smem, stream>>>(
        static_cast<const T*>(flat), dim, static_cast<const Q*>(queries), qmask, nq, nq_pad,
        range_start, pair_start, pair_q, pair_off, pair_len, order, pair_scale, out);
    return cudaGetLastError();
  }
};

}  // namespace vrt

// device: the CUDA device of every pointer and of the stream. dtype,
// qdtype: the dtype codes of flat and queries (maxsim_common.cuh dtype_pair;
// no qdot body). range_start [n_ranges], pair_start [n_ranges + 1] and the
// per-pair arrays (sorted order) are sweep_layout's; pair_scale may be null
// (1). out [b * k] f32 holds NEG_INF on entry; the kernel writes every pair
// of pair_start's ranges. Returns the cudaError_t of the launch.
extern "C" int vrt_rerank_candidates_sweep(int device, const void* flat, int dtype,
                                           const void* queries, int qdtype, const void* qmask,
                                           int nq, int dim, int n_ranges,
                                           const void* range_start, const void* pair_start,
                                           const void* pair_q, const void* pair_off,
                                           const void* pair_len, const void* order,
                                           const void* pair_scale, void* out, void* stream) {
  if (n_ranges == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const vrt::SweepLaunch launch{
      flat, dim, queries, static_cast<const float*>(qmask), nq, n_ranges,
      static_cast<const int*>(range_start), static_cast<const int*>(pair_start),
      static_cast<const int*>(pair_q), static_cast<const int*>(pair_off),
      static_cast<const int*>(pair_len), static_cast<const int*>(order),
      static_cast<const float*>(pair_scale), static_cast<float*>(out),
      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(vrt::dispatch_pair_kernel(dtype, qdtype, vrt::tile_rows(nq), launch));
}
