// K3: exact MaxSim rerank with the (query, candidate) pairs sorted by doc,
// so that each unique doc is read from device memory once for all the
// queries that hold it.
//
// Replaces the TPU kernel visual_rag_tpu/ops/kernels/maxsim_rerank.py::
// rerank_candidates_dedup (_make_dedup_kernel :192, pallas_call :355). Its
// function is K2's: out[b, k] = scale[c] * sum_t qmask[b, t] * max_{r <
// len[c]} q[b, t] . flat[off[c] + r] for c = candidates[b, k], NEG_INF where
// c is -1 (or out of range) or len[c] == 0; int8 codes are widened to f32
// against bf16-rounded queries and the per-doc scale multiplies the finished
// score. The wrapper (ops/kernels/maxsim_rerank.py::dedup_layout) sorts the
// flattened pairs by doc id, stably, and cuts each doc's pairs into runs of
// at most GROUP; `starts` holds the first sorted position of each run, then
// `total` for every block past the last run (the grid is an upper bound on
// the run count, so the host never waits for the device to count them).
//
// What bounds it on the H100: arithmetic, as K2 (2 * NQ * len * dim f32
// FMAs a pair on the CUDA cores). What the sort buys is device-memory and
// L2 traffic: K2 reads a doc once per pair, K3 once per run.
//
// Design: one block per run. The block stages the doc's rows [off, off +
// len) through shared memory a tile at a time, scores every pair of the run
// against each tile (maxsim_pairs.cuh) and writes each score straight to
// out[order[j]], so no scatter pass follows. The TPU kernel's `group` and
// `n_slots` (its DMA pipeline over a sequential grid) do not carry over.
#include "maxsim_pairs.cuh"

namespace vrt {

template <typename T, typename Q, int TQ>
__global__ void __launch_bounds__(THREADS)
dedup_kernel(const T* __restrict__ flat, const int* __restrict__ offsets,
             const int* __restrict__ lengths, const float* __restrict__ doc_scales,
             int64_t n_docs, const Q* __restrict__ queries, const float* __restrict__ qmask,
             int nq, int nq_pad, int dim, int k, const int* __restrict__ sorted_ids,
             const int* __restrict__ order, const int* __restrict__ starts, int total,
             float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s = starts[blockIdx.x];
  if (s >= total) return;  // past the last run
  const int e = starts[blockIdx.x + 1];
  const int c = sorted_ids[s];
  const int len = (c >= 0 && c < n_docs) ? lengths[c] : 0;
  if (len <= 0) return;  // the wrapper's NEG_INF stays
  const PairSmem sm = carve_pair_smem<T, TQ>(smem, dim, nq_pad);
  const T* doc = flat + static_cast<size_t>(offsets[c]) * dim;
  const float sc = doc_scales ? doc_scales[c] : 1.f;
  int loaded = -1;
  for (int g0 = s; g0 < e; g0 += GROUP) {  // one pass: runs hold <= GROUP pairs
    const int n = min(GROUP, e - g0);
    __syncthreads();  // the last group's fold is done with the metadata
    if (threadIdx.x < n) {
      const int o = order[g0 + threadIdx.x];
      sm.qid[threadIdx.x] = o / k;
      sm.lo[threadIdx.x] = 0;
      sm.hi[threadIdx.x] = len;
      sm.out[threadIdx.x] = o;
      sm.scale[threadIdx.x] = sc;
    }
    __syncthreads();
    score_pair_group<T, Q, TQ>(doc, dim, n, queries, qmask, nq, nq_pad, sm, loaded, out);
  }
}

struct DedupLaunch {
  const void* flat;
  const int* offsets;
  const int* lengths;
  const float* doc_scales;
  int64_t n_docs;
  const void* queries;
  const float* qmask;
  int nq, dim, k;
  const int* sorted_ids;
  const int* order;
  const int* starts;
  int n_blocks, total;
  float* out;
  cudaStream_t stream;

  template <typename T, typename Q, int TQ>
  cudaError_t run() const {
    const int nq_pad = (nq + TQ - 1) / TQ * TQ;
    const size_t smem = pair_smem_bytes<T, TQ>(dim, nq_pad);
    auto kernel = dedup_kernel<T, Q, TQ>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<n_blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(flat), offsets, lengths, doc_scales, n_docs,
        static_cast<const Q*>(queries), qmask, nq, nq_pad, dim, k, sorted_ids, order, starts,
        total, out);
    return cudaGetLastError();
  }
};

}  // namespace vrt

// device: the CUDA device of every pointer and of the stream. dtype,
// qdtype: the dtype codes of flat and queries (maxsim_common.cuh dtype_pair;
// no qdot body). doc_scales may be null (scale 1). sorted_ids, order [b * k]
// and starts [n_blocks + 1] are dedup_layout's; out [b * k] f32 holds
// NEG_INF on entry, and the kernel writes every pair of a doc with rows.
// Returns the cudaError_t of the launch.
extern "C" int vrt_rerank_candidates_dedup(int device, const void* flat, int dtype,
                                           const void* offsets, const void* lengths,
                                           const void* doc_scales, int64_t n_docs,
                                           const void* queries, int qdtype, const void* qmask,
                                           int b, int nq, int dim, int k,
                                           const void* sorted_ids, const void* order,
                                           const void* starts, int n_blocks, void* out,
                                           void* stream) {
  if (b == 0 || k == 0 || n_blocks == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const vrt::DedupLaunch launch{
      flat, static_cast<const int*>(offsets), static_cast<const int*>(lengths),
      static_cast<const float*>(doc_scales), n_docs, queries, static_cast<const float*>(qmask),
      nq, dim, k, static_cast<const int*>(sorted_ids), static_cast<const int*>(order),
      static_cast<const int*>(starts), n_blocks, b * k, static_cast<float*>(out),
      static_cast<cudaStream_t>(stream)};
  return static_cast<int>(vrt::dispatch_pair_kernel(dtype, qdtype, vrt::tile_rows(nq), launch));
}
