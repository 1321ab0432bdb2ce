// Exact MaxSim rerank of each query against its own K candidate docs.
//
// Replaces the TPU kernel visual_rag_tpu/ops/kernels/maxsim_rerank.py::
// rerank_candidates (_make_kernel :35, pallas_call :163). Semantics, as
// there: for query b and candidate doc c = candidates[b, k],
//   out[b, k] = scale[c] * sum_t qmask[b, t] * max_{r < len[c]} q[b, t] . flat[off[c] + r]
// and NEG_INF where c == -1 or len[c] == 0. For an int8 store the codes are
// widened to f32 against bf16-rounded queries (:69, :171) and the per-doc
// scale multiplies the finished score (:89).
//
// What bounds it on the H100: arithmetic. Each (query, candidate) pair is
// a small [NQ, dim] x [dim, len] product (NQ ~ 24, len ~ 200-800), done
// here with f32 FMAs on the CUDA cores: about 2 * NQ * len * dim FLOPs for
// len * dim * 2 bytes of doc rows, some 24 FLOPs a byte, so the FMA rate
// (67 TFLOP/s f32 on an SXM part), not HBM, is the limit.
//
// Design: one block per (candidate k, query b). The whole query [NQ, dim]
// sits in shared memory as f32 (sized at run time; above 48 KB the wrapper's
// launch opts in to more). The block reads only the candidate's rows
// [off, off + len): the TPU kernel's fixed ceil32(max_len) DMA window does
// not carry over. The per-token maxima come from tile_rowmax (one thread
// per doc row, query values broadcast from shared memory) and one thread
// folds them with the qmask weights in token order, so scores are
// deterministic. Tensor-core versions (mma.sync / wgmma) are later work.
#include "maxsim_common.cuh"

namespace vrt {

// T: the store's element type; Q: the queries'.
template <typename T, typename Q, int TQ>
__global__ void __launch_bounds__(THREADS)
rerank_kernel(const T* __restrict__ flat, const int* __restrict__ offsets,
              const int* __restrict__ lengths, const float* __restrict__ doc_scales,
              int64_t n_docs, const Q* __restrict__ queries,
              const float* __restrict__ qmask, int nq, int nq_pad, int dim,
              const int* __restrict__ candidates, int k, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* q_s = smem;                      // [nq_pad, dim]
  float* red_s = q_s + nq_pad * dim;      // [NWARPS, TQ]
  float* rowmax_s = red_s + NWARPS * TQ;  // [TQ]
  const int kk = blockIdx.x, b = blockIdx.y;
  const size_t o = static_cast<size_t>(b) * k + kk;
  const int c = candidates[o];
  // out-of-range ids are treated as padding rather than read out of bounds
  const int len = (c >= 0 && c < n_docs) ? lengths[c] : 0;
  if (len <= 0) {
    if (threadIdx.x == 0) out[o] = NEG_INF;
    return;
  }
  const Q* qb = queries + static_cast<size_t>(b) * nq * dim;
  for (int i = threadIdx.x; i < nq_pad * dim; i += THREADS)
    q_s[i] = (i / dim < nq) ? to_float(qb[i]) : 0.f;
  __syncthreads();
  const T* doc = flat + static_cast<size_t>(offsets[c]) * dim;
  const float* qm = qmask + static_cast<size_t>(b) * nq;
  float score = 0.f;
  for (int t0 = 0; t0 < nq_pad; t0 += TQ) {
    tile_rowmax<T, TQ>(q_s + t0 * dim, dim, doc, len, red_s, rowmax_s);
    if (threadIdx.x == 0)  // the fold of maxsim_pairs.cuh, so K3/K4 give K2's bits
      for (int t = 0; t < TQ && t0 + t < nq; ++t) score = fmaf(qm[t0 + t], rowmax_s[t], score);
  }
  if (threadIdx.x == 0) out[o] = score * (doc_scales ? doc_scales[c] : 1.f);
}

template <typename T, typename Q, int TQ>
cudaError_t launch_rerank(const void* flat, const int* offsets, const int* lengths,
                          const float* doc_scales, int64_t n_docs, int b, int nq,
                          int dim, const void* queries, const float* qmask, int k,
                          const int* candidates, float* out, cudaStream_t stream) {
  const int nq_pad = (nq + TQ - 1) / TQ * TQ;
  const size_t smem = sizeof(float) * (static_cast<size_t>(nq_pad) * dim + NWARPS * TQ + TQ);
  auto kernel = rerank_kernel<T, Q, TQ>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(k, b), THREADS, smem, stream>>>(
      static_cast<const T*>(flat), offsets, lengths, doc_scales, n_docs,
      static_cast<const Q*>(queries), qmask, nq, nq_pad, dim, candidates, k, out);
  return cudaGetLastError();
}

template <typename T, typename Q>
cudaError_t dispatch_rerank(int tq, const void* flat, const int* offsets,
                            const int* lengths, const float* doc_scales, int64_t n_docs,
                            int b, int nq, int dim, const void* queries,
                            const float* qmask, int k, const int* candidates,
                            float* out, cudaStream_t s) {
  switch (tq) {
    case 8: return launch_rerank<T, Q, 8>(flat, offsets, lengths, doc_scales, n_docs, b, nq, dim, queries, qmask, k, candidates, out, s);
    case 16: return launch_rerank<T, Q, 16>(flat, offsets, lengths, doc_scales, n_docs, b, nq, dim, queries, qmask, k, candidates, out, s);
    case 24: return launch_rerank<T, Q, 24>(flat, offsets, lengths, doc_scales, n_docs, b, nq, dim, queries, qmask, k, candidates, out, s);
    default: return launch_rerank<T, Q, 32>(flat, offsets, lengths, doc_scales, n_docs, b, nq, dim, queries, qmask, k, candidates, out, s);
  }
}

}  // namespace vrt

// device: the CUDA device of every pointer and of the stream.
// dtype, qdtype: the dtype codes of flat and queries (maxsim_common.cuh
// dtype_pair; no qdot body here). doc_scales may be null (scale 1).
// Returns the cudaError_t of the launch.
extern "C" int vrt_rerank_candidates(int device, const void* flat, int dtype, const void* offsets,
                                     const void* lengths, const void* doc_scales, int b,
                                     int nq, int dim, const void* queries, int qdtype,
                                     const void* qmask, int k, int64_t n_docs,
                                     const void* candidates, void* out, void* stream) {
  if (b == 0 || k == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tq = vrt::tile_rows(nq);
  auto s = static_cast<cudaStream_t>(stream);
  auto off = static_cast<const int*>(offsets);
  auto len = static_cast<const int*>(lengths);
  auto sc = static_cast<const float*>(doc_scales);
  auto qm = static_cast<const float*>(qmask);
  auto cand = static_cast<const int*>(candidates);
  auto o = static_cast<float*>(out);
  switch (vrt::dtype_pair(dtype, qdtype)) {
    case vrt::kF32: return vrt::dispatch_rerank<float, float>(tq, flat, off, len, sc, n_docs, b, nq, dim, queries, qm, k, cand, o, s);
    case vrt::kBF16: return vrt::dispatch_rerank<__nv_bfloat16, __nv_bfloat16>(tq, flat, off, len, sc, n_docs, b, nq, dim, queries, qm, k, cand, o, s);
    case vrt::kF16: return vrt::dispatch_rerank<__half, __half>(tq, flat, off, len, sc, n_docs, b, nq, dim, queries, qm, k, cand, o, s);
    case vrt::kInt8Bf16: return vrt::dispatch_rerank<int8_t, __nv_bfloat16>(tq, flat, off, len, sc, n_docs, b, nq, dim, queries, qm, k, cand, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* vrt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
