// Exhaustive MaxSim scan: every packed query against every doc.
//
// Replaces the TPU kernel visual_rag_tpu/ops/kernels/maxsim_scan.py::
// exhaustive_scores_packed (_make_kernel :87, pallas_call :240), both of its
// bodies. Semantics, as there: queries arrive group-packed (retrieval/wire.py
// pack_queries_grouped): qpacked [G * Rg, dim] and qid [G, Rg], the
// in-group owner of each row (-1 on pad rows). For doc d and query
// b = g * gq + j,
//   out[b, d] = sum over rows r of group g with qid[g, r] == j of
//               w[r] * (max_{i < len[d]} qpacked[g * Rg + r] . flat[off[d] + i]) * scale[d]
// and NEG_INF for every b where len[d] == 0. w is 1 unless given: the qdot
// body (int8 query codes against int8 store codes, :131-139) passes each
// row's query scale there, which commutes with the max (:155-156); the
// per-doc scale multiplies each row max before the sum (:148).
//
// What bounds it on the H100: arithmetic. The scan is a [M, dim] x
// [dim, rows] product over the whole store (M = packed query rows), about
// 2 * M * dim operations per stored row -- thousands a byte -- so the f32
// FMA rate of the CUDA cores is the limit of the float body, and the
// __dp4a rate (4 int8 products an instruction) that of the qdot body.
//
// Design: one block per (doc d, group g). The block walks the group's rows
// in tiles of TQ (<= 32) query rows staged in shared memory (f32, or int8
// codes packed 4 to a word for qdot), skips tiles that hold only pad rows,
// and gets each tile's per-row maxima from tile_rowmax[_qdot] over the
// doc's rows [off, off + len) only (the TPU kernel's fixed ceil32(max_len)
// window does not carry over). One thread adds each row's maximum into its
// owner's sum, in row order. So the per-query sum is deterministic -- no
// float atomics -- which the strict oracle needs: two_stage(prefetch >=
// corpus) and single_full both go through this kernel and must give
// bit-equal scores.
#include "maxsim_common.cuh"

namespace vrt {

// T: the store's element type; Q: the queries' (Q = int8_t is the qdot body).
template <typename T, typename Q, int TQ>
__global__ void __launch_bounds__(THREADS)
scan_kernel(const T* __restrict__ flat, const int* __restrict__ offsets,
            const int* __restrict__ lengths, const float* __restrict__ doc_scales,
            int n_docs, const Q* __restrict__ qpacked, const float* __restrict__ w,
            const int* __restrict__ qid, int rg, int gq, int dim, float* __restrict__ out) {
  constexpr bool QDOT = std::is_same<Q, int8_t>::value;
  extern __shared__ float smem[];
  float* q_s = smem;                      // [TQ, dim]
  float* red_s = q_s + TQ * dim;          // [NWARPS, TQ]
  float* rowmax_s = red_s + NWARPS * TQ;  // [TQ]
  float* acc_s = rowmax_s + TQ;           // [gq]
  const int d = blockIdx.x, g = blockIdx.y;
  float* out_col = out + static_cast<size_t>(g) * gq * n_docs + d;  // out[g*gq + j, d]
  const int len = lengths[d];
  if (len <= 0) {
    for (int j = threadIdx.x; j < gq; j += THREADS) out_col[static_cast<size_t>(j) * n_docs] = NEG_INF;
    return;
  }
  const T* doc = flat + static_cast<size_t>(offsets[d]) * dim;
  const float sc = doc_scales ? doc_scales[d] : 1.f;
  const int* qid_g = qid + static_cast<size_t>(g) * rg;
  const float* w_g = w ? w + static_cast<size_t>(g) * rg : nullptr;
  const Q* q_g = qpacked + static_cast<size_t>(g) * rg * dim;
  for (int j = threadIdx.x; j < gq; j += THREADS) acc_s[j] = 0.f;
  for (int r0 = 0; r0 < rg; r0 += TQ) {
    const int t = threadIdx.x;
    // also orders the previous tile's reads of q_s before this tile's writes
    if (!__syncthreads_or(t < TQ && r0 + t < rg && qid_g[r0 + t] >= 0)) continue;
    if constexpr (QDOT) {  // the tile's codes as int32 words, 4 codes each
      const int dw = dim / 4;
      int* q_w = reinterpret_cast<int*>(q_s);
      const int* src = reinterpret_cast<const int*>(q_g + static_cast<size_t>(r0) * dim);
      for (int i = t; i < TQ * dw; i += THREADS) q_w[i] = (r0 + i / dw < rg) ? src[i] : 0;
      __syncthreads();
      tile_rowmax_qdot<TQ>(q_w, dim, reinterpret_cast<const int8_t*>(doc), len, red_s,
                           rowmax_s);
    } else {
      for (int i = t; i < TQ * dim; i += THREADS)
        q_s[i] = (r0 + i / dim < rg) ? to_float(q_g[static_cast<size_t>(r0) * dim + i]) : 0.f;
      __syncthreads();
      tile_rowmax<T, TQ>(q_s, dim, doc, len, red_s, rowmax_s);
    }
    if (t == 0) {
      for (int r = 0; r < TQ && r0 + r < rg; ++r) {
        const int j = qid_g[r0 + r];
        const float x = rowmax_s[r] * sc;
        if (j >= 0 && j < gq) acc_s[j] += w_g ? w_g[r0 + r] * x : x;
      }
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < gq; j += THREADS) out_col[static_cast<size_t>(j) * n_docs] = acc_s[j];
}

template <typename T, typename Q, int TQ>
cudaError_t launch_scan(const void* flat, const int* offsets, const int* lengths,
                        int n_docs, const float* doc_scales, const void* qpacked,
                        const float* w, int g, int rg, int gq, int dim, const int* qid,
                        float* out, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(TQ) * dim + NWARPS * TQ + TQ + gq);
  auto kernel = scan_kernel<T, Q, TQ>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_docs, g), THREADS, smem, stream>>>(
      static_cast<const T*>(flat), offsets, lengths, doc_scales, n_docs,
      static_cast<const Q*>(qpacked), w, qid, rg, gq, dim, out);
  return cudaGetLastError();
}

template <typename T, typename Q>
cudaError_t dispatch_scan(int tq, const void* flat, const int* offsets, const int* lengths,
                          int n_docs, const float* doc_scales, const void* qpacked,
                          const float* w, int g, int rg, int gq, int dim, const int* qid,
                          float* out, cudaStream_t s) {
  switch (tq) {
    case 8: return launch_scan<T, Q, 8>(flat, offsets, lengths, n_docs, doc_scales, qpacked, w, g, rg, gq, dim, qid, out, s);
    case 16: return launch_scan<T, Q, 16>(flat, offsets, lengths, n_docs, doc_scales, qpacked, w, g, rg, gq, dim, qid, out, s);
    case 24: return launch_scan<T, Q, 24>(flat, offsets, lengths, n_docs, doc_scales, qpacked, w, g, rg, gq, dim, qid, out, s);
    default: return launch_scan<T, Q, 32>(flat, offsets, lengths, n_docs, doc_scales, qpacked, w, g, rg, gq, dim, qid, out, s);
  }
}

}  // namespace vrt

// device: the CUDA device of every pointer and of the stream.
// dtype, qdtype: the dtype codes of flat and qpacked (maxsim_common.cuh
// dtype_pair; qdtype 3 with dtype 3 is the qdot body, which needs
// dim % 16 == 0). doc_scales and w may be null (1). out is [g * gq, n_docs]
// f32. Returns the cudaError_t of the launch.
extern "C" int vrt_exhaustive_scores_packed(int device, const void* flat, int dtype, const void* offsets,
                                            const void* lengths, int n_docs,
                                            const void* doc_scales, const void* qpacked,
                                            int qdtype, const void* w, int g, int rg, int gq,
                                            int dim, const void* qid, void* out, void* stream) {
  if (n_docs == 0 || g == 0 || gq == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int tq = vrt::tile_rows(rg);
  auto s = static_cast<cudaStream_t>(stream);
  auto off = static_cast<const int*>(offsets);
  auto len = static_cast<const int*>(lengths);
  auto sc = static_cast<const float*>(doc_scales);
  auto wt = static_cast<const float*>(w);
  auto q = static_cast<const int*>(qid);
  auto o = static_cast<float*>(out);
  switch (vrt::dtype_pair(dtype, qdtype)) {
    case vrt::kF32: return vrt::dispatch_scan<float, float>(tq, flat, off, len, n_docs, sc, qpacked, wt, g, rg, gq, dim, q, o, s);
    case vrt::kBF16: return vrt::dispatch_scan<__nv_bfloat16, __nv_bfloat16>(tq, flat, off, len, n_docs, sc, qpacked, wt, g, rg, gq, dim, q, o, s);
    case vrt::kF16: return vrt::dispatch_scan<__half, __half>(tq, flat, off, len, n_docs, sc, qpacked, wt, g, rg, gq, dim, q, o, s);
    case vrt::kInt8Bf16: return vrt::dispatch_scan<int8_t, __nv_bfloat16>(tq, flat, off, len, n_docs, sc, qpacked, wt, g, rg, gq, dim, q, o, s);
    case vrt::kInt8Qdot:
      if (dim % 16) return static_cast<int>(cudaErrorInvalidValue);
      return vrt::dispatch_scan<int8_t, int8_t>(tq, flat, off, len, n_docs, sc, qpacked, wt, g, rg, gq, dim, q, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
