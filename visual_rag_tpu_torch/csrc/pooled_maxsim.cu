// Tokens-vs-pooled stage-1: every query token row against every doc's pooled
// rows, the max over the pooled rows, summed per query.
//
// Replaces three TPU kernels of visual_rag_tpu/ops/kernels/prefetch_topk.py
// that compute one function and differ only in how the TPU grid walks the
// queries: pooled_maxsim_scores_packed (K5, pallas_call :212),
// pooled_maxsim_scores_qbatch (K6, :314) and pooled_maxsim_scores (K7, :358);
// and the f32-sims form of the A/B prototype
// scripts/tpu_tokens_kernel_ab.py::main.make_fused (K8, :114), which became
// K5's body. The wrappers in ops/kernels/prefetch_topk.py map the padded
// wire (K6, K7) onto this kernel's packed form with one query per group.
//
// Semantics (prefetch_topk.py:120-167, the XLA fallback sharded.py:533-573).
// vals is P-leading [P, D, dim], mask [P, D], scales [P, D] f32 or null,
// q [G * Rg, dim] in the store dtype (bf16 for int8 codes), or int8 query
// codes against int8 store codes for the qdot body, qid [G, Rg] the
// in-group owner of each row (-1 = pad row), w [G * Rg] f32 row weights:
//   per_row[m, d] = max over p with mask[p, d] of scales[p, d] * (q[m] . vals[p, d]),
//                   and 0 where doc d has NO valid pooled row (not NEG_INF:
//                   stage-1 differs from the MaxSim kernels here, as in JAX);
//   out[g * gq + j, d] = sum over rows r of group g with qid[g, r] == j of
//                        w[g * Rg + r] * per_row[g * Rg + r, d].
// Products are exact (store values and queries widened to f32) and sums are
// f32, as on the TPU's MXU. The qdot body -- K5's qdot_int8 path
// (prefetch_topk.py:141-149, :195-207) and the function of the A/B prototype
// scripts/tpu_tokens_qdot_ab.py::main.make_v2 (K9, pallas_call :143) --
// sums int8 x int8 products in int32 with __dp4a (exact), converts each dot
// to f32 once and scales it by scales[p, d]; the wrapper folds each row's
// query scale into w. per_row is finite wherever it is weighted, so
// NEG_INF * 0 never happens.
//
// What bounds it on the H100: arithmetic. Every (query row, pooled row) pair
// is a 128-long dot: at the 100k serving shape (bs 1024, ~16k query rows in
// ~20k packed rows, P = 12, 100k docs) that is 5-6 TFLOP per batch against ~0.3 GB of bf16
// store, thousands of FLOPs per byte. This version runs on the f32 FMA units
// (67 TFLOP/s peak), and the qdot body on __dp4a (four int8 products an
// instruction); tensor cores are later work.
//
// Design: one block per (query group g, tile of BD = 64 docs) -- the group
// index is the fast grid axis, so the blocks that read one doc tile run
// together and can share it through the L2 cache. The block walks
// the group's rows in chunks of BM = 16 * RM rows staged in shared memory as
// f32, or as int8 codes packed four to a 32-bit word for qdot (chunks of pad
// rows only are skipped). For each chunk it walks p over the P pooled rows:
// the [BD, dim] slice vals[p, tile] is staged in shared memory the same
// way, and each of the 256 threads computes an RM x 4 register tile of dots
// (RM query rows x 4 docs), folding it into a running max kept in registers
// (qdot: RM x 4 int32 sums of __dp4a over 16-byte words, a quarter of the
// shared-memory loads of the f32 body). The doc tile never sits in shared
// memory whole, so P is not bounded (P = 76 needs no more memory than
// P = 4). After the P loop the
// chunk's per-row maxima go to shared memory and one thread per doc adds
// them into per-query sums in row order: no float atomics, so two calls
// give bit-equal scores.
#include "maxsim_common.cuh"

namespace vrt {

constexpr int PM_THREADS = 256;
constexpr int PM_TX = 16;                  // thread columns (docs)
constexpr int PM_TY = PM_THREADS / PM_TX;  // thread rows (query rows)
constexpr int PM_RD = 4;                   // docs per thread
constexpr int PM_BD = PM_TX * PM_RD;       // docs per block
constexpr int PM_PAD = 4;                  // floats of padding per shared row (banks)

// Floats of the region that holds a [BD, ld] doc slice, then [BM, BD] maxima.
__host__ __device__ inline int pooled_v_floats(int bm, int ld) {
  return PM_BD * ld > bm * PM_BD ? PM_BD * ld : bm * PM_BD;
}

// Words of one staged row: dim f32, or dim / 4 words of int8 codes (qdot),
// plus padding.
__host__ __device__ inline int pooled_ld(int dim, bool qdot) {
  return (qdot ? dim / 4 : dim) + PM_PAD;
}

// Shared memory of one block, in 4-byte words; the wrapper computes the same sum.
__host__ inline int pooled_smem_floats(int rm, int dim, int gq, bool qdot) {
  const int bm = PM_TY * rm, ld = pooled_ld(dim, qdot);
  return bm * ld + pooled_v_floats(bm, ld) + gq * PM_BD + 2 * bm + 3 * PM_BD;
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// rows [0, BM or BD) of a source with `dim` elements a row -> shared memory
// at `ld` words a row: f32 values, or for qdot the int8 codes as they are
// (16 bytes a copy); rows at or beyond `valid` are zero.
template <typename S, bool QDOT>
__device__ __forceinline__ void stage_rows(float* dst, const S* src, int rows, int valid,
                                           int dim, int ld) {
  if constexpr (QDOT) {
    const int vecs = dim / 16;
    for (int i = threadIdx.x; i < rows * vecs; i += PM_THREADS) {
      const int r = i / vecs, c = i % vecs;
      const int4 v = r < valid
          ? reinterpret_cast<const int4*>(src + static_cast<size_t>(r) * dim)[c]
          : make_int4(0, 0, 0, 0);
      reinterpret_cast<int4*>(dst + r * ld)[c] = v;
    }
  } else {
    const int vecs = dim / 8;
    for (int i = threadIdx.x; i < rows * vecs; i += PM_THREADS) {
      const int r = i / vecs, c = (i % vecs) * 8;
      float v[8];
      if (r < valid) {
        load8(src + static_cast<size_t>(r) * dim + c, v);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.f;
      }
      store8(dst + r * ld + c, v);
    }
  }
}

// acc[i][j] = dot(query row ty + 16 i, doc tx + 16 j) over the staged rows.
template <int RM, bool QDOT>
__device__ __forceinline__ void tile_dots(const float* q_s, const float* v_s, int dim, int ld,
                                          int tx, int ty, float (&acc)[RM][PM_RD]) {
  if constexpr (QDOT) {
    const int* qw = reinterpret_cast<const int*>(q_s);
    const int* vw = reinterpret_cast<const int*>(v_s);
    int iacc[RM][PM_RD];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < PM_RD; ++j) iacc[i][j] = 0;
    for (int k = 0; k < dim / 4; k += 4) {
      int4 b[PM_RD];
#pragma unroll
      for (int j = 0; j < PM_RD; ++j)
        b[j] = *reinterpret_cast<const int4*>(vw + (tx + PM_TX * j) * ld + k);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int4 a = *reinterpret_cast<const int4*>(qw + (ty + PM_TY * i) * ld + k);
#pragma unroll
        for (int j = 0; j < PM_RD; ++j) {
          int x = iacc[i][j];
          x = __dp4a(a.x, b[j].x, x);
          x = __dp4a(a.y, b[j].y, x);
          x = __dp4a(a.z, b[j].z, x);
          iacc[i][j] = __dp4a(a.w, b[j].w, x);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < PM_RD; ++j) acc[i][j] = static_cast<float>(iacc[i][j]);
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < PM_RD; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < dim; k += 4) {
      float4 b[PM_RD];
#pragma unroll
      for (int j = 0; j < PM_RD; ++j)
        b[j] = *reinterpret_cast<const float4*>(v_s + (tx + PM_TX * j) * ld + k);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(q_s + (ty + PM_TY * i) * ld + k);
#pragma unroll
        for (int j = 0; j < PM_RD; ++j) acc[i][j] = dot4(a, b[j], acc[i][j]);
      }
    }
  }
}

// T: the store's element type; Q: the queries' (Q = int8_t is the qdot body).
template <typename T, typename Q, int RM>
__global__ void __launch_bounds__(PM_THREADS, 2)  // two blocks an SM: <= 128 registers
pooled_kernel(const T* __restrict__ vals, const unsigned char* __restrict__ mask,
              const float* __restrict__ scales, int p_rows, int n_docs,
              const Q* __restrict__ q, const int* __restrict__ qid,
              const float* __restrict__ w, int rg, int gq, int dim,
              float* __restrict__ out) {
  constexpr int BM = PM_TY * RM;
  constexpr bool QDOT = std::is_same<Q, int8_t>::value;
  const int ld = pooled_ld(dim, QDOT);
  extern __shared__ float smem[];
  float* q_s = smem;                                   // [BM, ld]
  float* v_s = q_s + BM * ld;                          // [BD, ld]; then [BM, BD] maxima
  float* acc_s = v_s + pooled_v_floats(BM, ld);        // [gq, BD]
  float* w_s = acc_s + gq * PM_BD;                     // [BM]
  int* qid_s = reinterpret_cast<int*>(w_s + BM);       // [BM]
  float* sc_s = reinterpret_cast<float*>(qid_s + BM);  // [BD] scales of pooled row p
  int* msk_s = reinterpret_cast<int*>(sc_s + PM_BD);   // [BD] mask of pooled row p
  int* has_s = msk_s + PM_BD;                          // [BD] doc has a valid row

  const int g = blockIdx.x, d0 = blockIdx.y * PM_BD;
  const int tid = threadIdx.x, tx = tid % PM_TX, ty = tid / PM_TX;
  const int* qid_g = qid + static_cast<size_t>(g) * rg;
  const float* w_g = w + static_cast<size_t>(g) * rg;
  const Q* q_g = q + static_cast<size_t>(g) * rg * dim;

  for (int i = tid; i < gq * PM_BD; i += PM_THREADS) acc_s[i] = 0.f;
  if (tid < PM_BD) {
    int h = 0;
    if (d0 + tid < n_docs)
      for (int p = 0; p < p_rows; ++p) h |= mask[static_cast<size_t>(p) * n_docs + d0 + tid];
    has_s[tid] = h;
  }

  for (int r0 = 0; r0 < rg; r0 += BM) {
    // also orders the previous chunk's reads of q_s and v_s before the writes below
    if (!__syncthreads_or(tid < BM && r0 + tid < rg && qid_g[r0 + tid] >= 0)) continue;
    stage_rows<Q, QDOT>(q_s, q_g + static_cast<size_t>(r0) * dim, BM, rg - r0, dim, ld);
    if (tid < BM) {
      const bool ok = r0 + tid < rg;
      qid_s[tid] = ok ? qid_g[r0 + tid] : -1;
      w_s[tid] = ok ? w_g[r0 + tid] : 0.f;
    }

    float run[RM][PM_RD];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < PM_RD; ++j) run[i][j] = NEG_INF;

    for (int p = 0; p < p_rows; ++p) {
      __syncthreads();  // the previous p's reads of v_s are done
      stage_rows<T, QDOT>(v_s, vals + (static_cast<size_t>(p) * n_docs + d0) * dim, PM_BD,
                          n_docs - d0, dim, ld);
      if (tid < PM_BD) {
        const size_t at = static_cast<size_t>(p) * n_docs + d0 + tid;
        const bool ok = d0 + tid < n_docs;
        msk_s[tid] = ok ? mask[at] : 0;
        sc_s[tid] = (ok && scales) ? scales[at] : 1.f;
      }
      __syncthreads();

      float acc[RM][PM_RD];
      tile_dots<RM, QDOT>(q_s, v_s, dim, ld, tx, ty, acc);
#pragma unroll
      for (int j = 0; j < PM_RD; ++j) {
        const int c = tx + PM_TX * j;
        if (msk_s[c]) {
          const float s = sc_s[c];
#pragma unroll
          for (int i = 0; i < RM; ++i) run[i][j] = fmaxf(run[i][j], acc[i][j] * s);
        }
      }
    }

    __syncthreads();  // every read of v_s is done: it now holds the maxima
    float* rowmax_s = v_s;  // [BM, BD]
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < PM_RD; ++j) {
        const int c = tx + PM_TX * j;
        rowmax_s[(ty + PM_TY * i) * PM_BD + c] = has_s[c] ? run[i][j] : 0.f;
      }
    __syncthreads();
    if (tid < PM_BD) {
      for (int r = 0; r < BM; ++r) {
        const int j = qid_s[r];
        if (j >= 0 && j < gq) acc_s[j * PM_BD + tid] += w_s[r] * rowmax_s[r * PM_BD + tid];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < gq * PM_BD; i += PM_THREADS) {
    const int j = i / PM_BD, d = d0 + i % PM_BD;
    if (d < n_docs) out[(static_cast<size_t>(g) * gq + j) * n_docs + d] = acc_s[i];
  }
}

template <typename T, typename Q, int RM>
cudaError_t launch_pooled(const void* vals, const unsigned char* mask, const float* scales,
                          int p_rows, int n_docs, const void* q, int g, int rg, int gq,
                          int dim, const int* qid, const float* w, float* out,
                          cudaStream_t stream) {
  constexpr bool QDOT = std::is_same<Q, int8_t>::value;
  const size_t smem = sizeof(float) * pooled_smem_floats(RM, dim, gq, QDOT);
  auto kernel = pooled_kernel<T, Q, RM>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g, (n_docs + PM_BD - 1) / PM_BD), PM_THREADS, smem, stream>>>(
      static_cast<const T*>(vals), mask, scales, p_rows, n_docs, static_cast<const Q*>(q),
      qid, w, rg, gq, dim, out);
  return cudaGetLastError();
}

template <typename T, typename Q>
cudaError_t dispatch_pooled(int rm, const void* vals, const unsigned char* mask,
                            const float* scales, int p_rows, int n_docs, const void* q,
                            int g, int rg, int gq, int dim, const int* qid, const float* w,
                            float* out, cudaStream_t s) {
  switch (rm) {
    case 1: return launch_pooled<T, Q, 1>(vals, mask, scales, p_rows, n_docs, q, g, rg, gq, dim, qid, w, out, s);
    case 2: return launch_pooled<T, Q, 2>(vals, mask, scales, p_rows, n_docs, q, g, rg, gq, dim, qid, w, out, s);
    case 4: return launch_pooled<T, Q, 4>(vals, mask, scales, p_rows, n_docs, q, g, rg, gq, dim, qid, w, out, s);
    default: return launch_pooled<T, Q, 8>(vals, mask, scales, p_rows, n_docs, q, g, rg, gq, dim, qid, w, out, s);
  }
}

}  // namespace vrt

// device: the CUDA device of every pointer and of the stream.
// dtype, qdtype: the dtype codes of vals and q (maxsim_common.cuh
// dtype_pair; qdtype 3 with dtype 3 is the qdot body, which needs
// dim % 16 == 0; the others need dim % 8 == 0).
// rm: query rows per thread (1, 2, 4 or 8; the wrapper picks it from rg).
// mask is [p_rows, n_docs] bool (one byte each); scales may be null (1).
// out is [g * gq, n_docs] f32. Returns the cudaError_t of the launch.
extern "C" int vrt_pooled_maxsim_scores_packed(int device, const void* vals, int dtype,
                                               const void* mask, const void* scales,
                                               int p_rows, int n_docs, const void* q,
                                               int qdtype, int g, int rg, int gq, int dim,
                                               int rm, const void* qid, const void* w,
                                               void* out, void* stream) {
  if (n_docs == 0 || g == 0 || gq == 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto s = static_cast<cudaStream_t>(stream);
  auto m = static_cast<const unsigned char*>(mask);
  auto sc = static_cast<const float*>(scales);
  auto qi = static_cast<const int*>(qid);
  auto wt = static_cast<const float*>(w);
  auto o = static_cast<float*>(out);
  switch (vrt::dtype_pair(dtype, qdtype)) {
    case vrt::kF32: return vrt::dispatch_pooled<float, float>(rm, vals, m, sc, p_rows, n_docs, q, g, rg, gq, dim, qi, wt, o, s);
    case vrt::kBF16: return vrt::dispatch_pooled<__nv_bfloat16, __nv_bfloat16>(rm, vals, m, sc, p_rows, n_docs, q, g, rg, gq, dim, qi, wt, o, s);
    case vrt::kF16: return vrt::dispatch_pooled<__half, __half>(rm, vals, m, sc, p_rows, n_docs, q, g, rg, gq, dim, qi, wt, o, s);
    case vrt::kInt8Bf16: return vrt::dispatch_pooled<int8_t, __nv_bfloat16>(rm, vals, m, sc, p_rows, n_docs, q, g, rg, gq, dim, qi, wt, o, s);
    case vrt::kInt8Qdot:
      if (dim % 16) return static_cast<int>(cudaErrorInvalidValue);
      return vrt::dispatch_pooled<int8_t, int8_t>(rm, vals, m, sc, p_rows, n_docs, q, g, rg, gq, dim, qi, wt, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
