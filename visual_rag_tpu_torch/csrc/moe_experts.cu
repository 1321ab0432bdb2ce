// K11: the routed experts of a sigmoid-routed MoE layer (Kimi-VL's, DeepSeek-V3's),
// grouped by expert, in bf16 on the tensor cores.
//
// Replaces no TPU kernel: the JAX package's only expert layer is its softmax MoE
// with a capacity (visual_rag_tpu/models/moe.py), which the port refuses. This one
// runs every token's top_k experts, none dropped. Its function, for each token t
// with chosen experts e_j and router weights w_j (j < top_k):
//
//   out[t] = base[t] + sum_j w_j * down_{e_j}( silu(gate_{e_j} x[t]) * up_{e_j} x[t] )
//
// base is the shared experts' output (or 0). The (token, expert) pairs come sorted
// by expert (ops/kernels/moe_experts.py::expert_layout, on the device): row p of the
// sorted layout is token tokens[p]; expert e owns rows offsets[e] .. offsets[e+1]
// and tiles tile_starts[e] .. tile_starts[e+1] of MOE_BM rows (its rows padded to
// whole tiles); slots[t * top_k + j] is the row of pair (t, j). Nothing is read
// back to the host: the grid covers the most tiles the layout can hold
// (ceil(rows / MOE_BM) + experts) and the blocks past the last tile return.
//
// Three launches on the caller's stream:
// 1. moe_gemm_kernel<2>: for each tile of an expert's rows and each 64 columns of the
//    expert width, the gate and the up products in one pass over x's rows (gathered
//    by token through tokens[]), and in the epilogue h = silu(g) * u, stored bf16 in
//    the sorted layout [rows, width].
// 2. moe_gemm_kernel<1>: y = h down_e^T for each tile and 128 columns of hidden,
//    stored bf16 [rows, hidden].
// 3. moe_combine_kernel: out[t] = base[t] + sum_j w_j y[slots[t, j]], in f32 in slot
//    order (fmaf), stored bf16. A fixed order, so the call is deterministic (an
//    atomic scatter-add would not be), at the cost of y's round trip.
//
// What bounds it on the H100: arithmetic. At Kimi-VL's widths (hidden 2048, width
// 1408, 64 experts, top 6) a batch of 8 pages (~8,700 rows of text) sends ~52,000
// pairs through 2 x 3 x 2048 x 1408 flops each, ~0.9 TFLOP a layer, against ~1.1 GB
// of expert weights and ~0.5 GB of h and y: ~0.9 ms at the bf16 peak against
// ~0.5 ms at 3.35 TB/s. So the products run on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 sums), fed by a three-stage cp.async ring; wgmma and TMA are later
// work.
//
// Design of moe_gemm_kernel<NMAT> (NMAT 2: gate and up; 1: down), 128 threads as 2 x 2
// warps over a 64-row tile and 128 columns (NMAT 2: 64 of gate and the same 64 of
// up, so the epilogue holds both): warp (wm, wn) owns rows 32 wm .. 32 wm + 31 and,
// in each matrix, 64 / NMAT columns from wn * 64 / NMAT; its sums are
// 2 (m16) x 8 / NMAT (n8) x NMAT fragments of 4 f32, 64 registers either way. A
// stage holds the tile's A rows [64][32] and the B rows [128][32] in bf16, rows of
// MOE_LDS = 40 elements (80 bytes: the 8 rows an ldmatrix reads fall on distinct
// banks); three stages, 46,080 bytes, plus the tile's 64 row sources, within the
// 48 KB a block may take without an opt-in, four blocks an SM. The A rows of an
// expert's last, part-full tile past its rows are zero-filled by cp.async (src-size
// 0) and their results not stored. Each block finds its expert by a binary search
// of tile_starts (experts with no rows have no tiles and are never found).
// Requires hidden % 128 == 0 and width % 64 == 0 (both multiples of MOE_BK).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "mma_tiles.cuh"

namespace vrt {

constexpr int MOE_BM = 64;
constexpr int MOE_BN = 128;
constexpr int MOE_BK = 32;
constexpr int MOE_LDS = MOE_BK + 8;
constexpr int MOE_STAGES = 3;
constexpr int MOE_THREADS = 128;
constexpr int MOE_STAGE_ELEMS = (MOE_BM + MOE_BN) * MOE_LDS;
constexpr int MOE_SMEM = MOE_STAGES * MOE_STAGE_ELEMS * 2 + MOE_BM * 4;
constexpr int MOE_COMBINE_THREADS = 256;

__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

template <int NMAT>
__global__ void __launch_bounds__(MOE_THREADS)
    moe_gemm_kernel(const __nv_bfloat16* __restrict__ a, const int* __restrict__ a_rows,
                    const __nv_bfloat16* __restrict__ b0, const __nv_bfloat16* __restrict__ b1,
                    const int* __restrict__ offsets, const int* __restrict__ tile_starts,
                    int experts, int n, int k, __nv_bfloat16* __restrict__ c) {
  constexpr int BN_MAT = MOE_BN / NMAT;  // columns of each matrix a block
  constexpr int WN = BN_MAT / 2;         // of them a warp
  constexpr int NJ = WN / 8;             // n8 fragments a warp and matrix
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem);
  int* src = reinterpret_cast<int*>(stage0 + MOE_STAGES * MOE_STAGE_ELEMS);

  const int tile = blockIdx.x;
  if (tile >= tile_starts[experts]) return;
  int lo = 0, hi = experts;  // tile_starts[lo] <= tile < tile_starts[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (tile_starts[mid] <= tile) lo = mid;
    else hi = mid;
  }
  const int e = lo;
  const int row0 = offsets[e] + (tile - tile_starts[e]) * MOE_BM;
  const int rows = min(MOE_BM, offsets[e + 1] - row0);
  const int n0 = blockIdx.y * BN_MAT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  if (tid < MOE_BM) src[tid] = tid < rows ? (a_rows ? a_rows[row0 + tid] : row0 + tid) : -1;
  __syncthreads();

  const size_t mat_elems = static_cast<size_t>(n) * k;
  const __nv_bfloat16* bw0 = b0 + static_cast<size_t>(e) * mat_elems;
  const __nv_bfloat16* bw1 = NMAT == 2 ? b1 + static_cast<size_t>(e) * mat_elems : bw0;

  // one stage's copies: A 64 rows x 4 chunks of 16 bytes, B 128 rows x 4 chunks
  auto load = [&](int stage, int kt) {
    __nv_bfloat16* sa = stage0 + stage * MOE_STAGE_ELEMS;
    __nv_bfloat16* sb = sa + MOE_BM * MOE_LDS;
    const int k0 = kt * MOE_BK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = tid + i * MOE_THREADS, r = ch >> 2, col = (ch & 3) * 8;
      const int s = src[r];
      cp_async_16(sa + r * MOE_LDS + col, a + static_cast<size_t>(s < 0 ? 0 : s) * k + k0 + col,
                  s >= 0);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ch = tid + i * MOE_THREADS, r = ch >> 2, col = (ch & 3) * 8;
      const __nv_bfloat16* w = (NMAT == 2 && r >= BN_MAT) ? bw1 : bw0;
      const int nr = n0 + (r % BN_MAT);
      cp_async_16(sb + r * MOE_LDS + col, w + static_cast<size_t>(nr) * k + k0 + col, true);
    }
  };

  float acc[NMAT][2][NJ][4];
#pragma unroll
  for (int m = 0; m < NMAT; ++m)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][mi][j][q] = 0.f;

  const int ktiles = k / MOE_BK;
#pragma unroll
  for (int s = 0; s < MOE_STAGES - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<MOE_STAGES - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1's stage
    const int nk = kt + MOE_STAGES - 1;
    if (nk < ktiles) load(nk % MOE_STAGES, nk);
    cp_async_commit();
    const __nv_bfloat16* sa = stage0 + (kt % MOE_STAGES) * MOE_STAGE_ELEMS;
    const __nv_bfloat16* sb = sa + MOE_BM * MOE_LDS;
#pragma unroll
    for (int ks = 0; ks < MOE_BK; ks += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(af[mi], sa + (wm * 32 + mi * 16 + (lane & 15)) * MOE_LDS + ks + (lane >> 4) * 8);
#pragma unroll
      for (int m = 0; m < NMAT; ++m) {
#pragma unroll
        for (int jj = 0; jj < NJ; jj += 2) {
          uint32_t bf[4];
          const int nrow = m * BN_MAT + wn * WN + jj * 8 + (lane & 7) + (lane >> 4) * 8;
          ldsm_x4(bf, sb + nrow * MOE_LDS + ks + ((lane >> 3) & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16_16816(acc[m][mi][jj], af[mi], bf[0], bf[1]);
            mma_bf16_16816(acc[m][mi][jj + 1], af[mi], bf[2], bf[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm * 32 + mi * 16 + g + half * 8;
      if (r >= rows) continue;
      __nv_bfloat16* out = c + static_cast<size_t>(row0 + r) * n + n0 + wn * WN + 2 * t4;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float v0 = acc[0][mi][j][2 * half], v1 = acc[0][mi][j][2 * half + 1];
        if (NMAT == 2) {
          v0 = silu(v0) * acc[NMAT - 1][mi][j][2 * half];
          v1 = silu(v1) * acc[NMAT - 1][mi][j][2 * half + 1];
        }
        *reinterpret_cast<__nv_bfloat162*>(out + j * 8) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// out[t] = base[t] + sum_j w[t, j] y[slots[t, j]], f32 in slot order; one block a token,
// two columns a thread and step.
__global__ void __launch_bounds__(MOE_COMBINE_THREADS)
    moe_combine_kernel(const __nv_bfloat16* __restrict__ y, const int* __restrict__ slots,
                       const float* __restrict__ w, const __nv_bfloat16* __restrict__ base,
                       int topk, int hidden, __nv_bfloat16* __restrict__ out) {
  const int t = blockIdx.x;
  const __nv_bfloat162* y2 = reinterpret_cast<const __nv_bfloat162*>(y);
  const __nv_bfloat162* base2 = reinterpret_cast<const __nv_bfloat162*>(base);
  __nv_bfloat162* out2 = reinterpret_cast<__nv_bfloat162*>(out);
  const int h2 = hidden / 2;
  for (int c = threadIdx.x; c < h2; c += MOE_COMBINE_THREADS) {
    float2 s = make_float2(0.f, 0.f);
    if (base) s = __bfloat1622float2(base2[static_cast<size_t>(t) * h2 + c]);
    for (int j = 0; j < topk; ++j) {
      const size_t pair = static_cast<size_t>(t) * topk + j;
      const float wj = w[pair];
      const float2 v = __bfloat1622float2(y2[static_cast<size_t>(slots[pair]) * h2 + c]);
      s.x = fmaf(wj, v.x, s.x);
      s.y = fmaf(wj, v.y, s.y);
    }
    out2[static_cast<size_t>(t) * h2 + c] = __floats2bfloat162_rn(s.x, s.y);
  }
}

}  // namespace vrt

// device: the CUDA device of every pointer and of the stream. x [t, hidden] bf16;
// gate, up [experts, inter, hidden], down [experts, hidden, inter] bf16; tokens
// [t * topk], offsets and tile_starts [experts + 1], slots [t, topk] int32 (the
// layout of ops/kernels/moe_experts.py::expert_layout); w [t, topk] f32; base
// [t, hidden] bf16 or null; h [t * topk, inter] and y [t * topk, hidden] bf16
// scratch; out [t, hidden] bf16. max_tiles bounds tile_starts[experts]. Returns the
// cudaError_t of the launches.
extern "C" int vrt_moe_experts(int device, const void* x, const void* gate, const void* up,
                               const void* down, const void* tokens, const void* offsets,
                               const void* tile_starts, const void* slots, const void* w,
                               const void* base, int t, int topk, int experts, int hidden,
                               int inter, int max_tiles, void* h, void* y, void* out,
                               void* stream) {
  using vrt::MOE_BN;
  if (t == 0) return 0;
  if (topk <= 0 || experts <= 0 || max_tiles <= 0 || hidden % MOE_BN || inter % (MOE_BN / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto s = static_cast<cudaStream_t>(stream);
  auto bf = [](const void* p) { return static_cast<const __nv_bfloat16*>(p); };
  auto i32 = [](const void* p) { return static_cast<const int*>(p); };
  auto gate_up = vrt::moe_gemm_kernel<2>;
  auto down_proj = vrt::moe_gemm_kernel<1>;
  auto combine = vrt::moe_combine_kernel;
  const dim3 grid_gate_up(max_tiles, inter / (MOE_BN / 2));
  const dim3 grid_down(max_tiles, hidden / MOE_BN);
  gate_up<<<grid_gate_up, vrt::MOE_THREADS, vrt::MOE_SMEM, s>>>(
      bf(x), i32(tokens), bf(gate), bf(up), i32(offsets), i32(tile_starts), experts, inter,
      hidden, static_cast<__nv_bfloat16*>(h));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  down_proj<<<grid_down, vrt::MOE_THREADS, vrt::MOE_SMEM, s>>>(
      bf(h), nullptr, bf(down), nullptr, i32(offsets), i32(tile_starts), experts, hidden, inter,
      static_cast<__nv_bfloat16*>(y));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  combine<<<t, vrt::MOE_COMBINE_THREADS, 0, s>>>(
      bf(y), i32(slots), static_cast<const float*>(w), bf(base), topk, hidden,
      static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
