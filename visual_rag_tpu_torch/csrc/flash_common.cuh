// What K10's forward (flash_attention.cu) and its backward, B4 and B5
// (flash_attention_bwd.cu), share: the block shape, the 16-byte row loads and
// stores of f32 (and bf16's 4-value store), strides, the launch, and the launcher
// of the segment-range kernel that both use for their exact tile skips.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vrt_fa {

constexpr int BQ = 64;            // query rows a block
constexpr int THREADS = 256;      // a block of every kernel but bf16 K10's (128)
constexpr int MAX_TILES = 16384;  // T <= 1,048,576 (in 64-row tiles): int offsets stay in range
// the head dims of every instance (K10's two forwards, B4 and B5): ColSmol-500M's
// two towers (64), ColPali's SigLIP tower (72) and its Gemma text model (256),
// ColQwen2.5's vision tower (80) and its Qwen2.5 text model (128)
constexpr bool is_head_dim(int dh) {
  return dh == 64 || dh == 72 || dh == 80 || dh == 128 || dh == 256;
}
// the longest sequence B4 and B5 take: their live-tile flags (a byte a tile) must
// fit beside Dh 256's tiles in the 227 KB of shared memory a block may have
constexpr int MAX_BWD_T = 524288;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;  // elements in 16 bytes
  __device__ static void load(const float* p, float* out) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  }
  __device__ static void store4(float* p, float a, float b, float c, float d) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  }
  __device__ static void store1(float* p, float a) { *p = a; }
};

// bf16 tiles go through flash_mma.cuh (cp.async); B4's reduction stores 4 values at once
template <>
struct Vec<__nv_bfloat16> {
  __device__ static void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

struct Strides {
  long long b, t, h;  // in elements; the head dim is contiguous
};

// Sets the kernel's dynamic shared-memory limit (above 48 KB it must be asked
// for), launches it with NT threads a block (THREADS unless given) on `stream`, and
// returns the launch's error: a refused launch never runs and a synchronize would
// not say so.
template <int NT = THREADS, typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, size_t smem, dim3 grid, cudaStream_t stream,
                          Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, NT, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Launches seg_tile_range_kernel (flash_attention.cu): out[b * n_tiles + j] =
// [min, max] of the segment ids of rows j*tile .. j*tile + tile - 1 of batch row b.
cudaError_t launch_seg_tile_range(const int* seg, int t_len, int n_tiles, int tile, int batch,
                                  int2* out, cudaStream_t stream);

}  // namespace vrt_fa
