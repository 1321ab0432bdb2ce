// A CPU model of the CUDA launch, for running the kernels of csrc/ under g++
// (tools/emulate_kernels.py). It checks indexing, not speed:
// - a block's threads are std::threads; __syncthreads is a std::barrier over
//   the block; the blocks of a grid run one after another;
// - __shfl_xor_sync goes through a block-wide buffer between two barriers, so
//   every thread of the block must reach it, as in the kernels here;
// - dynamic shared memory is a fresh heap buffer of exactly the launch's size,
//   filled with NaN: a read of a word no thread wrote shows in the output, and
//   under -fsanitize=address a read past the end stops the run;
// - bf16 converts with round-to-nearest-even, fmaf is std::fma, as on the card.
// emulate_kernels.py rewrites each `k<<<grid, block, smem, stream>>>(args)` into
// emu_launch(dim3(grid), block, smem, k, args) and `extern __shared__ ... smem[]`
// into a pointer to the launch's buffer.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __align__(n)
#define __shared__
#define CUDART_INF_F (std::numeric_limits<float>::infinity())

using std::max;
using std::min;

struct float4 { float x, y, z, w; };
struct float2 { float x, y; };
struct int2 { int x, y; };
struct uint4 { unsigned x, y, z, w; };
struct uint2 { unsigned x, y; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline float2 make_float2(float a, float b) { return {a, b}; }
inline int2 make_int2(int a, int b) { return {a, b}; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
constexpr int EMU_MAX_SMEM = 232448;  // the H100's dynamic shared memory a block
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int bytes) {
  return bytes > EMU_MAX_SMEM ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }

inline thread_local dim3 threadIdx;
inline dim3 blockIdx, blockDim, gridDim;
inline std::barrier<>* emu_barrier = nullptr;
inline float* emu_smem = nullptr;
inline float emu_shfl[1024];

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x;
  emu_barrier->arrive_and_wait();
  emu_shfl[t] = v;
  emu_barrier->arrive_and_wait();
  return emu_shfl[(t & ~31) | ((t & 31) ^ lane_mask)];
}
inline float fmaf(float a, float b, float c) { return std::fma(a, b, c); }
inline float expf(float x) { return std::exp(x); }
inline float logf(float x) { return std::log(x); }
inline float fmaxf(float a, float b) { return std::fmax(a, b); }

struct __nv_bfloat16 { uint16_t v; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float emu_bf16_to_float(__nv_bfloat16 h) {
  const uint32_t u = uint32_t(h.v) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if (std::isnan(f)) return {uint16_t(0x7fc0)};
  u += 0x7fff + ((u >> 16) & 1);
  return {uint16_t(u >> 16)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 h) {
  return {emu_bf16_to_float(h.x), emu_bf16_to_float(h.y)};
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}

template <typename K, typename... Args>
void emu_launch(dim3 grid, int threads, size_t smem, K kernel, Args... args) {
  gridDim = grid;
  blockDim = dim3(threads);
  const size_t words = (smem + 3) / 4;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        std::vector<float> buf(words, std::numeric_limits<float>::quiet_NaN());
        emu_smem = buf.data();
        std::barrier<> bar(threads);
        emu_barrier = &bar;
        std::vector<std::thread> team;
        for (int t = 0; t < threads; ++t)
          team.emplace_back([=]() {
            threadIdx = dim3(t);
            kernel(args...);
          });
        for (auto& th : team) th.join();
      }
}
