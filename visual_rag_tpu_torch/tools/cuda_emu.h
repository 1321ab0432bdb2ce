// A CPU model of the CUDA launch, for running the kernels of csrc/ under g++
// (tools/emulate_kernels.py). It checks indexing, not speed:
// - a block's threads are fibers (ucontext) that one OS thread runs in turn,
//   thread 0 first: __syncthreads is a switch to the next fiber, so a pass over
//   the block takes every thread from one barrier to the next (the kernels
//   here reach every barrier with every thread); the blocks of a grid run one
//   after another. A run is deterministic, and a barrier costs one pass of
//   context switches, not a wake-up of 256 OS threads;
// - __shfl_xor_sync goes through a block-wide buffer between two barriers, so
//   every thread of the block must reach it, as in the kernels here;
// - dynamic shared memory is a fresh heap buffer of exactly the launch's size,
//   filled with NaN: a read of a word no thread wrote shows in the output, and
//   under -fsanitize=address a read past the end stops the run;
// - bf16 converts with round-to-nearest-even, fmaf is std::fma, as on the card;
// - the tensor-core building blocks of csrc/mma_tiles.cuh (mma.sync m16n8k16 in
//   bf16 and in f16 with f32 accumulation, ldmatrix plain and .trans, cp.async,
//   also with a partial source): mma and
//   ldmatrix exchange fragments (or row addresses) through a block-wide buffer
//   after a barrier, as __shfl_xor_sync does, so every thread of the block must
//   reach them, as in the kernels; cp.async is a synchronous copy that honours
//   src-size (zeros past it), and commit_group / wait_group do nothing;
//   ex2.approx is std::exp2 (the card's rounds within about 2^-22); a streaming
//   store (__stcs) is a plain store.
// emulate_kernels.py rewrites each `k<<<grid, block, smem, stream>>>(args)` into
// emu_launch(dim3(grid), block, smem, k, args) and `extern __shared__ ... smem[]`
// into a pointer to the launch's buffer, and builds the kernels with this file
// in place of csrc/mma_tiles.cuh.
#pragma once
#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <memory>
#include <vector>
#if defined(__SANITIZE_ADDRESS__)
#include <sanitizer/common_interface_defs.h>
#endif

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
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 2,
  cudaDevAttrMultiProcessorCount = 3
};
constexpr int EMU_MAX_SMEM = 232448;  // the H100's dynamic shared memory a block
template <typename K>
cudaError_t cudaFuncSetAttribute(K, int, int bytes) {
  return bytes > EMU_MAX_SMEM ? cudaErrorInvalidValue : cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline int emu_sms = 132;  // the H100 SXM's SMs; fewer make small grids walk more work
inline cudaError_t cudaDeviceGetAttribute(int* value, int, int) {
  *value = emu_sms;
  return cudaSuccess;
}

inline dim3 threadIdx, blockIdx, blockDim, gridDim;  // threadIdx: the running fiber's
inline float* emu_smem = nullptr;
inline float emu_shfl[1024];

// The fibers of the running block, and the context of the launch that runs them.
struct EmuFiber {
  ucontext_t ctx;
  bool done;
};
inline EmuFiber emu_fibers[1024];
inline ucontext_t emu_launcher;
inline std::function<void()> emu_body;  // the kernel with its arguments
// the stack that a switch goes to, for AddressSanitizer's fiber annotations
inline const void* emu_launcher_stack = nullptr;
inline size_t emu_launcher_stack_size = 0;

inline void emu_start_switch(void** fake_stack, const void* bottom, size_t size) {
#if defined(__SANITIZE_ADDRESS__)
  __sanitizer_start_switch_fiber(fake_stack, bottom, size);
#else
  (void)fake_stack, (void)bottom, (void)size;
#endif
}

inline void emu_finish_switch(void* fake_stack, const void** bottom, size_t* size) {
#if defined(__SANITIZE_ADDRESS__)
  __sanitizer_finish_switch_fiber(fake_stack, bottom, size);
#else
  (void)fake_stack, (void)bottom, (void)size;
#endif
}

// A barrier: back to the launch, which runs the other threads up to theirs.
inline void __syncthreads() {
  void* fake = nullptr;
  emu_start_switch(&fake, emu_launcher_stack, emu_launcher_stack_size);
  swapcontext(&emu_fibers[threadIdx.x].ctx, &emu_launcher);
  emu_finish_switch(fake, &emu_launcher_stack, &emu_launcher_stack_size);
}

inline void emu_fiber_main() {
  emu_finish_switch(nullptr, &emu_launcher_stack, &emu_launcher_stack_size);
  emu_body();
  emu_fibers[threadIdx.x].done = true;
  emu_start_switch(nullptr, emu_launcher_stack, emu_launcher_stack_size);  // this fiber ends
}

inline float __shfl_xor_sync(unsigned, float v, int lane_mask) {
  const int t = threadIdx.x;
  __syncthreads();
  emu_shfl[t] = v;
  __syncthreads();
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

struct __half { uint16_t v; };
inline float emu_f16_to_float(uint16_t h) {
  const int e = (h >> 10) & 31, m = h & 1023;
  const float mag = e == 0    ? std::ldexp(float(m), -24)
                    : e == 31 ? (m ? std::numeric_limits<float>::quiet_NaN()
                                   : std::numeric_limits<float>::infinity())
                              : std::ldexp(float(m | 1024), e - 25);
  return h >> 15 ? -mag : mag;
}

inline void __stcs(float* p, float v) { *p = v; }
inline void __stcs(float2* p, float2 v) { *p = v; }

// The tensor-core building blocks (csrc/mma_tiles.cuh). A call publishes this
// thread's words in one of two slots, which alternate from call to call, and
// waits for the block; it then reads the words of its warp's lanes. One barrier
// suffices: a thread can rewrite a slot only after the next call's barrier,
// which every thread reaches after reading this call's.
inline uint64_t emu_xchg[2][1024][6];
inline unsigned emu_xchg_calls[1024];  // a thread's calls in this block

inline uint64_t (*emu_exchange(const uint64_t* words, int n))[6] {
  uint64_t(*slot)[6] = emu_xchg[emu_xchg_calls[threadIdx.x]++ & 1];
  std::memcpy(slot[threadIdx.x], words, sizeof(uint64_t) * n);
  __syncthreads();
  return slot;
}

inline float emu_bf16_half(uint64_t word, int high) {
  return emu_bf16_to_float({uint16_t(word >> (16 * high))});
}

inline float emu_f16_half(uint64_t word, int high) {
  return emu_f16_to_float(uint16_t(word >> (16 * high)));
}

// d += a b over the warp's fragments (layout in csrc/mma_tiles.cuh), the halves
// of each word decoded by HALF; each D element is summed exactly in double (the
// products of bf16 or f16 are exact) and rounded to f32 once.
template <float (*HALF)(uint64_t, int)>
inline void emu_mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const uint64_t words[6] = {a[0], a[1], a[2], a[3], b0, b1};
  uint64_t(*slot)[6] = emu_exchange(words, 6);
  const int warp = threadIdx.x & ~31, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * t + (i & 1);
    double acc = d[i];
    for (int k = 0; k < 16; ++k) {
      // A[row][k]: lane (row % 8, (k % 8) / 2), register row / 8 + 2 (k / 8), half k % 2
      const float x =
          HALF(slot[warp + (row & 7) * 4 + ((k & 7) >> 1)][(row >> 3) + 2 * (k >> 3)], k & 1);
      // B[k][col]: lane (col, (k % 8) / 2), register k / 8, half k % 2
      const float y = HALF(slot[warp + col * 4 + ((k & 7) >> 1)][4 + (k >> 3)], k & 1);
      acc += double(x) * double(y);
    }
    d[i] = float(acc);
  }
}
inline void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  emu_mma_16816<emu_bf16_half>(d, a, b0, b1);
}
inline void mma_f16_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  emu_mma_16816<emu_f16_half>(d, a, b0, b1);
}

// ldmatrix m8n8 of N matrices (b16), transposed if TRANS.
template <int N, bool TRANS>
inline void emu_ldsm(uint32_t* r, const void* p) {
  const uint64_t words[1] = {reinterpret_cast<uintptr_t>(p)};
  uint64_t(*slot)[6] = emu_exchange(words, 1);
  const int warp = threadIdx.x & ~31, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto at = [&](int i, int row, int col) {
    return uint32_t(reinterpret_cast<const uint16_t*>(slot[warp + 8 * i + row][0])[col]);
  };
  for (int i = 0; i < N; ++i)
    r[i] = TRANS ? at(i, 2 * t, g) | at(i, 2 * t + 1, g) << 16
                 : at(i, g, 2 * t) | at(i, g, 2 * t + 1) << 16;
}
inline void ldsm_x4(uint32_t (&r)[4], const void* p) { emu_ldsm<4, false>(r, p); }
inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) { emu_ldsm<4, true>(r, p); }
inline void ldsm_x2_trans(uint32_t (&r)[2], const void* p) { emu_ldsm<2, true>(r, p); }

inline void cp_async_16(void* dst, const void* src, bool full) {
  if (full) std::memcpy(dst, src, 16);
  else std::memset(dst, 0, 16);
}
inline void cp_async_4(void* dst, const void* src, bool full) {
  if (full) std::memcpy(dst, src, 4);
  else std::memset(dst, 0, 4);
}
inline void cp_async_4_partial(void* dst, const void* src, int bytes) {
  std::memset(dst, 0, 4);
  std::memcpy(dst, src, bytes);
}
inline float ex2_approx(float x) { return std::exp2(x); }  // the card's rounds within 2^-22
inline void cp_async_commit() {}
template <int N>
inline void cp_async_wait() {}

template <typename K, typename... Args>
void emu_launch(dim3 grid, int threads, size_t smem, K kernel, Args... args) {
  constexpr size_t STACK = 1 << 18;  // bytes of a fiber's stack
  gridDim = grid;
  blockDim = dim3(threads);
  emu_body = [=]() { kernel(args...); };
  std::unique_ptr<char[]> stacks(new char[STACK * threads]);
  const size_t words = (smem + 3) / 4;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        std::vector<float> buf(words, std::numeric_limits<float>::quiet_NaN());
        emu_smem = buf.data();
        for (int t = 0; t < threads; ++t) {
          EmuFiber& f = emu_fibers[t];
          getcontext(&f.ctx);
          f.ctx.uc_stack.ss_sp = stacks.get() + STACK * t;
          f.ctx.uc_stack.ss_size = STACK;
          f.ctx.uc_link = &emu_launcher;
          makecontext(&f.ctx, emu_fiber_main, 0);
          f.done = false;
          emu_xchg_calls[t] = 0;
        }
        for (int alive = threads; alive > 0;) {  // passes over the block, thread 0 first
          alive = 0;
          for (int t = 0; t < threads; ++t) {
            if (emu_fibers[t].done) continue;
            threadIdx = dim3(t);
            void* fake = nullptr;
            emu_start_switch(&fake, stacks.get() + STACK * t, STACK);
            swapcontext(&emu_launcher, &emu_fibers[t].ctx);
            emu_finish_switch(fake, nullptr, nullptr);
            alive += !emu_fibers[t].done;
          }
        }
      }
}
