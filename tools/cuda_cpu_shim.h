// A CPU stand-in for the parts of CUDA that the integer kernels of
// esp_audio_libs_tpu_torch/csrc use, so that such a kernel compiles with g++
// (-std=c++20, with -fsanitize=undefined to catch signed overflow and bad
// shifts) and runs on the CPU against its plain version.
//
// Include it in place of <cuda_runtime.h> and turn each launch
// `kernel<<<grid, block, smem, stream>>>(args)` into
// `eal_shim_launch(kernel, grid, block, args)`
// (tests/test_torch_mp3_kernel_cpu.py does both). The launch runs the blocks
// one after another, each with one std::thread per CUDA thread:
//   - __global__, __device__, __constant__, __forceinline__ and
//     __launch_bounds__ are nothing; __shared__ is `static`: one copy, used
//     by one block at a time;
//   - threadIdx and blockIdx are thread_local, blockDim and gridDim global;
//   - __syncthreads is a std::barrier of the block's threads;
//   - __syncwarp and the warp intrinsics (__shfl_sync, __shfl_xor_sync,
//     __reduce_or_sync, __reduce_max_sync) meet at a std::barrier of the
//     warp's threads and trade values through a per-warp slot array, so all
//     the warp's threads must call them together, as a full mask demands on
//     the card;
//   - atomicOr, atomicMax, __clz, __mulhi, int min and max, int4,
//     make_int4 and float4 are builtins with CUDA's results;
//   - mul_ftz and add_ftz stand in for the inline-PTX mul/add.rn.ftz.f32
//     helpers of csrc/exact_async.cuh: one IEEE f32
//     op (compile with -ffp-contract=off) with subnormal operands and
//     results flushed to a zero of their own sign. A test that builds such
//     a kernel puts an exact_async.cuh beside it that includes this file.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __constant__
#define __restrict__ __restrict

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 blockDim, gridDim;

struct int4 {
  int x, y, z, w;
};
inline int4 make_int4(int x, int y, int z, int w) { return int4{x, y, z, w}; }
struct alignas(16) float4 {
  float x, y, z, w;
};

inline float eal_shim_flush(float x) {
  return std::fabs(x) < 0x1p-126f ? std::copysign(0.0f, x) : x;
}
inline float mul_ftz(float a, float b) {
  return eal_shim_flush(eal_shim_flush(a) * eal_shim_flush(b));
}
inline float add_ftz(float a, float b) {
  return eal_shim_flush(eal_shim_flush(a) + eal_shim_flush(b));
}

using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }

inline int __clz(int x) { return x == 0 ? 32 : __builtin_clz(static_cast<unsigned>(x)); }
inline int __mulhi(int a, int b) {
  return static_cast<int>((static_cast<long long>(a) * b) >> 32);
}

template <class T>
inline T atomicOr(T* p, T v) { return std::atomic_ref<T>(*p).fetch_or(v); }
template <class T>
inline T atomicMax(T* p, T v) {
  std::atomic_ref<T> a(*p);
  T old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {
  }
  return old;
}

namespace eal_shim {

struct Warp {
  std::unique_ptr<std::barrier<>> bar;
  unsigned long long slot[32];
};
struct Block {
  std::unique_ptr<std::barrier<>> bar;
  std::vector<Warp> warps;
};
inline Block* block = nullptr;

inline Warp& warp() { return block->warps[threadIdx.x / 32]; }
inline int lane() { return static_cast<int>(threadIdx.x % 32); }

// every thread of the warp posts v, then reads the slot of lane src(lane)
template <class T, class Src>
inline T exchange(T v, Src src) {
  static_assert(sizeof(T) <= 8, "a warp exchange moves at most 8 bytes");
  Warp& w = warp();
  std::memcpy(&w.slot[lane()], &v, sizeof(T));
  w.bar->arrive_and_wait();
  T r;
  std::memcpy(&r, &w.slot[src(lane())], sizeof(T));
  w.bar->arrive_and_wait();
  return r;
}

// every thread of the warp posts v and gets f over all the warp's values
template <class T, class F>
inline T reduce(T v, F f) {
  Warp& w = warp();
  std::memcpy(&w.slot[lane()], &v, sizeof(T));
  w.bar->arrive_and_wait();
  const int n = static_cast<int>(std::min(32u, blockDim.x - threadIdx.x / 32 * 32));
  T r;
  std::memcpy(&r, &w.slot[0], sizeof(T));
  for (int k = 1; k < n; ++k) {
    T x;
    std::memcpy(&x, &w.slot[k], sizeof(T));
    r = f(r, x);
  }
  w.bar->arrive_and_wait();
  return r;
}

}  // namespace eal_shim

inline void __syncthreads() { eal_shim::block->bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { eal_shim::warp().bar->arrive_and_wait(); }

template <class T>
inline T __shfl_sync(unsigned, T v, int src, int width = 32) {
  return eal_shim::exchange(v, [&](int l) { return (l & ~(width - 1)) + (src & (width - 1)); });
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask, int width = 32) {
  return eal_shim::exchange(v, [&](int l) {
    const int s = l ^ mask;
    return (s & ~(width - 1)) == (l & ~(width - 1)) ? s : l;
  });
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return eal_shim::reduce(v, [](unsigned a, unsigned b) { return a | b; });
}
inline int __reduce_max_sync(unsigned, int v) {
  return eal_shim::reduce(v, [](int a, int b) { return a > b ? a : b; });
}

// kernel<<<grid, block>>>(args...): the blocks in turn, each on block.x threads
template <class... P, class... A>
inline void eal_shim_launch(void (*kernel)(P...), dim3 grid, dim3 block, A... args) {
  gridDim = grid;
  blockDim = block;
  const unsigned n = block.x;
  for (unsigned b = 0; b < grid.x; ++b) {
    eal_shim::Block blk;
    blk.bar = std::make_unique<std::barrier<>>(n);
    for (unsigned w = 0; w * 32 < n; ++w) {
      blk.warps.emplace_back();
      blk.warps.back().bar = std::make_unique<std::barrier<>>(std::min(32u, n - 32 * w));
    }
    eal_shim::block = &blk;
    std::vector<std::thread> threads;
    threads.reserve(n);
    for (unsigned t = 0; t < n; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx = dim3(t);
        blockIdx = dim3(b);
        kernel(args...);
      });
    for (auto& th : threads) th.join();
    eal_shim::block = nullptr;
  }
}
