// A CPU stand-in for the parts of CUDA that the integer kernels of
// esp_audio_libs_tpu_torch/csrc use, so that such a kernel compiles with g++
// (-std=c++20, with -fsanitize=undefined to catch signed overflow and bad
// shifts) and runs on the CPU against its plain version.
//
// Include it in place of <cuda_runtime.h> and turn each launch
// `kernel<<<grid, block, smem, stream>>>(args)` into
// `eal_shim_launch(kernel, grid, block, args)`
// (tests/test_torch_mp3_kernel_cpu.py does both). The launch runs the blocks
// one after another (x fastest, then y), each with one std::thread per CUDA
// thread:
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
//   - atomicOr, atomicMax, __clz, __mulhi, int min and max, long long min,
//     int4, make_int4, uint2, make_uint2, uint4, make_uint4, float4,
//     make_float4, __fmul_rn and __fadd_rn are builtins with CUDA's results
//     (compile with -ffp-contract=off); __ldg and
//     __ldcs are plain loads, __stcs a plain store;
//   - mul_ftz and add_ftz stand in for the inline-PTX mul/add.rn.ftz.f32
//     helpers of csrc/exact_async.cuh: one IEEE f32
//     op (compile with -ffp-contract=off) with subnormal operands and
//     results flushed to a zero of their own sign. A test that builds such
//     a kernel puts an exact_async.cuh beside it that includes this file;
//   - the copy and hand-off helpers of exact_async.cuh that
//     csrc/dotprod_exact.cu uses: an mbarrier (mbar_init, mbar_arrive,
//     mbar_arrive_expect_tx, mbar_wait) is a phase bit, a pending arrival
//     count and a transaction byte count, kept beside the kernel's uint64_t
//     under one mutex; a phase completes when both counts reach 0, and
//     mbar_wait(parity) spins with std::this_thread::yield until the phase
//     of that parity has completed. More arrivals than a phase expects
//     abort, and so does a thread that waits on a barrier which completed
//     two phases since that thread's last wait on it (its parity would
//     alias on the card; every wait of a ring pipeline consumes one phase).
//     A CUtensorMap is the base, shape and pitch that tensor_map_2d stores;
//     tensor_load_2d copies its box element by element into the 128-byte
//     swizzled layout, zero past the map's columns and rows, then completes
//     the box's bytes; cp_async4 is a 4-byte copy (zero-filled when !valid)
//     and cp_async_arrive a plain arrival (the copies have landed already);
//     __grid_constant__, mbar_init_fence and
//     cp_async_wait_all are nothing. dynamic_smem() is one static 227 KB
//     buffer (smem_u32 gives its address's low bits), cudaFuncSetAttribute
//     succeeds, the occupancy query gives one block per SM and sm_count()
//     is 2, so a persistent grid has at most two blocks and each walks many
//     row groups.
#pragma once

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __constant__
#define __grid_constant__
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
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
struct alignas(8) uint2 {
  unsigned x, y;
};
inline uint2 make_uint2(unsigned x, unsigned y) { return uint2{x, y}; }
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
template <class T>
inline T __ldcs(const T* p) {
  return *p;
}
template <class T>
inline void __stcs(T* p, T v) {
  *p = v;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }

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
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K>
inline cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
template <class K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline int sm_count() { return 2; }

inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
inline long long min(long long a, long long b) { return a < b ? a : b; }

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

namespace eal_shim {

// An mbarrier: its phase bit, the arrivals its phase still expects, the
// count it was made with, and the transaction bytes still outstanding.
struct Mbar {
  uint32_t count = 0, pending = 0, phase = 0;
  long long tx = 0;
  unsigned long long completed = 0;   // phases completed since init
};
inline std::mutex mbar_mutex;
inline std::unordered_map<const void*, Mbar> mbars;

// f(mbar) under the lock; then the phase completes if nothing is pending.
template <class F>
inline void mbar_update(uint64_t* bar, F f) {
  std::lock_guard<std::mutex> lock(mbar_mutex);
  Mbar& m = mbars.at(bar);
  f(m);
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1;
    m.pending = m.count;
    ++m.completed;
  }
}
inline void mbar_fault(const char* what) {
  std::fprintf(stderr, "cuda_cpu_shim: %s\n", what);
  std::abort();
}
inline void mbar_arrival(Mbar& m) {
  if (m.pending == 0) mbar_fault("more mbarrier arrivals than the phase expects");
  --m.pending;
}

}  // namespace eal_shim

inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::lock_guard<std::mutex> lock(eal_shim::mbar_mutex);
  eal_shim::mbars[bar] = eal_shim::Mbar{count, count, 0, 0};
}
inline void mbar_init_fence() {}
inline void mbar_arrive(uint64_t* bar) { eal_shim::mbar_update(bar, eal_shim::mbar_arrival); }
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  eal_shim::mbar_update(bar, [&](eal_shim::Mbar& m) {
    m.tx += bytes;
    eal_shim::mbar_arrival(m);
  });
}
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  thread_local std::unordered_map<const void*, unsigned long long> seen;   // phases consumed
  for (;;) {
    {
      std::lock_guard<std::mutex> lock(eal_shim::mbar_mutex);
      const eal_shim::Mbar& m = eal_shim::mbars.at(bar);
      unsigned long long& done = seen[bar];
      if (m.completed > done + 1)
        eal_shim::mbar_fault("an mbarrier waiter fell two phases behind: its parity aliases");
      if (m.phase != parity) {
        done = m.completed;
        return;
      }
    }
    std::this_thread::yield();
  }
}
inline void cp_async4(const float* dst, const float* src, bool valid) {
  const float zero = 0.0f;
  std::memcpy(const_cast<float*>(dst), valid ? src : &zero, 4);
}
inline void cp_async_arrive(uint64_t* bar) { mbar_arrive(bar); }
inline void cp_async_wait_all() {}
// A 2-D tensor map: what tensor_load_2d needs to copy a box.
struct alignas(64) CUtensorMap {
  const float* base;
  long long cols, rows, pitch;
  int box_rows;
};
inline bool tensor_map_2d(CUtensorMap* map, const float* base, long long cols, long long rows,
                          long long pitch, int box_rows) {
  *map = CUtensorMap{base, cols, rows, pitch, box_rows};
  return true;
}
// The box of 32 columns x box_rows rows at (x, y), zero past the map's
// columns and rows, stored with the 128-byte swizzle (16-byte chunk c of
// box row r at chunk c ^ (r % 8)); then it completes the box's bytes.
inline void tensor_load_2d(const float* dst, const CUtensorMap* map, int x, int y,
                           uint64_t* bar) {
  float* box = const_cast<float*>(dst);
  for (int r = 0; r < map->box_rows; ++r)
    for (int c = 0; c < 32; ++c) {
      const bool in = y + r < map->rows && x + c < map->cols;
      const float v = in ? map->base[(y + r) * map->pitch + x + c] : 0.0f;
      std::memcpy(box + r * 32 + ((((c >> 2) ^ r) & 7) << 2) + (c & 3), &v, 4);
    }
  const long long bytes = 4LL * 32 * map->box_rows;
  eal_shim::mbar_update(bar, [&](eal_shim::Mbar& m) { m.tx -= bytes; });
}
inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p));
}
inline float* dynamic_smem() {
  alignas(1024) static float buf[232448 / 4];
  return buf;
}

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
  for (unsigned by = 0; by < grid.y; ++by)
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
        threads.emplace_back([&, t, b, by] {
          threadIdx = dim3(t);
          blockIdx = dim3(b, by);
          kernel(args...);
        });
      for (auto& th : threads) th.join();
      eal_shim::block = nullptr;
    }
}
