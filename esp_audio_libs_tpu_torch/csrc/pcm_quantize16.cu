// Quantize and pack of the resampler's stereo 16-bit output, for sm_90a.
//
//   out[b, t] = (uint16)q(x[b, 0, t]) | (uint16)q(x[b, 1, t]) << 16    t < T
//   clips[b]  = #{(c, t) : c < 2, t < gen, q clipped x[b, c, t]}
//
// One pass over the f32 planar output of a chunk [B, 2, T] (any stream and
// channel pitch, samples contiguous): the interleaved little-endian s16
// frames go straight into the caller's uint8 rows, 4 bytes a frame at a
// given row pitch, and one int64 clip count per stream into `clips`. It
// takes the place of ops/quantization.py::float_to_int followed by
// pack_pcm16_interleave2 and the clip sum: about 17 elementwise passes of
// eager PyTorch over the same samples.
//
// Numerics are float_to_int(x, 16)'s, as in polyphase_fused16.cu's
// epilogue: the product x * 32768 and the + 0.5 are rounded separately
// (__fmul_rn, __fadd_rn: never contracted into an FMA), then floorf; the
// x86 cvttss2si cast is emulated explicitly (NaN or |y| >= 2^31 becomes
// INT_MIN, so it clips to NEGATIVE full scale, src/quantization_utils.cpp:61),
// since CUDA's own float-to-int conversion saturates and maps NaN to 0. A
// sample clips when that int32 lies outside [-32768, 32767], and is clamped.
//
// What bounds it: bytes. Each frame is read once (8 bytes) and written once
// (4 bytes): at the upsampling cell's chunk [2048, 2, 22587] that is 555 MB,
// 0.166 ms at 3.35 TB/s.
//
// The design: one block per stream, so each count is a block reduction (warp
// shuffles, then one shared word per warp) with no atomics and no memset.
// Threads stride over the stream's frames, UNROLL frames in flight each: the
// loads of both channels are 4-byte and coalesced (the rows are not 16-byte
// aligned: T is odd at the cells' shapes), and each frame is one 4-byte store.
// What a stream has in flight sets the pace at the up shape: blocks of 1024
// threads took 0.201 ms there (82 % of the bound), 512 threads 0.217 ms and
// 256 threads 0.245 ms; at [2048, 2, 2981] all three took 0.029-0.030 ms
// (74-76 %). Evict-first loads or streaming stores cost 10-20 % at the up
// shape (tools/kernel_variants.py --quantize16; H100 80GB HBM3, 700 W).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 1024;
constexpr int UNROLL = 4;

// float_to_int(a, 16) of one sample: its 16 bits, and whether it clipped
__device__ __forceinline__ uint32_t quantize16(float a, int& clipped) {
  const float y = floorf(__fadd_rn(__fmul_rn(a, 32768.0f), 0.5f));
  const float yc = (y >= -2147483648.0f && y < 2147483648.0f) ? y : -2147483648.0f;
  clipped = (yc > 32767.0f || yc < -32768.0f) ? 1 : 0;
  const int s = static_cast<int>(fminf(fmaxf(yc, -32768.0f), 32767.0f));
  return static_cast<uint32_t>(s) & 0xffffu;
}

__global__ void __launch_bounds__(THREADS)
quantize_pack16_kernel(const float* __restrict__ x, long long x_stream, long long x_channel,
                       uint32_t* __restrict__ out, long long out_pitch,
                       long long* __restrict__ clips, int T, int gen) {
  const int b = blockIdx.x;
  const float* left = x + b * x_stream;
  const float* right = left + x_channel;
  uint32_t* row = out + b * out_pitch;
  int n = 0;
  for (int t0 = threadIdx.x; t0 < T; t0 += THREADS * UNROLL) {
    float l[UNROLL], r[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u * THREADS;
      l[u] = t < T ? __ldg(left + t) : 0.0f;
      r[u] = t < T ? __ldg(right + t) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int t = t0 + u * THREADS;
      if (t < T) {
        int cl, cr;
        const uint32_t word = quantize16(l[u], cl) | quantize16(r[u], cr) << 16;
        row[t] = word;
        n += t < gen ? cl + cr : 0;
      }
    }
  }

  __shared__ int warp_counts[THREADS / 32];
  for (int m = 16; m > 0; m >>= 1) n += __shfl_xor_sync(0xffffffffu, n, m);
  if (threadIdx.x % 32 == 0) warp_counts[threadIdx.x / 32] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < THREADS / 32; ++w) total += warp_counts[w];
    clips[b] = total;
  }
}

}  // namespace

// x f32: stream b's channels start at x + b * x_stream and + x_channel
// (in floats), T samples each, contiguous; out: stream b's T 4-byte frames
// at out + b * out_pitch (in 4-byte words; out 4-byte aligned); clips int64
// [B]. Counts the clips of the first gen frames (gen >= T counts all).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int eal_quantize_pack16(const void* x, long long x_stream, long long x_channel,
                                   void* out, long long out_pitch, void* clips, int B, int T,
                                   int gen, void* stream) {
  if (B < 0 || T < 0 || gen < 0 || out_pitch < T ||
      reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaSuccess);
  quantize_pack16_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), x_stream, x_channel, static_cast<uint32_t*>(out), out_pitch,
      static_cast<long long*>(clips), T, gen);
  return static_cast<int>(cudaGetLastError());
}
