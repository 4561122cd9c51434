// Unpack, gain and history extend of the resampler's stereo 16-bit input,
// for sm_90a.
//
//   out[b, c, t] = hist[b, c, t]                                  t < H
//                = s16(data[b, 4 (t - H) + 2 c]) * factor         H <= t < H + frames
//                = 0                                              H + frames <= t < L
//
// One pass from a chunk's interleaved little-endian s16 frames (uint8 rows
// at any pitch and byte offset, read in place) to the f32 slab [B, 2, L]
// that the contraction reads: the carried history in front, the chunk's
// samples times the gain factor, zeros to L. It takes the place of
// ops/quantization.py::unpack_pcm16_planar2 (a contiguous copy, the
// transpose to planar, the widening to int32), int_to_float (the f32 cast and
// the multiply) and the history cat and zero pad of the resampler's chunk
// bodies: six to eight passes of eager PyTorch over the same samples.
//
// Numerics are int_to_float's: an int16 converts to f32 exactly, and the
// product with the f32 factor is rounded once (__fmul_rn, never contracted).
// The history and the zeros are copied bit for bit.
//
// What bounds it: bytes. Each input byte is read once (4 a frame) and each
// slab word written once (8 bytes a frame, plus the history's and the
// tail's): at the upsampling cell's chunk (2048 streams, 8192 frames, H = 72,
// L = 8264) that is 203 MB, 0.0605 ms at 3.35 TB/s.
//
// The design: the slab's rows are cut into groups of 4 frames that lie on
// 16-byte boundaries of channel 0's row; a thread takes a group of both
// channels, so its 4 frames are 16 contiguous input bytes and two 16-byte
// stores. The input bytes of a group sit at the same offset modulo 16 in
// every group of a row, so each row reads with the widest loads its
// alignment allows (16, 8, 4, 2 or 1 byte), the same for all its groups.
// Groups that straddle the history, the samples, the tail or a row's ends
// take each frame apart. Each block takes a share of one stream's groups,
// the blocks in the slab's memory order (stream-major, as an elementwise
// pass writes it, so the slab's end is what L2 holds for the next kernel);
// each thread has UNROLL groups in flight, loaded before any is stored.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;
constexpr int GROUP = 4;   // frames a thread takes at once

// 16 input bytes at p as four little-endian 32-bit words, in loads as wide as
// p's alignment allows
__device__ __forceinline__ void load16(const uint8_t* p, uint32_t (&w)[4]) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (a % 16 == 0) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  } else if (a % 8 == 0) {
    const uint2 lo = __ldg(reinterpret_cast<const uint2*>(p));
    const uint2 hi = __ldg(reinterpret_cast<const uint2*>(p + 8));
    w[0] = lo.x, w[1] = lo.y, w[2] = hi.x, w[3] = hi.y;
  } else if (a % 4 == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) w[j] = __ldg(reinterpret_cast<const uint32_t*>(p + 4 * j));
  } else if (a % 2 == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t lo = __ldg(reinterpret_cast<const uint16_t*>(p + 4 * j));
      const uint32_t hi = __ldg(reinterpret_cast<const uint16_t*>(p + 4 * j + 2));
      w[j] = lo | hi << 16;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[j] = static_cast<uint32_t>(__ldg(p + 4 * j)) |
             static_cast<uint32_t>(__ldg(p + 4 * j + 1)) << 8 |
             static_cast<uint32_t>(__ldg(p + 4 * j + 2)) << 16 |
             static_cast<uint32_t>(__ldg(p + 4 * j + 3)) << 24;
    }
  }
}

// the low (channel 0) or high (channel 1) s16 of a frame's word, times factor
__device__ __forceinline__ float sample(uint32_t bits16, float factor) {
  const int16_t s = static_cast<int16_t>(static_cast<uint16_t>(bits16 & 0xffffu));
  return __fmul_rn(static_cast<float>(s), factor);
}

__global__ void __launch_bounds__(THREADS)
unpack16_extend_kernel(const uint8_t* __restrict__ data, long long data_pitch, int frames,
                       float factor, const float* __restrict__ hist, long long hist_stream,
                       long long hist_channel, long long hist_step, int H,
                       float* __restrict__ out, int L, int tiles, int per_block) {
  const int b = static_cast<int>(blockIdx.x / tiles);
  // (no offsets from the operands a chunk does not read: they may be null)
  const uint8_t* row_in = frames > 0 ? data + b * data_pitch : data;
  const float* h0 = H > 0 ? hist + b * hist_stream : hist;
  const float* h1 = H > 0 ? h0 + hist_channel : hist;
  float* o0 = out + 2LL * b * L;
  float* o1 = o0 + L;
  // channel 0's frames before its first 16-byte boundary: group g holds
  // frames 4 g - s .. 4 g - s + 3
  const int s = static_cast<int>(reinterpret_cast<uintptr_t>(o0) / 4 % GROUP);
  const bool aligned1 = L % GROUP == 0;   // then channel 1's groups lie on 16 bytes too
  const int groups = (L + s + GROUP - 1) / GROUP;
  const int g_begin = static_cast<int>(blockIdx.x % tiles) * per_block;
  const int g_end = min(g_begin + per_block, groups);
  const int tail = H + frames;

  float v0[UNROLL][GROUP], v1[UNROLL][GROUP];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int g = g_begin + u * THREADS + static_cast<int>(threadIdx.x);
    const int t0 = GROUP * g - s;
    if (g >= g_end) continue;
    if (t0 >= H && t0 + GROUP <= tail) {   // four frames of samples
      uint32_t w[4];
      load16(row_in + 4LL * (t0 - H), w);
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        v0[u][j] = sample(w[j], factor);
        v1[u][j] = sample(w[j] >> 16, factor);
      }
    } else {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const int t = t0 + j;
        if (t < 0 || t >= L) {
          v0[u][j] = v1[u][j] = 0.0f;
        } else if (t < H) {
          v0[u][j] = __ldg(h0 + t * hist_step);
          v1[u][j] = __ldg(h1 + t * hist_step);
        } else if (t < tail) {
          const uint8_t* p = row_in + 4LL * (t - H);
          const uint32_t word = static_cast<uint32_t>(__ldg(p)) |
                                static_cast<uint32_t>(__ldg(p + 1)) << 8 |
                                static_cast<uint32_t>(__ldg(p + 2)) << 16 |
                                static_cast<uint32_t>(__ldg(p + 3)) << 24;
          v0[u][j] = sample(word, factor);
          v1[u][j] = sample(word >> 16, factor);
        } else {
          v0[u][j] = v1[u][j] = 0.0f;
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int g = g_begin + u * THREADS + static_cast<int>(threadIdx.x);
    const int t0 = GROUP * g - s;
    if (g >= g_end) continue;
    if (t0 >= 0 && t0 + GROUP <= L) {
      *reinterpret_cast<float4*>(o0 + t0) = make_float4(v0[u][0], v0[u][1], v0[u][2], v0[u][3]);
      if (aligned1) {
        *reinterpret_cast<float4*>(o1 + t0) =
            make_float4(v1[u][0], v1[u][1], v1[u][2], v1[u][3]);
      } else {
#pragma unroll
        for (int j = 0; j < GROUP; ++j) o1[t0 + j] = v1[u][j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const int t = t0 + j;
        if (t >= 0 && t < L) {
          o0[t] = v0[u][j];
          o1[t] = v1[u][j];
        }
      }
    }
  }
}

}  // namespace

// data uint8: stream b's frames start at data + b * data_pitch (bytes, any
// alignment), 4 bytes a frame (channel 0's s16, then channel 1's), frames of
// them; hist f32: stream b's channel c's H frames at hist + b * hist_stream +
// c * hist_channel, hist_step apart (in floats; unread when H = 0); out f32
// [B, 2, L] contiguous, 4-byte aligned, L >= H + frames. Launches on `stream`
// and returns cudaGetLastError(); refuses (cudaErrorInvalidValue, writing
// nothing) negative sizes, L < H + frames and a missing history.
extern "C" int eal_unpack16_extend(const void* data, long long data_pitch, int frames,
                                   float factor, const void* hist, long long hist_stream,
                                   long long hist_channel, long long hist_step, int H, void* out,
                                   int L, int B, void* stream) {
  if (B < 0 || frames < 0 || H < 0 || L < 0 || static_cast<long long>(H) + frames > L ||
      (H > 0 && hist == nullptr) || reinterpret_cast<uintptr_t>(out) % 4 != 0 ||
      L > 0x7fffffff - 2 * GROUP)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || L == 0) return static_cast<int>(cudaSuccess);
  const int groups = (L + 2 * GROUP - 2) / GROUP;   // the most any row's shift needs
  const int per_tile = THREADS * UNROLL;
  const int tiles = (groups + per_tile - 1) / per_tile;
  if (static_cast<long long>(B) * tiles > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_block = (groups + tiles - 1) / tiles;
  const unsigned blocks = static_cast<unsigned>(B) * static_cast<unsigned>(tiles);
  unpack16_extend_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), data_pitch, frames, factor,
      static_cast<const float*>(hist), hist_stream, hist_channel, hist_step, H,
      static_cast<float*>(out), L, tiles, per_block);
  return static_cast<int>(cudaGetLastError());
}
