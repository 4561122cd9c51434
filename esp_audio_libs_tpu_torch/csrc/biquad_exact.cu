// Exact sequential f32 recurrences for sm_90a: the DF-I biquad of the
// resampler's exact mode and the second-order recurrence of ops/scan.py,
// bit-exact against the JAX package.
//
// Replaces the lax.scan of biquad_apply(exact=True)
// (esp_audio_libs_tpu/ops/biquad.py:197-223) and iir2_sequential
// (esp_audio_libs_tpu/ops/scan.py:41-61). There they are XLA, not Pallas;
// eager PyTorch would launch a dozen ops per sample step.
//
// Numerics: every product, sum and difference is its own PTX instruction
// with an explicit rounding modifier (mul.rn / add.rn / sub.rn), which the
// compiler never contracts into an FMA, in the C reference's order:
//   DF-I, second order: y = ((((x*a0) + i1*a1) + i2*a2) - b1*o1) - b2*o2
//   DF-I, first order:  y = ((x*a0) + i1*a1) - b1*o1
//   iir2:               y = (f - p1*y1) - p2*y2
// The .ftz forms flush subnormal operands and results to a zero of their
// own sign: the JAX package's rule (XLA on the CPU runs with flush-to-zero
// and denormals-are-zero; ops/scan.py). The carry copies inputs and outputs
// with their bits unchanged. With valid_len, steps t >= valid_len leave the
// carry frozen and still emit an output computed from it.
//
// What bounds it: each lane (one row of [N, T], t contiguous) is a chain of
// T dependent steps; the loop-carried part of a step is b1*o1 and two
// subtractions (about 12 cycles), and the input side runs ahead. At the
// resampler's shapes there are only 512-4096 lanes (one warp per SM or
// fewer), so the kernel is bound by that chain's latency, not by bytes
// (8192 steps x 12 cycles is about 0.05 ms at 1.98 GHz against 0.08 ms of
// bytes for [4096, 8192] in and out). The design keeps the chain alone on
// its thread and the memory off it:
// - A block is one warp: 32 lanes, one thread each.
// - Time is cut into tiles of S = 64 steps. Tiles of x come in through a
//   ring of NST = 4 shared-memory stages by cp.async (coalesced along t),
//   three tiles ahead of the one being computed, so loads never wait on the
//   chain. Outputs go through a shared tile and leave coalesced along t.
// - The padded pitch (S + 1) makes both the per-lane column reads and the
//   row-wise copies conflict-free. A tile's inputs move to registers before
//   its steps run, so no load waits behind the chain's stores of outputs
//   (with loads from shared memory inside the chain a step took about 44 ns).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int LANES = 32;        // lanes per block: one warp
constexpr int S = 64;            // steps per tile
constexpr int NST = 4;           // cp.async ring stages
constexpr int PITCH = S + 1;

enum Mode { DF1_SECOND = 0, DF1_FIRST = 1, IIR2 = 2 };

__device__ __forceinline__ float mul_ftz(float a, float b) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float add_ftz(float a, float b) {
  float r;
  asm("add.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float sub_ftz(float a, float b) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// One step's output from the carry: (i1, i2) the last two inputs, (o1, o2)
// the last two outputs; cf = {a0, a1, a2, b1, b2}, or {-, -, -, p1, p2}.
template <int MODE>
__device__ __forceinline__ float step(float xv, const float (&cf)[5], float i1, float i2,
                                      float o1, float o2) {
  if (MODE == IIR2) return sub_ftz(sub_ftz(xv, mul_ftz(cf[3], o1)), mul_ftz(cf[4], o2));
  if (MODE == DF1_FIRST)
    return sub_ftz(add_ftz(mul_ftz(xv, cf[0]), mul_ftz(i1, cf[1])), mul_ftz(cf[3], o1));
  const float acc = add_ftz(add_ftz(mul_ftz(xv, cf[0]), mul_ftz(i1, cf[1])), mul_ftz(i2, cf[2]));
  return sub_ftz(sub_ftz(acc, mul_ftz(cf[3], o1)), mul_ftz(cf[4], o2));
}

struct RecArgs {
  const float* x;          // [n, T] input (f for iir2)
  float* y;                // [n, T]
  const float* coef;       // DF-I: [5] (stride 0) or [n, 5]; iir2: p1 [n], p2 [n]
  int coef_stride;
  const float* state_in;   // DF-I: [4, n] (i1, i2, o1, o2); iir2: [2, n] (y1, y2)
  float* state_out;
  long long n;
  int T;
  int valid_len;           // DF-I only, in [0, T]
};

// Issue the copies of tile k (steps k*S ...) of the block's 32 rows into
// stage buffer `dst`; out-of-range elements become 0.
__device__ __forceinline__ void load_tile(const RecArgs& a, long long lane0, int k,
                                          float (*dst)[PITCH]) {
  const int j = threadIdx.x;
  const int t0 = k * S;
#pragma unroll 4
  for (int r = 0; r < LANES; ++r) {
    const long long row = lane0 + r;
#pragma unroll
    for (int h = 0; h < S; h += LANES) {
      const int t = t0 + h + j;
      if (row < a.n && t < a.T)
        cp_async4(&dst[r][h + j], a.x + row * a.T + t);
      else
        dst[r][h + j] = 0.0f;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(LANES) recurrence_kernel(RecArgs a) {
  __shared__ float xs[NST][LANES][PITCH];
  __shared__ float ys[LANES][PITCH];
  const int j = threadIdx.x;
  const long long lane0 = static_cast<long long>(blockIdx.x) * LANES;
  const long long row = lane0 + j;
  const bool active = row < a.n;

  // coefficients and carry of this thread's lane
  float cf[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  float i1 = 0.f, i2 = 0.f, o1 = 0.f, o2 = 0.f;
  if (active) {
    if (MODE == IIR2) {
      cf[3] = a.coef[row];           // p1
      cf[4] = a.coef[a.n + row];     // p2
      o1 = a.state_in[row];          // y1
      o2 = a.state_in[a.n + row];    // y2
    } else {
      const float* c = a.coef + row * a.coef_stride;
#pragma unroll
      for (int q = 0; q < 5; ++q) cf[q] = c[q];
      i1 = a.state_in[row];
      i2 = a.state_in[a.n + row];
      o1 = a.state_in[2 * a.n + row];
      o2 = a.state_in[3 * a.n + row];
    }
  }
  const int vl = MODE == IIR2 ? a.T : a.valid_len;
  const int ntiles = (a.T + S - 1) / S;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < ntiles) load_tile(a, lane0, s, xs[s]);
    cp_async_commit();
  }

  for (int k = 0; k < ntiles; ++k) {
    if (k + NST - 1 < ntiles) load_tile(a, lane0, k + NST - 1, xs[(k + NST - 1) % NST]);
    cp_async_commit();
    cp_async_wait<NST - 1>();       // this thread's copies of tile k have landed
    __syncwarp();                   // ... and every lane's are visible
    const float(*xt)[PITCH] = xs[k % NST];
    const int t0 = k * S;
    // the tile's inputs into registers first: the chain's stores to ys then
    // never order a later step's load behind them
    float xr[S];
#pragma unroll
    for (int c = 0; c < S; ++c) xr[c] = xt[j][c];

    if (t0 + S <= vl) {
      // every step of the tile advances the carry
#pragma unroll
      for (int c = 0; c < S; ++c) {
        const float y = step<MODE>(xr[c], cf, i1, i2, o1, o2);
        ys[j][c] = y;
        i2 = i1; i1 = xr[c]; o2 = o1; o1 = y;
      }
    } else {
      // the tile reaches valid_len (or T): steps past it keep the carry
#pragma unroll
      for (int c = 0; c < S; ++c) {
        const float y = step<MODE>(xr[c], cf, i1, i2, o1, o2);
        ys[j][c] = y;
        if (t0 + c < vl) {
          i2 = i1; i1 = xr[c]; o2 = o1; o1 = y;
        }
      }
    }
    __syncwarp();
#pragma unroll 4
    for (int r = 0; r < LANES; ++r) {
      const long long orow = lane0 + r;
      if (orow >= a.n) break;
#pragma unroll
      for (int h = 0; h < S; h += LANES) {
        const int t = t0 + h + j;
        if (t < a.T) a.y[orow * a.T + t] = ys[r][h + j];
      }
    }
    __syncwarp();                   // stage k % NST and ys are free again
  }
  cp_async_wait<0>();

  if (active) {
    if (MODE == IIR2) {
      a.state_out[row] = o1;
      a.state_out[a.n + row] = o2;
    } else {
      a.state_out[row] = i1;
      a.state_out[a.n + row] = i2;
      a.state_out[2 * a.n + row] = o1;
      a.state_out[3 * a.n + row] = o2;
    }
  }
}

template <int MODE>
cudaError_t launch(const RecArgs& a, cudaStream_t stream) {
  const long long blocks = (a.n + LANES - 1) / LANES;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  recurrence_kernel<MODE><<<static_cast<unsigned>(blocks), LANES, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x, y f32 [n, T]; coef f32 [5] (coef_stride 0) or [n, 5] (coef_stride 5),
// {a0, a1, a2, b1, b2}; state_in, state_out f32 [4, n] (in_d1, in_d2,
// out_d1, out_d2). valid_len in [0, T]. Launches on `stream` and returns
// cudaGetLastError() (cudaErrorInvalidValue for arguments it does not take).
extern "C" int eal_biquad_df1(const void* x, void* y, const void* coef, int coef_stride,
                              const void* state_in, void* state_out, long long n, int T,
                              int valid_len, int first_order, void* stream) {
  if (n < 1 || T < 1 || valid_len < 0 || valid_len > T || (coef_stride != 0 && coef_stride != 5))
    return static_cast<int>(cudaErrorInvalidValue);
  RecArgs a{static_cast<const float*>(x), static_cast<float*>(y),
            static_cast<const float*>(coef), coef_stride,
            static_cast<const float*>(state_in), static_cast<float*>(state_out), n, T,
            valid_len};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(first_order ? launch<DF1_FIRST>(a, s) : launch<DF1_SECOND>(a, s));
}

// f, y f32 [n, T]; p f32 [2, n] (p1, p2); state_in, state_out f32 [2, n]
// (y[-1], y[-2] in; y[T-1], y[T-2] out). Launches on `stream` and returns
// cudaGetLastError().
extern "C" int eal_iir2_sequential(const void* f, void* y, const void* p, const void* state_in,
                                   void* state_out, long long n, int T, void* stream) {
  if (n < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  RecArgs a{static_cast<const float*>(f), static_cast<float*>(y), static_cast<const float*>(p),
            0, static_cast<const float*>(state_in), static_cast<float*>(state_out), n, T, T};
  return static_cast<int>(launch<IIR2>(a, static_cast<cudaStream_t>(stream)));
}
